"""Tensor parallelism of the eval forward in the port (parallel/tp.py) on
the CPU, against the JAX package's forward on the same weights.

- The rule table on the port's names, as tests/test_tensor_parallel.py
  holds JAX's: qkv column-parallel (head-aligned: q, k and v each split),
  proj row-parallel, the rest replicated; and the MSDA, ConvFFN and MLP
  rules, with the neck's 1x1-conv `attn.proj` left out (JAX's rules take
  2-D kernels only).
- A module whose heads or hidden units do not divide by the model size
  stays replicated: deliver_tiny's 2 ViT heads at tp = 4, everything at
  tp = 3.
- A state dict sharded over the model ranks and gathered back is the
  original, bit for bit.
- One spawn of four gloo ranks (tests/_torch_ddp_worker.py's `tp` task):
  the deliver_tiny forward on a (data 2, model 2) mesh and on a (data 1,
  model 4) mesh, each rank's logits within rtol 1e-3 / atol 2e-4 of the
  JAX forward's rows of the batch (the parity tolerance of
  tests/test_torch_model.py; the partial sums add in another order), the
  split modules' head counts and the all-reduces a forward.
- The Mask2Former head (deliver_tiny_m2f) in the same spawn: the rules
  also split its pixel decoder's deformable attention (`attentions.<i>.`
  names), whose forward on the (data 2, model 2) mesh holds the JAX
  forward's logits at the same tolerance (the reference checkpoint of
  tests/test_torch_mask2former_model.py).
- Without a process group only the 1 x 1 mesh exists, and it changes
  nothing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sam_adapter_torch.configs.registry import get_config
from multimodal_sam_adapter_torch.engine.convert import state_dict_from_jax
from multimodal_sam_adapter_torch.models.segmentor import build_segmentor
from multimodal_sam_adapter_torch.parallel.tp import (COLUMN, ROW, Mesh,
                                                      Split,
                                                      gather_state_dict,
                                                      make_mesh,
                                                      shard_segmentor_,
                                                      shard_state_dict,
                                                      tp_plan, tp_spec)
from multimodal_sam_adapter_tpu.models.segmentor import (
    EncoderDecoder as JaxEncoderDecoder)
from tests import _torch_ddp_worker as w
from tests._torch_parity import randomize
from tests.test_torch_mask2former import MASK_MARGIN

CFG = w.tiny_model(dropout=False)
BACKBONE = CFG["backbone"]
IDX = BACKBONE["interaction_indexes"]
TOL = dict(rtol=1e-3, atol=2e-4)


@pytest.fixture(scope="module")
def jax_forward():
    jm = JaxEncoderDecoder(num_classes=CFG["num_classes"],
                           head_channels=CFG["head_channels"],
                           dropout_ratio=0.0, backbone_cfg=BACKBONE)
    S = BACKBONE["img_size"]
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, S, S, 6)), train=False))
    variables = randomize(shapes, 2)
    x = (np.random.default_rng(3).standard_normal((2, S, S, 6))
         * 0.5).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda v, xx: jm.apply(
            v, xx, train=False))(variables, jnp.asarray(x)))
    return state_dict_from_jax(variables, IDX), x, want


@pytest.fixture(scope="module")
def m2f_forward():
    """deliver_tiny_m2f's JAX forward on the reference checkpoint, and the
    port's state dict of the same weights."""
    from tests.test_torch_mask2former_model import jax_reference

    ref = jax_reference()
    idx = get_config("deliver_tiny_m2f")["model"]["backbone"][
        "interaction_indexes"]
    return state_dict_from_jax(ref["tree"], idx), ref


@pytest.fixture(scope="module")
def ranks(jax_forward, m2f_forward, tmp_path_factory):
    sd, x, _ = jax_forward
    d = tmp_path_factory.mktemp("tp")
    torch.save(sd, d / "sd.pt")
    torch.save(torch.from_numpy(x), d / "x.pt")
    torch.save(m2f_forward[0], d / "m2f_sd.pt")
    torch.save(torch.from_numpy(m2f_forward[1]["x"]), d / "m2f_x.pt")
    return w.spawn("tp", d, d / "sd.pt", d / "x.pt", "segmentor",
                   d / "m2f_sd.pt", d / "m2f_x.pt", world=4)


@pytest.fixture(scope="module")
def tiny():
    return build_segmentor(CFG, "cpu",
                           generator=torch.Generator().manual_seed(0))


def test_tp_rules():
    w2 = torch.empty(96, 32)
    b = torch.empty(96)
    blk = "backbone.blocks.0."
    assert tp_spec(blk + "attn.qkv.weight", w2) == Split(0, 3)
    assert tp_spec(blk + "attn.qkv.bias", b) == Split(0, 3)
    assert tp_spec(blk + "attn.proj.weight", w2) == ROW
    assert tp_spec(blk + "attn.proj.bias", b) is None
    assert tp_spec(blk + "mlp.lin1.weight", w2) == COLUMN
    assert tp_spec(blk + "mlp.lin2.weight", w2) == ROW
    assert tp_spec(blk + "attn.rel_pos_h", w2) is None
    ext = "backbone.interactions.0.extractor."
    for name in ("value_proj", "sampling_offsets", "attention_weights"):
        assert tp_spec(ext + f"attn.{name}.weight", w2) == COLUMN
    assert tp_spec(ext + "attn.output_proj.weight", w2) == ROW
    assert tp_spec(ext + "ffn.fc1.weight", w2) == COLUMN
    assert tp_spec(ext + "ffn.dwconv.dwconv.weight",
                   torch.empty(8, 1, 3, 3)) == COLUMN
    assert tp_spec(ext + "ffn.fc2.weight", w2) == ROW
    assert tp_spec("backbone.up.weight", w2) is None
    assert tp_spec("backbone.spm.smart_fusion.global_feature_encoder_rgb.0"
                   ".attn.proj.weight", torch.empty(40, 40, 1, 1)) is None


def test_modules_that_do_not_divide_stay_replicated(tiny):
    blk, inj = "backbone.blocks.0.attn.", "backbone.interactions.0.injector."
    two, four = tp_plan(tiny, 2), tp_plan(tiny, 4)
    assert blk + "qkv.weight" in two and blk + "proj.weight" in two
    # 2 ViT heads: split at tp 2, replicated at tp 4; MSDA's 4 heads, the
    # MLP's 128 and ConvFFN's 8 hidden units split at both
    assert not any(k.startswith(blk) for k in four)
    assert inj + "attn.value_proj.weight" in four
    assert "backbone.blocks.0.mlp.lin2.weight" in four
    assert set(four) < set(two)
    assert tp_plan(tiny, 3) == {} and tp_plan(tiny, 1) == {}


@pytest.mark.parametrize("tp", [2, 4])
def test_state_dict_shard_then_gather_is_the_original(tiny, tp):
    sd = tiny.state_dict()
    plan = tp_plan(tiny, tp)
    shards = [shard_state_dict(sd, plan, m, tp) for m in range(tp)]
    qkv = "backbone.interactions.0.injector.attn.value_proj.weight"
    assert shards[0][qkv].shape[0] == sd[qkv].shape[0] // tp
    back = gather_state_dict(shards, plan)
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)


def test_tp_forward_matches_jax(jax_forward, ranks):
    _, _, want = jax_forward
    for mesh in ((2, 2), (1, 4)):
        data = mesh[0]
        rows = want.shape[0] // data
        for r in ranks:
            got = r[mesh]
            d = got["data_rank"]
            np.testing.assert_allclose(got["logits"].numpy(),
                                       want[d * rows:(d + 1) * rows], **TOL,
                                       err_msg=str(mesh))


def test_tp_splits_heads_and_sums_partial_outputs(ranks):
    # (2, 2): every split module, 2 x 4 ViT blocks + 4 injectors + 2 x 6
    # extractors' row-parallel layers; (1, 4): the ViT attention stays whole
    want = {(2, 2): (dict(vit=1, injector=2, extractor=2), 24),
            (1, 4): (dict(vit=2, injector=1, extractor=1), 20)}
    for mesh, (heads, reduces) in want.items():
        assert sorted((r[mesh]["data_rank"], r[mesh]["model_rank"])
                      for r in ranks) == sorted(
            (d, m) for d in range(mesh[0]) for m in range(mesh[1]))
        for r in ranks:
            assert r[mesh]["heads"] == heads
            assert r[mesh]["all_reduces"] == reduces


def test_m2f_rules_split_the_pixel_decoder():
    cfg = get_config("deliver_tiny_m2f")["model"]
    model = build_segmentor(cfg, "cpu",
                            generator=torch.Generator().manual_seed(0))
    enc = "decode_head.pixel_decoder.encoder.layers.0.attentions.0."
    plan = tp_plan(model, 2)
    for name in ("value_proj", "sampling_offsets", "attention_weights"):
        assert plan[enc + f"{name}.weight"] == COLUMN
        assert plan[enc + f"{name}.bias"] == COLUMN
    assert plan[enc + "output_proj.weight"] == ROW
    assert enc + "output_proj.bias" not in plan
    # the masked-attention decoder and the FFNs stay replicated
    assert all(k.startswith("backbone.") or k.startswith(
        "decode_head.pixel_decoder.encoder.") for k in plan)


def test_tp_m2f_forward_matches_jax(m2f_forward, ranks):
    ref = m2f_forward[1]
    assert ref["margin"] >= MASK_MARGIN
    want = ref["want"]
    for r in ranks:
        got = r["m2f"]
        d = got["data_rank"]
        np.testing.assert_allclose(got["logits"].numpy(), want[d:d + 1],
                                   **TOL)
        # the pixel decoder's 8 heads split, one more row-parallel sum
        assert got["heads"] == 4
        assert got["all_reduces"] == 25


def test_what_is_not_ported_under_tp_raises(tiny):
    """A parameter that shard_segmentor_ split (its `tp_split` mark) makes
    the factored second moment and ZeRO refuse; an optimizer built
    before the sharding (on tensors the model no longer holds) makes the
    train step refuse."""
    from multimodal_sam_adapter_torch.engine.optim import make_optimizer
    from multimodal_sam_adapter_torch.engine.train import make_train_step
    from multimodal_sam_adapter_torch.parallel.zero import shard_optimizer

    model = build_segmentor(CFG, "cpu",
                            generator=torch.Generator().manual_seed(0))
    stale = make_optimizer(model)
    qkv = model.backbone.blocks[0].attn.qkv
    qkv.weight = torch.nn.Parameter(qkv.weight.detach()[:48].clone())
    qkv.weight.tp_split = Split(0, 3)
    with pytest.raises(ValueError, match="tensor parallelism"):
        make_optimizer(model, factored_second_moment=True)
    with pytest.raises(ValueError, match="tensor-parallel"):
        shard_optimizer(make_optimizer(model))
    with pytest.raises(ValueError, match="after shard_segmentor_"):
        make_train_step(model, stale)
    make_train_step(model, make_optimizer(model))


def test_tp_without_a_process_group(tiny):
    with pytest.raises(ValueError, match="there is none"):
        make_mesh(1, 2)
    with pytest.raises(RuntimeError, match="process group"):
        shard_segmentor_(tiny, Mesh(1, 2))
    sd = {k: v.clone() for k, v in tiny.state_dict().items()}
    shard_segmentor_(tiny, make_mesh(1, 1))
    assert all(torch.equal(v, sd[k]) for k, v in tiny.state_dict().items())
