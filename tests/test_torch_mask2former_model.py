"""The Mask2Former head in the whole segmentor: deliver_tiny_m2f's
EncoderDecoder (head_type 'mask2former') in the port against the JAX
package's, float32 on the CPU, and the port's Mask2Former training loss
in the segmentor.

The weights are one synthetic reference-layout checkpoint: the tiny
backbone of tests/test_convert_full.py:synth_state_dict and the head of
tests/test_torch_mask2former.py:synth_state_dict. The JAX model reads it
through convert_full_checkpoint and convert_mask2former_head; the port
loads it through the weight bridge (state_dict_from_jax), and loads the
reference keys themselves strictly.

Tolerance rtol 1e-3 / atol 2e-4, the bar of the full-model parity tests;
the cross-attention masks of the JAX forward clear the margin of
tests/test_torch_mask2former.py (asserted).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sam_adapter_torch.configs.registry import get_config
from multimodal_sam_adapter_torch.engine.convert import state_dict_from_jax
from multimodal_sam_adapter_torch.engine.inference import InferenceEngine
from multimodal_sam_adapter_torch.models.mask2former import Mask2FormerHead
from multimodal_sam_adapter_torch.models.segmentor import build_segmentor
from multimodal_sam_adapter_torch.nn.layers import set_dropout_key
from multimodal_sam_adapter_tpu.engine.convert_full import (
    convert_full_checkpoint)
from multimodal_sam_adapter_tpu.engine.convert_m2f import (
    convert_mask2former_head)
from multimodal_sam_adapter_tpu.models.segmentor import (
    EncoderDecoder as JaxEncoderDecoder)
from multimodal_sam_adapter_tpu.utils.interpolate import (
    resize_bilinear as jresize)
from tests.test_convert_full import synth_state_dict as synth_backbone
from tests.test_torch_mask2former import MASK_MARGIN
from tests.test_torch_mask2former import synth_state_dict as synth_head

TOL = dict(rtol=1e-3, atol=2e-4)
CFG = get_config("deliver_tiny_m2f")["model"]
HEAD = CFG["head"]
NCLS, FEAT, Q = CFG["num_classes"], CFG["head_channels"], HEAD["num_queries"]
EMBED = CFG["backbone"]["embed_dim"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread: under a parallel test run, faster than
    threads that contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_checkpoint():
    """{key: array} in the reference layout: the tiny backbone (BN
    variances made positive) and the deliver_tiny_m2f head."""
    sd = {k: v for k, v in synth_backbone().items()
          if not k.startswith("decode_head.")}
    for k in sd:
        if k.endswith("running_var"):
            sd[k] = np.abs(sd[k]) + 0.5
    head = synth_head(C=FEAT, Q=Q, K=NCLS, in_ch=EMBED,
                      n_dec=HEAD["num_decoder_layers"],
                      n_enc=HEAD["num_encoder_layers"], seed=3)
    sd.update({f"decode_head.{k}": v for k, v in head.items()})
    return sd, head


def _jax_model():
    return JaxEncoderDecoder(num_classes=NCLS, head_channels=FEAT,
                             backbone_cfg=CFG["backbone"],
                             head_type="mask2former", head_cfg=HEAD)


@pytest.fixture(scope="module")
def tiny():
    return jax_reference()


def jax_reference():
    """The reference checkpoint, its JAX tree, the input batch and the
    JAX forward's logits (and the cross-attention masks' margin)."""
    sd, head_sd = reference_checkpoint()
    # the backbone's tree (with the SegFormer head it was made with), its
    # head replaced by the Mask2Former head's
    tree = convert_full_checkpoint(
        {k: v for k, v in synth_backbone().items()
         if k.startswith("decode_head.")}
        | {k: v for k, v in sd.items() if not k.startswith("decode_head.")},
        CFG["backbone"]["interaction_indexes"])
    tree["params"]["decode_head"] = convert_mask2former_head(head_sd)
    tree["batch_stats"].pop("decode_head", None)
    variables = {"params": tree["params"],
                 "batch_stats": tree["batch_stats"]}
    x = (np.random.default_rng(0).standard_normal((2, 64, 64, 6))
         * 0.5).astype(np.float32)
    jm = _jax_model()

    def run(v, xx):
        return jm.apply(v, xx, train=False, capture_intermediates=True,
                        mutable=["intermediates"])

    with jax.default_matmul_precision("highest"):
        logits, inter = jax.jit(run)(variables, jnp.asarray(x))
    inter = inter["intermediates"]["decode_head"]
    preds = inter["decoder"]["__call__"][0]
    memories = inter["pixel_decoder"]["__call__"][0][1]
    margin = np.inf
    for i in range(HEAD["num_decoder_layers"]):
        hw = memories[i % 3].shape[1:3]
        m = np.asarray(jresize(preds[i][1].transpose(0, 2, 3, 1), hw))
        margin = min(margin, float(np.abs(m).min() / np.abs(m).max()))
    return dict(sd=sd, tree=tree, x=x, want=np.asarray(logits),
                margin=margin)


def test_tiny_m2f_forward_matches_jax(tiny):
    assert tiny["margin"] >= MASK_MARGIN, (
        f"a resized mask logit lies within {tiny['margin']:.2e} x max of "
        f"the threshold, < {MASK_MARGIN}")
    model = build_segmentor(CFG, "cpu", state_dict=state_dict_from_jax(
        tiny["tree"], CFG["backbone"]["interaction_indexes"]))
    assert isinstance(model.decode_head, Mask2FormerHead)
    with torch.no_grad():
        got = model(torch.from_numpy(tiny["x"])).numpy()
    assert got.shape == tiny["want"].shape == (2, 64, 64, NCLS)
    np.testing.assert_allclose(got, tiny["want"], **TOL)


def test_reference_checkpoint_loads_strictly_and_equals_the_bridge(tiny):
    sd = {k: torch.as_tensor(np.asarray(v)) for k, v in tiny["sd"].items()}
    bridged = state_dict_from_jax(tiny["tree"],
                                  CFG["backbone"]["interaction_indexes"])
    head = {k: v for k, v in bridged.items() if k.startswith("decode_head.")}
    assert set(head) == {k for k in sd if k.startswith("decode_head.")}
    for k, v in head.items():
        assert torch.equal(v, sd[k]), k
    model = build_segmentor(CFG, "cpu", state_dict=bridged)
    model.load_state_dict({**bridged, **head}, strict=True)


def test_bf16_eval_keeps_float32_scores(tiny):
    """The eval model in bf16 (as the entries run it): the head's scores
    stay float32 and the class maps agree with the float32 model's on
    most pixels."""
    sd = state_dict_from_jax(tiny["tree"],
                             CFG["backbone"]["interaction_indexes"])
    f32 = build_segmentor(CFG, "cpu", state_dict=sd)
    bf16 = build_segmentor(CFG, "cpu", state_dict=sd).to(torch.bfloat16)
    x = torch.from_numpy(tiny["x"])
    with torch.no_grad():
        want = f32(x)
        got = bf16(x.bfloat16())
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    assert agree > 0.9
    pred = InferenceEngine(bf16, get_config("deliver_tiny_m2f")[
        "test_cfg"]).predict(x[:1])
    assert pred.shape == (1, 64, 64)


@pytest.fixture(scope="module")
def train_model():
    torch.manual_seed(0)
    model = build_segmentor(CFG, "cpu", generator=torch.Generator()
                            .manual_seed(0), init="jax").train()
    rng = np.random.default_rng(1)
    img = torch.from_numpy(rng.standard_normal((2, 64, 64, 6)).astype(
        np.float32))
    gt = torch.from_numpy(rng.integers(0, NCLS, (2, 64, 64)))
    gt[:, :4] = 255
    return model, img, gt


def _loss(model, img, gt, key):
    set_dropout_key(model, key)
    model.zero_grad(set_to_none=True)
    loss, logits = model(img, gt)
    loss.backward()
    return loss.detach(), logits, {n: p.grad.clone()
                                   for n, p in model.named_parameters()}


def test_m2f_loss_is_keyed_by_the_step(train_model):
    """The same key draws the same points (the same loss, assignments and
    gradients); another key other points. Every parameter gets a
    gradient; the logits are the final scores at the labels' size,
    detached."""
    model, img, gt = train_model
    head = model.decode_head
    l1, logits, g1 = _loss(model, img, gt, 5)
    a1 = [a.clone() for a in head.record["assign"]]
    l2, _, g2 = _loss(model, img, gt, 5)
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(a1,
                                                 head.record["assign"]))
    assert all(torch.equal(g1[n], g2[n]) for n in g1)
    l3, _, _ = _loss(model, img, gt, 6)
    assert not torch.equal(l1, l3)
    assert len(a1) == 1 + HEAD["num_decoder_layers"]
    assert a1[0].shape == (2, Q)
    assert logits.shape == (2, 64, 64, NCLS) and not logits.requires_grad
    assert all(torch.isfinite(g).all() for g in g1.values())
    # the level encoding reaches the loss only through the MSDA offset and
    # attention-weight kernels, which start at zero (as in the JAX package)
    zero = [n for n, g in g1.items()
            if n.startswith("decode_head.") and not g.abs().sum() > 0]
    assert zero == ["decode_head.pixel_decoder.level_encoding.weight"]


def test_m2f_loss_takes_pinned_assignments_and_needs_a_key(train_model):
    model, img, gt = train_model
    head = model.decode_head
    _loss(model, img, gt, 5)
    seen = [a.clone() for a in head.record["assign"]]
    pinned = [torch.full_like(a, -1) for a in seen]
    head.pinned = {"assign": pinned}
    try:
        loss, _, _ = _loss(model, img, gt, 5)
    finally:
        head.pinned = None
    assert all(a is b for a, b in zip(head.record["assign"], pinned))
    # no query matched: the class terms alone, each of weight 0.1
    assert float(loss) < 2.0 * 3.5
    set_dropout_key(model, None)
    with pytest.raises(RuntimeError, match="set_dropout_key"):
        model(img, gt)
