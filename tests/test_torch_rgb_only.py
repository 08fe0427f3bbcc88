"""The RGB-only segmentor (one modality: ViT-Adapter's conv-stem spatial
prior in place of the twin ConvNeXt and the fusion neck) in the port
against the JAX package, float32 on the CPU, at the size of JAX's
tests/test_model_forward.py:test_single_modality_backbone (the tiny
backbone with modalities_ch (3,) and conv_inplane 16, a 64^2 input).

- `SpatialPriorModule` alone, in eval and in train mode (outputs and the
  BatchNorm running statistics it leaves), on a seeded N(0, 0.05) tree;
  its max pool against flax's on negative inputs at the border (both pad
  with -inf);
- the whole EncoderDecoder in eval mode: logits rtol 1e-3 / atol 2e-4, the
  bar of tests/test_torch_model.py;
- the train-mode loss (rtol 1e-4), every parameter's gradient (max |g_port
  - g_jax| <= 1e-3 x max |g_jax| + 1e-6) and every BatchNorm's running
  statistics (rtol 1e-5 / atol 1e-7), with_cp on, drop path and dropout
  at 0 (tests/test_torch_train_parity.py's tolerances); with_cp's
  recompute puts the statistics back once;
- the init (models/init.py) against JAX's own init: the constants equal,
  the draws of the rule's std;
- the weight bridge: every JAX leaf lands on one port key, the port loads
  it strictly, and the values come through unchanged;
- the same `--cfg-options` on both registries (dataset.modalities_ch=[3],
  dataset.mod_dir=[], dataset.mod_suffix=[],
  model.backbone.modalities_ch=[3]) give the same configs; the port's
  dataset, test and train pipelines and both entries run with them.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from multimodal_sam_adapter_torch.configs.registry import (
    apply_overrides, get_config)
from multimodal_sam_adapter_torch.data.datasets import build_dataset
from multimodal_sam_adapter_torch.data import pipelines as port_pipelines
from multimodal_sam_adapter_torch.engine import convert
from multimodal_sam_adapter_torch.engine.convert import state_dict_from_jax
from multimodal_sam_adapter_torch.models.adapter import SpatialPriorModule
from multimodal_sam_adapter_torch.models.init import init_table
from multimodal_sam_adapter_torch.models.segmentor import build_segmentor
from multimodal_sam_adapter_torch.nn.layers import set_dropout_key
from multimodal_sam_adapter_torch.parallel.tp import (gather_state_dict,
                                                      shard_state_dict,
                                                      tp_plan)
from multimodal_sam_adapter_torch.tools import test as test_entry
from multimodal_sam_adapter_torch.tools import train as train_entry
from multimodal_sam_adapter_tpu.configs import registry as jax_registry
from multimodal_sam_adapter_tpu.data import pipelines as jpipelines
from multimodal_sam_adapter_tpu.models.adapter import (
    SpatialPriorModule as JaxSpatialPriorModule)
from multimodal_sam_adapter_tpu.models.segmentor import (
    EncoderDecoder as JaxEncoderDecoder)
from tests._torch_parity import load, nchw, nhwc, randomize
from tests.test_model_forward import TINY_BACKBONE
from tests.test_torch_evaluator import fake_deliver  # noqa: F401

BACKBONE = dict(TINY_BACKBONE, modalities_ch=(3,), conv_inplane=16,
                drop_path_rate=0.0, conv_drop_path_rate=0.0, drop_rate=0.0)
CFG = dict(num_classes=4, head_channels=8, dropout_ratio=0.0,
           backbone=BACKBONE)
IDX = BACKBONE["interaction_indexes"]
B, S = 2, BACKBONE["img_size"]
TOL = dict(rtol=1e-3, atol=2e-4)
RGB_ONLY = {"dataset.modalities_ch": "[3]", "dataset.mod_dir": "[]",
            "dataset.mod_suffix": "[]", "model.backbone.modalities_ch": "[3]"}


def _jax_model():
    return JaxEncoderDecoder(num_classes=CFG["num_classes"],
                             head_channels=CFG["head_channels"],
                             dropout_ratio=0.0, backbone_cfg=BACKBONE)


@pytest.fixture(scope="module")
def variables():
    jm = _jax_model()
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)), train=False))
    return randomize(shapes, 4)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(5)
    img = (rng.standard_normal((B, S, S, 3)) * 0.5).astype(np.float32)
    gt = rng.integers(0, CFG["num_classes"], (B, S, S)).astype(np.int32)
    gt[rng.random((B, S, S)) < 0.1] = 255
    return img, gt


# ---------------------------------------------------------------- the prior

@pytest.fixture(scope="module")
def spm():
    jm = JaxSpatialPriorModule(embed_dim=32, inplanes=16)
    x = (np.random.default_rng(1).standard_normal((2, 64, 48, 3))
         ).astype(np.float32)
    v = randomize(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 48, 3)))), 2)
    pairs = [*convert.conv_stem(v["params"], v["batch_stats"], "m"),
             *(kv for i in range(1, 5)
               for kv in convert._conv2d(v["params"][f"fc{i}"], f"m.fc{i}"))]
    return jm, v, x, pairs


def _spm_outputs(outs):
    c1, *rest = outs
    return [nhwc(c1), *(t.detach().numpy() for t in rest)]


def test_spatial_prior_module_eval_matches_jax(spm):
    jm, v, x, pairs = spm
    with jax.default_matmul_precision("highest"):
        want = jm.apply(v, jnp.asarray(x), train=False)
    port = load(SpatialPriorModule(32, 16), pairs)
    assert sorted(port.state_dict()) == sorted(k[2:] for k, _ in pairs)
    with torch.no_grad():
        got = _spm_outputs(port(nchw(x)))
    assert [g.shape for g in got] == [(2, 16, 12, 32), (2, 48, 32),
                                      (2, 12, 32), (2, 4, 32)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


def test_spatial_prior_module_train_matches_jax(spm):
    jm, v, x, pairs = spm
    with jax.default_matmul_precision("highest"):
        want, upd = jm.apply(v, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    port = load(SpatialPriorModule(32, 16), pairs).train()
    got = _spm_outputs(port(nchw(x)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)
    stats = dict(convert.conv_stem(v["params"], jax.tree.map(
        np.asarray, upd["batch_stats"]), "m"))
    for name, buf in port.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), stats["m." + name],
                                       rtol=1e-5, atol=1e-7, err_msg=name)
        else:
            assert buf.item() == 1, name


def test_c1_comes_out_channels_last_whatever_the_input_strides(spm):
    """K6 takes c1 in NCHW or channels-last only: the prior hands it
    channels-last, also for a B = 1 input whose batch axis has numpy's
    stride 0 (`arr[None]`) and for an NCHW-contiguous one."""
    *_, pairs = spm
    port = load(SpatialPriorModule(32, 16), pairs)
    arr = np.random.default_rng(3).standard_normal((64, 48, 3)).astype(
        np.float32)
    inputs = [torch.from_numpy(arr[None]).permute(0, 3, 1, 2),
              nchw(arr[None]), nchw(arr[None]).contiguous()]
    assert inputs[0].stride()[0] == 0
    with torch.no_grad():
        outs = [port(x) for x in inputs]
    for c1, *_ in outs:
        assert c1.is_contiguous(memory_format=torch.channels_last)
        assert c1.stride() == (16 * 12 * 32, 1, 12 * 32, 32)
        torch.testing.assert_close(c1, outs[0][0], rtol=0, atol=0)


def test_max_pool_pads_as_flax_on_negative_inputs():
    """The stem's 3x3 stride-2 pool, padding 1, on inputs below zero at
    every border: torch and flax both pad with -inf, so no 0 enters."""
    x = -1.0 - np.random.default_rng(2).random((1, 9, 8, 4)).astype(
        np.float32)
    want = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                                   padding=((1, 1), (1, 1))))
    got = nhwc(SpatialPriorModule(8, 4).stem[-1](nchw(x)))
    assert (got < -1.0).all()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ the segmentor

def test_eval_logits_match_jax(variables, batch):
    img, _ = batch
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda v, x: _jax_model().apply(
            v, x, train=False))(variables, jnp.asarray(img)))
    model = build_segmentor(CFG, "cpu",
                            state_dict=state_dict_from_jax(variables, IDX))
    assert type(model.backbone.spm) is SpatialPriorModule
    with torch.no_grad():
        got = model(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == (B, S, S, CFG["num_classes"])
    np.testing.assert_allclose(got, want, **TOL)


@pytest.fixture(scope="module")
def trained(variables, batch):
    """JAX's loss, gradients and batch_stats; the port's loss on the same
    batch (with_cp on), its gradients and buffers."""
    img, gt = batch
    jm = _jax_model()

    def loss_fn(params, stats):
        (loss, _), upd = jm.apply(
            {"params": params, "batch_stats": stats}, jnp.asarray(img),
            jnp.asarray(gt), method=jm.loss, mutable=["batch_stats"])
        return loss, upd["batch_stats"]

    with jax.default_matmul_precision("highest"):
        (loss, stats), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(variables["params"],
                                    variables["batch_stats"])
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    want = state_dict_from_jax({"params": to_np(grads),
                                "batch_stats": to_np(stats)}, IDX)
    model = build_segmentor(CFG, "cpu", state_dict=state_dict_from_jax(
        variables, IDX)).train()
    set_dropout_key(model, 0)
    got_loss, logits = model.loss(torch.from_numpy(img), torch.from_numpy(gt))
    got_loss.backward()
    return dict(loss=(got_loss.item(), float(loss)), logits=logits,
                model=model, want=want)


def test_train_loss_matches_jax(trained):
    got, want = trained["loss"]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert trained["logits"].shape == (B, S, S, CFG["num_classes"])


def test_every_gradient_matches_jax(trained):
    model, want = trained["model"], trained["want"]
    names = [n for n, _ in model.named_parameters()]
    assert any(n.startswith("backbone.spm.stem.") for n in names)
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        w = want[name].numpy()
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= 1e-3 * np.abs(w).max() + 1e-6, (name, err,
                                                      np.abs(w).max())


def test_batchnorm_statistics_match_jax_and_move_once(trained, variables):
    """Each BatchNorm (the stem's six among them, which the with_cp
    recompute runs a second time) moved its statistics once, as flax's."""
    model, want = trained["model"], trained["want"]
    norms = [n for n, m in model.named_modules()
             if isinstance(m, torch.nn.BatchNorm2d)]
    assert sum(n.startswith("backbone.spm.") for n in norms) == 6
    for name in norms:
        for stat in ("running_mean", "running_var"):
            key = f"{name}.{stat}"
            np.testing.assert_allclose(model.get_buffer(key).numpy(),
                                       want[key].numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=key)
        assert model.get_buffer(f"{name}.num_batches_tracked").item() == 1


def test_checkpointed_prior_gives_the_uncheckpointed_gradients(variables,
                                                               batch):
    img, gt = batch
    sd = state_dict_from_jax(variables, IDX)
    runs = []
    for with_cp in (True, False):
        cfg = dict(CFG, backbone=dict(BACKBONE, with_cp=with_cp))
        model = build_segmentor(cfg, "cpu", state_dict=sd).train()
        set_dropout_key(model, 0)
        model.loss(torch.from_numpy(img), torch.from_numpy(gt))[0].backward()
        runs.append(model)
    for (name, p), q in zip(runs[0].named_parameters(),
                            runs[1].parameters()):
        torch.testing.assert_close(p.grad, q.grad, rtol=1e-5, atol=1e-7,
                                   msg=name)
    for (name, a), b in zip(runs[0].named_buffers(), runs[1].buffers()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


# ------------------------------------------------------- init and the bridge

def test_init_matches_the_jax_init():
    jm = _jax_model()
    ref = state_dict_from_jax(jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)), train=False)), IDX)
    model = build_segmentor(CFG, "cpu", generator=torch.Generator()
                            .manual_seed(0), init="jax")
    table = init_table(model, BACKBONE)
    assert table["backbone.spm.fc1.weight"].kind == "normal"
    assert table["backbone.spm.stem.0.weight"].kind == "trunc_normal"
    pooled = {}
    for n, p in model.named_parameters():
        got, want, rule = p.detach().numpy(), ref[n].numpy(), table[n]
        assert got.shape == want.shape, n
        if rule.kind in ("const", "msda_bias"):
            np.testing.assert_array_equal(got, want, err_msg=n)
            continue
        assert np.abs(got).max() <= rule.bound, n
        assert np.abs(want).max() <= rule.bound * (1 + 1e-6), n
        if n.startswith("backbone.spm."):
            got_want = pooled.setdefault(n.rsplit(".", 1)[0], [[], []])
            got_want[0].append(got.ravel() / rule.std)
            got_want[1].append(want.ravel() / rule.std)
    assert len(pooled) == 10      # six convs and four projections
    for key, (got, want) in pooled.items():
        got, want = np.concatenate(got), np.concatenate(want)
        tol = 0.1 if want.size >= 1024 else 0.25
        assert abs(want.std() - 1) < tol and abs(got.std() - 1) < tol, (
            key, want.size, want.std(), got.std())


def test_bridge_maps_every_jax_leaf_and_loads_strictly(variables):
    sd = state_dict_from_jax(variables, IDX)
    leaves = jax.tree_util.tree_leaves(variables)
    norms = [k for k in sd if k.endswith("num_batches_tracked")]
    assert len(sd) - len(norms) == len(leaves)
    spm = variables["params"]["backbone"]["spm"]
    stats = variables["batch_stats"]["backbone"]["spm"]
    np.testing.assert_array_equal(
        sd["backbone.spm.stem.3.weight"].numpy(),
        np.asarray(spm["stem2"]["conv"]["kernel"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["backbone.spm.conv4.1.running_var"].numpy(),
        np.asarray(stats["conv4"]["norm"]["bn"]["var"]))
    model = build_segmentor(CFG, "cpu", state_dict=sd)
    assert set(model.state_dict()) == set(sd)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    assert not any("twin_conv" in k or "smart_fusion" in k for k in sd)


def test_tensor_parallel_plan_covers_the_rgb_only_segmentor(variables):
    """parallel/tp.py splits the RGB-only segmentor's ViT blocks and
    MSDA / ConvFFN layers as the bimodal one's, keeps the conv stem whole,
    and its shards gather back to the state dict."""
    model = build_segmentor(CFG, "cpu",
                            state_dict=state_dict_from_jax(variables, IDX))
    plan = tp_plan(model, 2)
    assert "backbone.blocks.0.attn.qkv.weight" in plan
    assert "backbone.interactions.0.injector.attn.value_proj.weight" in plan
    assert not any(k.startswith("backbone.spm.") for k in plan)
    sd = model.state_dict()
    back = gather_state_dict([shard_state_dict(sd, plan, m, 2)
                              for m in range(2)], plan)
    assert all(torch.equal(back[k], sd[k]) for k in sd)


# ----------------------------------------------------- configs, data, entries

def test_overrides_give_the_same_config_in_both_registries():
    port = apply_overrides(get_config("deliver_tiny"), dict(RGB_ONLY))
    ref = jax_registry.apply_overrides(jax_registry.get_config(
        "deliver_tiny"), dict(RGB_ONLY))
    assert json.dumps(port, sort_keys=True) == json.dumps(ref, sort_keys=True)
    assert port["model"]["backbone"]["modalities_ch"] == [3]
    model = build_segmentor(port["model"], "cpu",
                            generator=torch.Generator().manual_seed(0))
    assert type(model.backbone.spm) is SpatialPriorModule


def test_dataset_and_pipelines_take_one_modality(fake_deliver):  # noqa: F811
    """The dataset pairs no auxiliary file (the JAX package's asks for one
    dir a modality and indexes the first); the test and train pipelines
    on the 3-channel sample equal the JAX package's."""
    cfg = apply_overrides(get_config("deliver_tiny"), dict(RGB_ONLY))
    ds = build_dataset(cfg["dataset"], fake_deliver, split="val")
    assert len(ds) == 4 and ds.mod_dir is None
    assert ds.infos[0]["mod"] == []
    sample = ds[0]
    assert sample["img"].shape == (80, 80, 3)
    np.testing.assert_array_equal(sample["img"], jpipelines.load_multimodal_image(
        ds.infos[0]["img"], [], ()))
    mods = cfg["dataset"]["modalities_ch"]
    got = port_pipelines.TestPipeline(cfg["test_pipeline"], mods)(dict(sample))
    want = jpipelines.TestPipeline(cfg["test_pipeline"], mods)(dict(sample))
    np.testing.assert_array_equal(got["img"], want["img"])
    for native in (True, False):
        got = port_pipelines.TrainPipeline(cfg["train_pipeline"], mods, native=native)(
            sample, np.random.default_rng(3))
        want = jpipelines.TrainPipeline(cfg["train_pipeline"], mods)(
            dict(sample), np.random.default_rng(3))
        assert got["img"].shape == (64, 64, 3)
        np.testing.assert_allclose(got["img"], want["img"], rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(got["gt"], want["gt"])


def test_entries_run_rgb_only(fake_deliver, tmp_path):  # noqa: F811
    """tools/test.py and tools/train.py (one epoch, a SAM-layout file
    ingested, no ConvNeXt file: the conv stem has none) with the
    overrides, on the CPU."""
    opts = ["--cfg-options", *(f"{k}={v}" for k, v in RGB_ONLY.items())]
    out = test_entry.main(["deliver_tiny", "random", "--data-root",
                           fake_deliver, "--device", "cpu", "--no-bf16",
                           "--out-dir", str(tmp_path)] + opts)
    with open(out) as f:
        payload = json.load(f)
    assert payload["provenance"]["n_samples"] == 4
    assert np.isfinite(payload["mIoU"])
    cfg = apply_overrides(get_config("deliver_tiny"), dict(RGB_ONLY))
    model = build_segmentor(cfg["model"], "cpu",
                            generator=torch.Generator().manual_seed(2))
    sam = {"image_encoder." + k[len("backbone."):]: v.clone()
           for k, v in model.state_dict().items()
           if k.startswith("backbone.blocks.") or k in (
               "backbone.pos_embed", "backbone.patch_embed.proj.weight",
               "backbone.patch_embed.proj.bias")}
    sam["image_encoder.neck.0.weight"] = torch.zeros(4, 32, 1, 1)
    sam_path = str(tmp_path / "sam.pth")
    torch.save({"model": sam}, sam_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)     # as tests/test_torch_train_entry.py trains
    try:
        runner = train_entry.main(
            ["deliver_tiny", "--data-root", fake_deliver, "--work-dir",
             str(tmp_path / "work"), "--device", "cpu", "--no-bf16",
             "--max-epochs", "1", "--sam-pretrained", sam_path] + opts
            + ["data.grad_accum=2"])
    finally:
        torch.set_num_threads(threads)
    assert type(runner.state.model.backbone.spm) is SpatialPriorModule
    assert runner.state.optimizer.updates == 1
    assert os.path.exists(tmp_path / "work" / "ckpts")
