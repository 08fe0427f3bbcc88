"""The whole slice: the port's EncoderDecoder against the JAX package's
EncoderDecoder.apply(train=False), float32 on the CPU, on one synthetic
reference-layout checkpoint (tests/test_convert_full.py:synth_state_dict)
that reaches the JAX model through convert_full_checkpoint and the port
through the weight bridge state_dict_from_jax.

Tolerance: rtol 1e-3 / atol 2e-4, the bar of the JAX package's full-model
parity test (tests/test_full_model_parity.py:158).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sam_adapter_torch.engine.convert import state_dict_from_jax
from multimodal_sam_adapter_torch.engine.inference import InferenceEngine
from multimodal_sam_adapter_torch.models.segmentor import (EncoderDecoder,
                                                            build_segmentor)
from multimodal_sam_adapter_tpu.engine.convert_full import (
    convert_full_checkpoint)
from multimodal_sam_adapter_tpu.models.segmentor import (
    EncoderDecoder as JaxEncoderDecoder)
from multimodal_sam_adapter_tpu.utils.interpolate import resize_bilinear
from tests.test_convert_full import HEAD_CH, IMG, NCLS, synth_state_dict
from tests.test_model_forward import TINY_BACKBONE

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-3, atol=2e-4)


def _checkpoint(**kw):
    sd = synth_state_dict(**kw)
    for k in sd:
        if k.endswith("running_var"):
            sd[k] = np.abs(sd[k]) + 0.5
    return sd


def _both(sd, bcfg, head_ch, ncls, x):
    """(port logits, JAX logits, port model) for one checkpoint."""
    tree = convert_full_checkpoint(sd, bcfg["interaction_indexes"])
    model = build_segmentor(
        dict(num_classes=ncls, head_channels=head_ch, backbone=bcfg), "cpu",
        state_dict=state_dict_from_jax(tree, bcfg["interaction_indexes"]))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    jm = JaxEncoderDecoder(num_classes=ncls, head_channels=head_ch,
                           backbone_cfg=bcfg)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(
            lambda v, xx: jm.apply(v, xx, train=False))(
                {"params": tree["params"],
                 "batch_stats": tree["batch_stats"]}, jnp.asarray(x)))
    return got, want, model


@pytest.fixture(scope="module")
def tiny():
    x = (np.random.default_rng(0).standard_normal((2, IMG, IMG, 6))
         * 0.5).astype(np.float32)
    got, want, model = _both(_checkpoint(), TINY_BACKBONE, HEAD_CH, NCLS, x)
    return x, got, want, model


def test_tiny_logits_match_jax(tiny):
    _, got, want, _ = tiny
    assert got.shape == want.shape == (2, IMG, IMG, NCLS)
    np.testing.assert_allclose(got, want, **TOL)


def test_inference_engine_whole_dim_matches_jax(tiny):
    """'whole_dim': logits resized to `dim`, softmax in float32."""
    x, _, want_logits, model = tiny
    dim = (48, 40)
    engine = InferenceEngine(model, dict(mode="whole_dim", dim=dim))
    probs = engine.inference(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softmax(
        resize_bilinear(jnp.asarray(want_logits), dim), axis=-1))
    np.testing.assert_allclose(probs, want, **TOL)
    pred = engine.predict(torch.from_numpy(x))
    assert pred.shape == (2, *dim) and pred.dtype == torch.int64
    np.testing.assert_array_equal(pred.numpy(), probs.argmax(-1))
    whole = InferenceEngine(model, dict(mode="whole"))
    assert whole.predict(torch.from_numpy(x)).shape == (2, IMG, IMG)
    with pytest.raises(NotImplementedError):
        InferenceEngine(model, dict(mode="slide"))


def test_bridge_round_trip_gives_back_the_checkpoint():
    """synth_state_dict -> convert_full_checkpoint -> state_dict_from_jax
    returns the same keys and values (plus num_batches_tracked), and the
    port loads it strictly."""
    sd = _checkpoint()
    idx = TINY_BACKBONE["interaction_indexes"]
    back = state_dict_from_jax(convert_full_checkpoint(sd, idx), idx)
    extra = {k for k in back if k.endswith("num_batches_tracked")}
    assert set(back) - extra == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(v), k)
    with torch.device("meta"):
        model = EncoderDecoder(NCLS, HEAD_CH, TINY_BACKBONE)
    assert set(model.state_dict()) == set(back)
    build_segmentor(dict(num_classes=NCLS, head_channels=HEAD_CH,
                         backbone=TINY_BACKBONE), "cpu", state_dict=back)


def test_seeded_build_is_reproducible_and_eval_only():
    cfg = dict(num_classes=NCLS, head_channels=HEAD_CH,
               backbone=TINY_BACKBONE)
    a = build_segmentor(cfg, "cpu", generator=torch.Generator().manual_seed(3))
    b = build_segmentor(cfg, "cpu", generator=torch.Generator().manual_seed(3))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert all(m.running_var.min() >= 0.5 for m in a.modules()
               if isinstance(m, torch.nn.BatchNorm2d))
    a.train()
    with pytest.raises(NotImplementedError):
        a(torch.zeros((1, IMG, IMG, 6)))
    with pytest.raises(ValueError):
        build_segmentor(cfg, "cpu")


def test_seeded_init_draws_norm_gains_around_one():
    """Norm gains are 1 + N(0, 0.05) and every other parameter N(0, 0.05):
    gains around 0 would flatten the softmaxes and hide a wrong kernel."""
    from multimodal_sam_adapter_torch.models.segmentor import _NORMS

    model = build_segmentor(dict(num_classes=NCLS, head_channels=HEAD_CH,
                                 backbone=TINY_BACKBONE), "cpu",
                            generator=torch.Generator().manual_seed(0))
    norms = [m for m in model.modules() if isinstance(m, _NORMS)]
    assert {"LayerNorm", "LayerNorm2d", "GroupNorm", "BatchNorm2d"} <= {
        type(m).__name__ for m in norms}
    gains = torch.cat([m.weight.flatten() for m in norms])
    assert abs(gains.mean().item() - 1.0) < 0.01
    assert 0.04 < gains.std().item() < 0.06
    gain_ids = {id(m.weight) for m in norms}
    rest = torch.cat([p.flatten() for p in model.parameters()
                      if id(p) not in gain_ids])
    assert abs(rest.mean().item()) < 0.01
    assert 0.04 < rest.std().item() < 0.06


def test_port_runs_without_jax():
    """Import every module of the port and run the plain forward at the
    tiny geometry in a fresh interpreter: jax is never imported."""
    code = """
import importlib, pkgutil, sys
import torch
import multimodal_sam_adapter_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from multimodal_sam_adapter_torch.engine.inference import InferenceEngine
from multimodal_sam_adapter_torch.models.segmentor import build_segmentor
from multimodal_sam_adapter_tpu.configs.registry import get_config
cfg = get_config("deliver_tiny")
model = build_segmentor(cfg["model"], "cpu",
                        generator=torch.Generator().manual_seed(0))
pred = InferenceEngine(model, cfg["test_cfg"]).predict(torch.zeros(1, 64, 64, 6))
assert pred.shape == (1, 64, 64), pred.shape
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax", "cv2"))
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")


def test_chip_smoke_fails_fast_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


@pytest.mark.slow
def test_flagship_geometry_logits_match_jax():
    """embed 1024 / 16 heads / window 14 / ConvNeXt-small at 512^2 with
    4 ViT blocks: every per-block shape constant of the flagship, and the
    global blocks' 127-row tables resized to 63 rows."""
    from tests.test_full_model_parity import (FLAG_HEAD_CH, FLAG_NCLS,
                                              FLAGSHIP_GEO, SMALL_CH,
                                              SMALL_DEPTHS)

    S = FLAGSHIP_GEO["img_size"]
    x = (np.random.default_rng(0).standard_normal((1, S, S, 6))
         * 0.5).astype(np.float32)
    sd = _checkpoint(ch=SMALL_CH, depths=SMALL_DEPTHS, cfg=FLAGSHIP_GEO,
                     head_ch=FLAG_HEAD_CH, ncls=FLAG_NCLS)
    got, want, _ = _both(sd, FLAGSHIP_GEO, FLAG_HEAD_CH, FLAG_NCLS, x)
    assert got.shape == want.shape == (1, S, S, FLAG_NCLS)
    np.testing.assert_allclose(got, want, **TOL)
