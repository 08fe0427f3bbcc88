"""The port's InferenceEngine against the JAX package's, mode by mode, on
the test configurations deliver_tiny ('whole_dim' family) and muses_tiny
('slide'), float32 on the CPU, with one synthetic reference-layout
checkpoint per configuration bridged into both (as tests/test_torch_model.py
does).

Covered: 'whole', 'whole_dim', 'whole_dim_cut' (with and without its
rescale), 'slide' with overlapping windows, 'slide_mod_sel', the evaluator's
pad band (`valid_hw`) cut before the final resize, flip undo and the
flip / multi-scale average of `aug_test`. Probabilities at rtol 1e-3 /
atol 2e-4, the full-model bar.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sam_adapter_torch.engine.convert import state_dict_from_jax
from multimodal_sam_adapter_torch.engine.inference import (InferenceEngine,
                                                           slide_windows)
from multimodal_sam_adapter_torch.models.segmentor import build_segmentor
from multimodal_sam_adapter_torch.configs.registry import get_config
from multimodal_sam_adapter_tpu.engine.convert_full import (
    convert_full_checkpoint)
from multimodal_sam_adapter_tpu.engine.inference import (
    InferenceEngine as JaxInferenceEngine)
from multimodal_sam_adapter_tpu.models.segmentor import (
    EncoderDecoder as JaxEncoderDecoder)
from tests.test_convert_full import synth_state_dict

TOL = dict(rtol=1e-3, atol=2e-4)


def _engines(name, **backbone):
    """(port engine, JAX engine, config) on one bridged checkpoint; keyword
    arguments override the configuration's backbone."""
    cfg = get_config(name)
    bcfg = dict(cfg["model"]["backbone"], **backbone)
    m = cfg["model"] = dict(cfg["model"], backbone=bcfg)
    sd = synth_state_dict(cfg=bcfg, head_ch=m["head_channels"],
                          ncls=m["num_classes"])
    for k in sd:
        if k.endswith("running_var"):
            sd[k] = np.abs(sd[k]) + 0.5
    idx = bcfg["interaction_indexes"]
    tree = convert_full_checkpoint(sd, idx)
    port = build_segmentor(m, "cpu", state_dict=state_dict_from_jax(tree, idx))
    jm = JaxEncoderDecoder(num_classes=m["num_classes"],
                           head_channels=m["head_channels"],
                           backbone_cfg=bcfg)
    variables = {"params": tree["params"], "batch_stats": tree["batch_stats"]}
    return (InferenceEngine(port, cfg["test_cfg"]),
            JaxInferenceEngine(jm, variables, cfg["test_cfg"]), cfg)


def _input(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.5
            ).astype(np.float32)


def _probs(engine, jengine, test_cfg, x, **kw):
    """Class probabilities of both engines under one test_cfg (the engines'
    compiled and cached forwards are kept across modes)."""
    engine.test_cfg = jengine.test_cfg = dict(test_cfg)
    got = engine.inference(torch.from_numpy(x), **kw).numpy()
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jengine.inference(jnp.asarray(x), **kw))
    return got, want


@pytest.fixture(scope="module")
def deliver():
    return _engines("deliver_tiny")


@pytest.fixture(scope="module")
def muses():
    return _engines("muses_tiny")


@pytest.fixture(scope="module")
def fmb_like():
    """deliver_tiny's backbone at FMB's geometry (800^2: a 50x50 token grid
    that 14-windows do not tile, padded to 56, and global rel-pos tables
    of the 64x64 pretraining grid, 127 rows resized to 99 at use): here a
    6x6 grid under 4-windows, padded to 8, and tables of 7 rows resized to
    11; every ConvNeXt stage grid is whole, as at 800^2 (25 at the last)."""
    return _engines("deliver_tiny", img_size=96, window_size=4)


@pytest.mark.parametrize("test_cfg,kw,shape", [
    (dict(mode="whole_dim", rescale=True, dim=(80, 72)), {}, (80, 72)),
    (dict(mode="whole_dim", rescale=True, dim=(64, 64)),
     dict(valid_hw=(56, 60)), (64, 64)),
    (dict(mode="whole"), dict(ori_shape=(50, 70), valid_hw=(60, 52)),
     (50, 70)),
    (dict(mode="whole_dim_cut", rescale=False, dim=(48, 64),
          cut_dim=(48, 32)), {}, (32, 48)),
    (dict(mode="whole_dim_cut", rescale=True, dim=(72, 96),
          cut_dim=(80, 60)), dict(valid_hw=(60, 62)), (60, 80)),
], ids=["whole_dim", "whole_dim_valid_hw", "whole_valid_hw",
        "whole_dim_cut", "whole_dim_cut_rescale_valid_hw"])
def test_whole_family_matches_jax(deliver, test_cfg, kw, shape):
    engine, jengine, cfg = deliver
    x = _input((1, 64, 64, 6), 0)
    got, want = _probs(engine, jengine, test_cfg, x, **kw)
    assert got.shape == want.shape == (1, *shape, cfg["model"]["num_classes"])
    np.testing.assert_allclose(got, want, **TOL)


def test_fmb_geometry_whole_dim_cut_matches_jax(fmb_like):
    """FMB's test mode on its geometry: logits at the input size, then the
    top-left (h, w) = cut_dim[::-1] window, no resize."""
    engine, jengine, cfg = fmb_like
    x = _input((1, 96, 96, 6), 3)
    test_cfg = dict(mode="whole_dim_cut", rescale=False, dim=(72, 96),
                    cut_dim=(96, 72))
    got, want = _probs(engine, jengine, test_cfg, x)
    assert got.shape == want.shape == (1, 72, 96, 25)
    np.testing.assert_allclose(got, want, **TOL)


def test_flip_undo_and_aug_test_match_jax(deliver):
    engine, jengine, cfg = deliver
    x = _input((1, 64, 64, 6), 1)
    xf = np.ascontiguousarray(x[:, :, ::-1])
    got, want = _probs(engine, jengine, cfg["test_cfg"], xf, flip=True)
    np.testing.assert_allclose(got, want, **TOL)
    # flip undo maps the flipped input's probabilities back to the image
    unflipped, _ = _probs(engine, jengine, cfg["test_cfg"], x)
    assert got.shape == unflipped.shape
    pred = engine.aug_test([torch.from_numpy(x), torch.from_numpy(xf)],
                           [False, True], None)
    with jax.default_matmul_precision("highest"):
        jpred = jengine.aug_test([jnp.asarray(x), jnp.asarray(xf)],
                                 [False, True], None)
    assert pred.dtype == torch.int64 and pred.shape == jpred.shape
    np.testing.assert_array_equal(pred.numpy(), np.argmax(
        (unflipped + got) / 2, axis=-1))
    assert (pred.numpy() == jpred).mean() >= 0.999


def test_slide_windows_cover_the_image_with_the_reference_grid():
    # 96 x 80 at crop 64 / stride 32: 2 rows x 2 columns, the last column
    # shifted back to the border
    boxes = slide_windows((96, 80), (64, 64), (32, 32))
    assert boxes == [(0, 0), (0, 16), (32, 0), (32, 16)]
    count = np.zeros((96, 80))
    for y1, x1 in boxes:
        count[y1:y1 + 64, x1:x1 + 64] += 1
    assert count.min() >= 1 and count.max() == 4
    # an image no larger than the crop: one window
    assert slide_windows((64, 64), (64, 64), (32, 32)) == [(0, 0)]
    # MUSES at the flagship: 1024 x 1824 (1820 padded) gives 3 crops
    assert slide_windows((1024, 1824), (1024, 1024), (640, 640)) == [
        (0, 0), (0, 640), (0, 800)]


@pytest.mark.parametrize("mode", ["slide", "slide_mod_sel"])
def test_slide_matches_jax(muses, mode):
    """Four overlapping windows (counts 1 to 4) in one batched forward."""
    engine, jengine, cfg = muses
    x = _input((1, 96, 80, 6), 2)
    test_cfg = dict(cfg["test_cfg"], mode=mode)
    calls = []
    hook = engine.model.register_forward_pre_hook(
        lambda m, a: calls.append(tuple(a[0].shape)))
    try:
        got, want = _probs(engine, jengine, test_cfg, x)
    finally:
        hook.remove()
    assert calls == [(4, 64, 64, 6)]
    assert got.shape == want.shape == (1, 96, 80, 19)
    np.testing.assert_allclose(got, want, **TOL)


def test_slide_valid_hw_and_ori_shape_match_jax(muses):
    engine, jengine, cfg = muses
    x = _input((1, 96, 80, 6), 2)
    got, want = _probs(engine, jengine, cfg["test_cfg"], x,
                       valid_hw=(90, 77), ori_shape=(100, 70))
    assert got.shape == want.shape == (1, 100, 70, 19)
    np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(ValueError):
        engine.slide(torch.from_numpy(np.concatenate([x, x])), (64, 64),
                     (32, 32))
