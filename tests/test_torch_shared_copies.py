"""The port's own copies of the JAX package's JAX-free modules, held against
their originals on the same inputs, and a scan that keeps the port's
imports free of JAX and of the JAX package, and of OpenCV and PIL.

- configs/registry.py: every config equal, `apply_overrides` equal;
- engine/metrics.py: histograms, flat and nested metrics, the report text
  and tables equal on seeded predictions;
- data/: datasets (DELIVER, FMB, MUSES layouts written with OpenCV to
  tmp_path) and `TestPipeline` under three configs' test pipelines give
  equal samples. The original may fuse normalise + pad in its native core
  (within 1e-5 of numpy); with the native core switched off the two are
  bit-equal.
"""
import ast
import os
import re
from pathlib import Path

import cv2
import numpy as np
import pytest

import multimodal_sam_adapter_torch.configs.registry as treg
import multimodal_sam_adapter_torch.data as tdata
import multimodal_sam_adapter_torch.engine.metrics as tmet
import multimodal_sam_adapter_tpu.configs.registry as jreg
import multimodal_sam_adapter_tpu.data as jdata
import multimodal_sam_adapter_tpu.data.native as jnative
import multimodal_sam_adapter_tpu.engine.metrics as jmet

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted(
    str(p.relative_to(ROOT))
    for p in (ROOT / "multimodal_sam_adapter_torch").rglob("*.py")) + [
        "chip_smoke.py", "kernel_checks.py"]
FORBIDDEN = ("jax", "jaxlib", "multimodal_sam_adapter_tpu")
# the card's machine has neither: the port reads and writes images itself
# (data/image_io.py, data/resize.py); tests may import them as references
IMAGE_LIBS = ("cv2", "PIL")


def _equal(a, b):
    """Deep equality of nested dicts / lists / tuples / arrays / scalars,
    NaN equal to NaN, types kept apart (a tuple is not a list)."""
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b)
    else:
        assert a == b


# --------------------------------------------------------------------------
# configs/registry.py
# --------------------------------------------------------------------------

def test_the_registries_list_the_same_configs():
    assert treg.list_configs() == jreg.list_configs()


@pytest.mark.parametrize("name", jreg.list_configs())
def test_get_config_equals_the_original(name):
    _equal(treg.get_config(name), jreg.get_config(name))


@pytest.mark.parametrize("overrides", [
    {"model.num_classes": "7"},
    {"test_cfg.mode": "slide", "test_cfg.stride": "(32, 32)"},
    {"log_config.interval": "5", "data.samples_per_gpu": "4"},
    {"model.backbone.window_size": "7", "evaluation.case": "None"},
    # the RGB-only segmentor's overrides
    {"dataset.modalities_ch": "[3]", "dataset.mod_dir": "[]",
     "dataset.mod_suffix": "[]", "model.backbone.modalities_ch": "[3]"},
])
def test_apply_overrides_equals_the_original(overrides):
    got = treg.apply_overrides(treg.get_config("deliver_tiny"),
                               dict(overrides))
    want = jreg.apply_overrides(jreg.get_config("deliver_tiny"),
                                dict(overrides))
    _equal(got, want)


# --------------------------------------------------------------------------
# engine/metrics.py
# --------------------------------------------------------------------------

def _hist_inputs(seed, K=7, n=6, shape=(40, 48)):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pred = rng.integers(0, K, shape)
        label = rng.integers(0, K, shape).astype(np.uint8)
        label[rng.random(shape) < 0.1] = 255
        # a class absent from the labels: NaN IoU / Acc on both sides
        label[label == K - 1] = 0
        out.append((pred, label))
    return out


@pytest.mark.parametrize("kw", [
    {}, {"reduce_zero_label": True}, {"label_map": {1: 2, 3: 255}},
    {"ignore_index": 0}])
def test_intersect_and_union_equals_the_original(kw):
    for pred, label in _hist_inputs(0):
        _equal(tmet.intersect_and_union(pred, label, 7, **kw),
               jmet.intersect_and_union(pred, label, 7, **kw))


@pytest.mark.parametrize("metrics", [("mIoU",), ("mDice", "mFscore"),
                                     ("microIoU",)])
@pytest.mark.parametrize("nan_to_num", [None, -1.0])
def test_flat_metrics_equal_the_original(metrics, nan_to_num):
    hists = [jmet.intersect_and_union(p, l, 7) for p, l in _hist_inputs(1)]
    got = tmet.pre_eval_to_metrics(hists, metrics, nan_to_num)
    want = jmet.pre_eval_to_metrics(hists, metrics, nan_to_num)
    _equal(dict(got), dict(want))
    names = [f"class{i}" for i in range(7)]
    assert (tmet.format_metrics_table(got, names)
            == jmet.format_metrics_table(want, names))
    _equal(tmet.summarize(got, names), jmet.summarize(want, names))


def test_nested_metrics_and_report_equal_the_original():
    hists = [jmet.intersect_and_union(p, l, 7) for p, l in _hist_inputs(2)]
    nested = {"cloud": {"ordinary": hists[:2], "motionblur": hists[2:3]},
              "sun": {"ordinary": hists[3:5], "overexposure": hists[5:],
                      "motionblur": []}}
    got = tmet.pre_eval_to_metrics_dict(nested, num_classes=7)
    want = jmet.pre_eval_to_metrics_dict(nested, num_classes=7)
    names = [f"class{i}" for i in range(7)]
    g_text, g_res, g_sum = tmet.render_nested_report(got, names)
    w_text, w_res, w_sum = jmet.render_nested_report(want, names)
    assert g_text == w_text
    _equal(g_res, w_res)
    _equal(g_sum, w_sum)


# --------------------------------------------------------------------------
# data/: datasets and TestPipeline
# --------------------------------------------------------------------------

def _png(path: Path, img):
    path.parent.mkdir(parents=True, exist_ok=True)
    cv2.imwrite(str(path), np.asarray(img, np.uint8))


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """Small DELIVER, FMB and MUSES layouts (the `fake_deliver` layout of
    tests/test_torch_evaluator.py for DELIVER), ragged image sizes."""
    rng = np.random.default_rng(0)
    roots = {}
    root = tmp_path_factory.mktemp("deliver")
    for i, stem in enumerate(("sun_test_0", "motionblur_rain_test_1",
                              "overexposure_fog_test_2")):
        h, w = 80 - 4 * i, 72 + 6 * i
        for d, suf, img in (
                ("images", "rgb", rng.integers(0, 255, (h, w, 3))),
                ("lidar", "lidar", rng.integers(0, 255, (h, w, 3))),
                ("annotations", "semantic", rng.integers(0, 25, (h, w)))):
            _png(root / "samples" / d / "test" / f"{stem}_{suf}_front.png",
                 img)
    roots["deliver_tiny"] = root
    root = tmp_path_factory.mktemp("fmb")
    for i in range(2):
        for d, img in (("Visible", rng.integers(0, 255, (60, 80, 3))),
                       ("Infrared", rng.integers(0, 255, (60, 80, 3))),
                       ("Label", rng.integers(0, 15, (60, 80)))):
            _png(root / "test" / d / f"{i:04d}.png", img)
    roots["fmb_rgbtherm"] = root
    root = tmp_path_factory.mktemp("muses")
    for case, cond in (("clear", "day"), ("fog", "night")):
        name = f"REC0_{case}"
        _png(root / "frame_camera" / "test" / case / cond /
             f"{name}_frame_camera.png", rng.integers(0, 255, (54, 96, 3)))
        _png(root / "gt_semantic" / "test" / case / cond /
             f"{name}_gt_labelTrainIds.png", rng.integers(0, 19, (54, 96)))
        lid = root / "projected_to_rgb" / "lidar" / "test" / case / cond
        lid.mkdir(parents=True, exist_ok=True)
        np.savez(lid / f"{name}_lidar.npz",
                 rng.standard_normal((54, 96, 3)).astype(np.float32))
    roots["muses_rgblidar"] = root
    return roots


def _pair(name, layouts):
    cfg = treg.get_config(name)
    root = str(layouts[name])
    return (tdata.build_dataset(cfg["dataset"], root, test_mode=True),
            jdata.build_dataset(cfg["dataset"], root, test_mode=True), cfg)


@pytest.mark.parametrize("name", ["deliver_tiny", "fmb_rgbtherm",
                                  "muses_rgblidar"])
def test_datasets_equal_the_original(name, layouts):
    got, want, _ = _pair(name, layouts)
    assert len(got) == len(want) > 0
    assert type(got).__name__ == type(want).__name__
    assert got.CLASSES == want.CLASSES
    for i in range(len(want)):
        _equal(got[i], want[i])
        _equal(got.get_gt(i), want.get_gt(i))


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("scale_ratio", [1.0, 0.75])
@pytest.mark.parametrize("name", ["deliver_tiny", "fmb_rgbtherm",
                                  "muses_rgblidar"])
def test_test_pipeline_equals_the_original(name, scale_ratio, native,
                                           layouts, monkeypatch):
    if not native:
        monkeypatch.setattr(jnative, "load_native", lambda: None)
    got_ds, want_ds, cfg = _pair(name, layouts)
    ch = cfg["dataset"]["modalities_ch"]
    tpipe = tdata.TestPipeline(cfg["test_pipeline"], ch, pad_size=(96, 128))
    jpipe = jdata.TestPipeline(cfg["test_pipeline"], ch, pad_size=(96, 128))
    for i in range(len(want_ds)):
        got = tpipe(got_ds[i], scale_ratio)
        want = jpipe(want_ds[i], scale_ratio)
        assert got["img"].dtype == want["img"].dtype == np.float32
        if native:
            np.testing.assert_allclose(got["img"], want["img"], rtol=1e-5,
                                       atol=1e-6)
            got["img"] = want["img"]
        _equal(got, want)


# --------------------------------------------------------------------------
# the port imports neither JAX nor the JAX package
# --------------------------------------------------------------------------

def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_the_scan_covers_the_train_modules():
    """The modules of the training step and of the train entry are
    scanned like the rest."""
    for path in ("models/losses.py", "engine/optim.py", "engine/train.py",
                 "nn/layers.py", "ops/kernels.py", "models/init.py",
                 "data/loader.py", "data/native.py", "data/pipelines.py",
                 "engine/checkpoint.py", "engine/runner.py",
                 "utils/profiling.py", "tools/train.py",
                 "parallel/__init__.py", "parallel/ddp.py",
                 "parallel/zero.py", "parallel/tp.py"):
        assert f"multimodal_sam_adapter_torch/{path}" in PORT_FILES, path


def test_the_port_reads_nothing_under_native():
    """The port builds its own copy of the host core (data/native.py)
    and names no file under the JAX package's native/."""
    for path in PORT_FILES:
        text = (ROOT / path).read_text()
        assert "native/" not in text and '"native"' not in text, path


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_module_imports_no_jax(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = [m for m in _imported_modules(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_module_imports_no_opencv_or_pil(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = [m for m in _imported_modules(tree)
           if m.split(".")[0] in IMAGE_LIBS]
    assert not bad, f"{path} imports {bad}"


def test_gpu_marked_tests_import_no_opencv():
    """The tests that run on the card's machine (marked gpu) import
    neither OpenCV nor PIL, which it lacks."""
    mark = re.compile(r"^(pytestmark\s*=.*|\s*@pytest)\.mark\.gpu\b",
                      re.MULTILINE)
    marked = [p for p in sorted((ROOT / "tests").glob("test_*.py"))
              if mark.search(p.read_text())]
    assert marked
    for p in marked:
        tree = ast.parse(p.read_text(), filename=str(p))
        bad = [m for m in _imported_modules(tree)
               if m.split(".")[0] in IMAGE_LIBS + FORBIDDEN]
        assert not bad, f"{p.name} imports {bad}"


def test_the_scan_covers_the_file_modules():
    for path in ("data/image_io.py", "data/resize.py", "engine/visualize.py",
                 "apis/inference.py", "tools/infer_test.py"):
        assert f"multimodal_sam_adapter_torch/{path}" in PORT_FILES, path


def test_the_scan_covers_the_rgb_only_and_encoder_modules():
    """The conv-stem prior, the standalone encoder, their weight maps and
    the translation of the `shift` transform are scanned like the rest."""
    for path in ("models/adapter.py", "models/sam_vit.py",
                 "models/backbone.py", "engine/convert.py",
                 "engine/checkpoint.py", "data/warp.py", "data/pipelines.py",
                 "data/image_io.py", "data/datasets.py"):
        assert f"multimodal_sam_adapter_torch/{path}" in PORT_FILES, path


def test_the_scan_covers_the_graft_entry():
    """graft_entry.py, the counterpart of __graft_entry__.py, is scanned
    like the rest: it keeps its own copy of the tiny backbone dict and
    imports neither JAX, nor the JAX package, nor the root entry points
    that import them."""
    path = "multimodal_sam_adapter_torch/graft_entry.py"
    assert path in PORT_FILES
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    mods = [m.split(".")[0] for m in _imported_modules(tree)]
    assert not set(mods) & (set(FORBIDDEN) | {"__graft_entry__", "train",
                                                "bench"}), mods
    names = {t.id for node in tree.body if isinstance(node, ast.Assign)
             for t in node.targets if isinstance(t, ast.Name)}
    assert "TINY_BACKBONE" in names
    for p in PORT_FILES:
        tree = ast.parse((ROOT / p).read_text(), filename=p)
        assert "__graft_entry__" not in [
            m.split(".")[0] for m in _imported_modules(tree)], p


def test_the_scan_sees_an_import_of_the_jax_package():
    tree = ast.parse("def f():\n    from multimodal_sam_adapter_tpu.data "
                     "import build_dataset\n    import jax.numpy as jnp\n")
    assert [m.split(".")[0] for m in _imported_modules(tree)] == [
        "multimodal_sam_adapter_tpu", "jax"]
    tree = ast.parse("def f():\n    import cv2\n    from PIL import Image\n")
    assert [m for m in _imported_modules(tree)] == ["cv2", "PIL"]
    assert os.path.exists(ROOT / "chip_smoke.py")
