"""The port's training data path on the CPU against the JAX package's, at
deliver_tiny sizes: each train transform (with the numpy Generator left
in the same state), `TrainPipeline`, the native normalize + pad core and
the loader.

Tolerances:
- crop, flip, photometric distortion, labels: exactly equal. The HSV round
  trip copies OpenCV's 8-bit arithmetic, held equal to cv2.cvtColor on
  every input the photometric step produces;
- the random-ratio resize: exactly equal, images and labels
  (data/resize.py reproduces OpenCV's INTER_LINEAR, IPP's included), with
  the host core and with its numpy twin;
- the Gaussian blur: within 1e-3;
- `TrainPipeline`: labels equal, images within 1e-5 (normalised;
  normalise rounds in another order), with the JAX package's own OpenCV
  resize;
- the native core: bit-equal to its numpy twin.
"""
import copy
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

import multimodal_sam_adapter_torch.data.native as tnative
import multimodal_sam_adapter_torch.data.pipelines as T
import multimodal_sam_adapter_tpu.data.pipelines as J
from multimodal_sam_adapter_torch.configs.registry import get_config
from multimodal_sam_adapter_torch.data.loader import DataLoader as TLoader
from multimodal_sam_adapter_tpu.data.loader import DataLoader as JLoader

ROOT = Path(__file__).resolve().parents[1]
TINY = get_config("deliver_tiny")
TRAIN_CFG = TINY["train_pipeline"]


def _sample(seed, hw=(80, 80), ignore=0.05):
    rng = np.random.default_rng(seed)
    gt = rng.integers(0, 25, hw).astype(np.uint8)
    gt[rng.random(hw) < ignore] = 255
    return {"img": rng.uniform(0, 255, hw + (6,)).astype(np.float32),
            "gt": gt, "meta": {"stem": f"s{seed}"}}


def _pair(fn_j, fn_t, seed, sample, **kw):
    """Each package's transform on its own copy of `sample` with its own
    Generator seeded `seed`; asserts the generators end in one state."""
    gj, gt = np.random.default_rng(seed), np.random.default_rng(seed)
    a = fn_j(copy.deepcopy(sample), gj, **kw)
    b = fn_t(copy.deepcopy(sample), gt, **kw)
    assert gj.bit_generator.state == gt.bit_generator.state
    return a, b


# ------------------------------------------------------------- transforms

@pytest.mark.parametrize("hw", [(80, 80), (97, 131), (1042, 1042)])
def test_random_scale_resize(hw):
    for seed in range(6 if hw[0] < 1000 else 2):
        s = _sample(seed, hw)
        a, b = _pair(J.random_scale_resize, T.random_scale_resize, seed, s,
                     img_scale=(80, 80) if hw[0] < 1000 else (1042, 1042),
                     ratio_range=(0.5, 2.0))
        assert b["img"].dtype == np.float32
        np.testing.assert_array_equal(a["img"], b["img"])
        np.testing.assert_array_equal(a["gt"], b["gt"])


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("ratio", [0.5, 0.73, 1.0, 1.37, 2.0])
def test_resize_matches_opencv(ratio, native):
    s = _sample(7, (96, 120))
    wh = (int(120 * ratio + 0.5), int(96 * ratio + 0.5))
    np.testing.assert_array_equal(T.resize_bilinear_hwc(s["img"], wh, native),
                                  J._resize_multichannel(s["img"], wh))
    np.testing.assert_array_equal(T.resize_nearest(s["gt"], wh),
                                  J.imresize(s["gt"], wh, "nearest"))


@pytest.mark.parametrize("retry", [False, True])
def test_random_crop(retry):
    for seed in range(12):
        # few labels, so the cat_max_ratio loop re-crops
        s = _sample(seed)
        s["gt"] = np.where(s["gt"] < 20, 0, s["gt"] % 3).astype(np.uint8)
        a, b = _pair(J.random_crop, T.random_crop, seed, s, crop_size=(64, 48),
                     cat_max_ratio=0.75, retry_multilabel=retry)
        np.testing.assert_array_equal(a["img"], b["img"])
        np.testing.assert_array_equal(a["gt"], b["gt"])


def test_random_flip():
    for seed in range(8):
        a, b = _pair(J.random_flip, T.random_flip, seed, _sample(seed))
        np.testing.assert_array_equal(a["img"], b["img"])
        np.testing.assert_array_equal(a["gt"], b["gt"])


@pytest.mark.parametrize("hw", [(40, 50), (64, 64), (33, 97)])
def test_photometric_distortion_exact(hw):
    for seed in range(30):
        a, b = _pair(J.photometric_distortion, T.photometric_distortion,
                     seed, _sample(100 + seed, hw))
        np.testing.assert_array_equal(a["img"], b["img"])


def test_bgr_to_hsv_equals_opencv_on_every_color():
    a = np.arange(256, dtype=np.uint8)
    bgr = np.stack(np.meshgrid(a, a, a, indexing="ij"), -1).reshape(
        4096, 4096, 3)
    np.testing.assert_array_equal(T.bgr_to_hsv_u8(bgr),
                                  cv2.cvtColor(bgr, cv2.COLOR_BGR2HSV))


@pytest.mark.parametrize("width", [256, 33, 7])
def test_hsv_to_bgr_equals_opencv_on_every_input(width):
    """Every (H < 180, S, V), in rows of `width`: whole SIMD blocks, blocks
    and a tail, a tail alone."""
    a = np.arange(256, dtype=np.uint8)
    hsv = np.stack(np.meshgrid(np.arange(180, dtype=np.uint8), a, a,
                               indexing="ij"), -1).reshape(-1, 3)
    n = len(hsv) // width * width
    img = hsv[:n].reshape(-1, width, 3)
    np.testing.assert_array_equal(T.hsv_to_bgr_u8(img),
                                  cv2.cvtColor(img, cv2.COLOR_HSV2BGR))


def test_random_gaussian_blur():
    hit = 0
    for seed in range(20):
        s = _sample(seed, (41, 67))
        a, b = _pair(J.random_gaussian_blur, T.random_gaussian_blur, seed, s,
                     kernel_size=3, p=0.5)
        hit += not np.array_equal(b["img"], s["img"])
        np.testing.assert_allclose(a["img"], b["img"], atol=1e-3, rtol=0)
    assert 0 < hit < 20


# ------------------------------------------------------------ TrainPipeline

@pytest.mark.parametrize("native", [False, True])
def test_train_pipeline_equals_jax(native):
    for seed in range(20):
        s = _sample(seed)
        a, b = _pair(J.TrainPipeline(TRAIN_CFG, (3, 3)),
                     T.TrainPipeline(TRAIN_CFG, (3, 3), native=native),
                     seed, s)
        assert b["img"].shape == (64, 64, 6) and b["img"].dtype == np.float32
        np.testing.assert_array_equal(a["gt"], b["gt"])
        assert b["meta"]["pad_shape"] == a["meta"]["pad_shape"]
        np.testing.assert_allclose(a["img"], b["img"], atol=1e-5, rtol=0)


def test_train_pipeline_leaves_the_dataset_sample_alone():
    s = _sample(0)
    keep = copy.deepcopy(s)
    T.TrainPipeline(TRAIN_CFG, (3, 3), native=False)(
        s, np.random.default_rng(0))
    assert s.keys() == keep.keys() and s["meta"] == keep["meta"]
    np.testing.assert_array_equal(s["img"], keep["img"])
    np.testing.assert_array_equal(s["gt"], keep["gt"])


def test_three_modalities_take_the_numpy_path():
    """A layout the core does not fuse (MUSES's three modalities, only the
    RGB slice divided by 255) is normalised and padded as the JAX
    package's numpy path does it, bit-equal."""
    n = get_config("muses_rgbeventlidar")["train_pipeline"]["normalize"]
    rng = np.random.default_rng(0)
    s = {"img": rng.uniform(0, 200, (50, 61, 9)).astype(np.float32),
         "gt": rng.integers(0, 19, (50, 61)).astype(np.uint8), "meta": {}}
    want = J._normalize_then_pad(copy.deepcopy(s), (3, 3, 3), n, (64, 64))
    got = T.normalize_then_pad(copy.deepcopy(s), (3, 3, 3), n, (64, 64))
    np.testing.assert_array_equal(got["img"], want["img"])
    np.testing.assert_array_equal(got["gt"], want["gt"])


# -------------------------------------------------------------- native core

def test_native_source_is_the_jax_package_s_core():
    mine = (ROOT / "multimodal_sam_adapter_torch/csrc/host/pipeline_core.cpp"
            ).read_text()
    theirs = (ROOT / "native/pipeline_core.cpp").read_text()
    body = "#include <cstdint>"
    assert mine[mine.index(body):] == theirs[theirs.index(body):]


@pytest.mark.parametrize("hw,out_hw", [((64, 64), (64, 64)),
                                       ((50, 37), (64, 64)),
                                       ((1, 3), (2, 5))])
@pytest.mark.parametrize("ch,flip,d255", [
    ((3, 3), (True, True), (True, True)),
    ((3, 3), (True, False), (True, False)),
    ((3, 3, 3), (True, False, False), (True, False, False)),
    ((6,), (False,), (False,))])
def test_native_core_bit_equal_to_numpy(hw, out_hw, ch, flip, d255):
    rng = np.random.default_rng(sum(hw) + len(ch))
    img = rng.uniform(-10, 300, hw + (sum(ch),)).astype(np.float32)
    means = [rng.uniform(-1, 1, c).astype(np.float32) for c in ch]
    stds = [rng.uniform(0.1, 3, c).astype(np.float32) for c in ch]
    args = (img, ch, means, stds, flip, d255, out_hw, -7.5)
    got = tnative.normalize_pad_native(*args)
    want = tnative.normalize_pad_numpy(*args)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    lab = rng.integers(0, 255, hw).astype(np.uint8)
    np.testing.assert_array_equal(tnative.pad_label_native(lab, out_hw, 255),
                                  tnative.pad_label_numpy(lab, out_hw, 255))


def test_native_core_refuses_what_it_cannot_hold():
    img = np.zeros((8, 8, 6), np.float32)
    stats = ([[0.0] * 3] * 2, [[1.0] * 3] * 2, (True, True), (True, True))
    with pytest.raises(ValueError, match="smaller than the input"):
        tnative.normalize_pad_native(img, (3, 3), *stats, (8, 7))
    with pytest.raises(ValueError, match="channels for modalities"):
        tnative.normalize_pad_native(img, (3, 2), *stats, (8, 8))
    with pytest.raises(ValueError, match="smaller than the input"):
        tnative.pad_label_native(np.zeros((8, 8), np.uint8), (7, 8))


def test_native_core_against_the_jax_numpy_path():
    s = _sample(3, (50, 37))
    n = TRAIN_CFG["normalize"]
    want = J.pad_to_size(J.normalize_multimodal(
        copy.deepcopy(s), (3, 3), *T._normalize_stats((3, 3), n), True),
        (64, 64))
    got = T.normalize_then_pad(copy.deepcopy(s), (3, 3), n, (64, 64))
    np.testing.assert_allclose(got["img"], want["img"], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got["gt"], want["gt"])


def test_native_core_is_built_here_not_read_from_native():
    lib = tnative.load_native()
    path = Path(lib._name).resolve()
    assert path.parent == tnative.build_dir()
    assert (ROOT / "build" / "host") in path.parents
    assert "native" not in path.relative_to(ROOT).parts


def test_native_build_failure_raises_with_the_compiler_message(
        monkeypatch, tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(tnative, "_LIB", None)
    with pytest.raises(RuntimeError, match="broken.cpp.*failed"):
        tnative.load_native()


def test_train_transforms_need_no_opencv():
    """TrainPipeline with the native core, in a process where importing
    cv2 fails."""
    code = (
        "import sys; sys.modules['cv2'] = None\n"
        "import numpy as np\n"
        "from multimodal_sam_adapter_torch.configs.registry import get_config\n"
        "from multimodal_sam_adapter_torch.data import TrainPipeline\n"
        "cfg = get_config('deliver_tiny')\n"
        "cfg['train_pipeline']['gaussian_blur']['p'] = 1.0\n"
        "rng = np.random.default_rng(0)\n"
        "s = {'img': rng.uniform(0, 255, (80, 80, 6)).astype(np.float32),\n"
        "     'gt': rng.integers(0, 25, (80, 80)).astype(np.uint8), 'meta': {}}\n"
        "for seed in range(8):\n"
        "    out = TrainPipeline(cfg['train_pipeline'])(s, "
        "np.random.default_rng(seed))\n"
        "    assert out['img'].shape == (64, 64, 6)\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]


# ------------------------------------------------------------------- loader

class _Indexed:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"img": np.full((2, 3, 1), i, np.float32),
                "gt": np.full((2, 3), i, np.uint8), "meta": {"i": i}}


def _draw(sample, rng):
    """A pipeline whose output depends on its generator's draws."""
    sample = dict(sample)
    sample["img"] = sample["img"] + rng.random()
    return sample


def _batches(cls, **kw):
    return list(cls(_Indexed(kw.pop("n")), _draw, **kw))


@pytest.mark.parametrize("kw", [
    dict(n=10, batch_size=3, shuffle=True, seed=5),
    dict(n=10, batch_size=3, shuffle=True, seed=5, drop_last=False),
    dict(n=11, batch_size=2, shuffle=True, seed=1, num_shards=2,
         shard_index=1),
    dict(n=11, batch_size=2, shuffle=False, num_shards=3, shard_index=2,
         drop_last=False),
    dict(n=7, batch_size=1, shuffle=True, seed=3, num_threads=3, prefetch=1),
], ids=["drop_last", "keep_last", "shard_1_of_2", "shard_2_of_3",
        "three_threads"])
def test_loader_equals_jax(kw):
    for epoch in (0, 1, 4):
        tl, jl = TLoader(_Indexed(kw["n"]), _draw, **{
            k: v for k, v in kw.items() if k != "n"}), JLoader(
            _Indexed(kw["n"]), _draw, **{k: v for k, v in kw.items()
                                         if k != "n"})
        tl.set_epoch(epoch)
        jl.set_epoch(epoch)
        assert len(tl) == len(jl)
        got, want = list(tl), list(jl)
        assert len(got) == len(want) == len(tl)
        for g, w in zip(got, want):
            assert g["img"].dtype == np.float32 and g["gt"].dtype == np.int32
            np.testing.assert_array_equal(g["img"], w["img"])
            np.testing.assert_array_equal(g["gt"], w["gt"])
            assert g["meta"] == w["meta"]


@pytest.mark.parametrize("n,batch_size,shards", [
    (11, 2, 2), (7, 1, 2), (13, 3, 4), (8, 2, 2)])
def test_loader_shards_yield_len_batches(n, batch_size, shards):
    """With several shards and drop_last every shard yields len(loader)
    batches (the shuffled order cut to whole global batches, as
    DistributedSampler(drop_last=True) cuts it), so that data-parallel
    ranks take the same number of steps; the shards are disjoint, and each
    is the start of the JAX loader's shard (which may hold one batch
    more)."""
    seen = []
    for k in range(shards):
        kw = dict(batch_size=batch_size, shuffle=True, seed=2,
                  num_shards=shards, shard_index=k)
        tl = TLoader(_Indexed(n), _draw, **kw)
        tl.set_epoch(1)
        jl = JLoader(_Indexed(n), _draw, **kw)
        jl.set_epoch(1)
        got, want = list(tl), list(jl)
        assert len(got) == len(tl) == n // (shards * batch_size)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["img"], w["img"])
            assert g["meta"] == w["meta"]
        seen += [m["i"] for b in got for m in b["meta"]]
    assert len(seen) == len(set(seen)) == n // (shards * batch_size) * (
        shards * batch_size)


def test_loader_epochs_differ_and_repeat():
    loader = TLoader(_Indexed(9), _draw, batch_size=3, shuffle=True, seed=2)
    first = [b["meta"] for b in loader]
    assert [b["meta"] for b in loader] == first
    loader.set_epoch(1)
    assert [b["meta"] for b in loader] != first


def test_loader_hands_a_pipeline_error_to_the_consumer():
    def broken(sample, rng):
        if sample["meta"]["i"] == 4:
            raise ValueError("bad sample 4")
        return sample

    with pytest.raises(ValueError, match="bad sample 4"):
        list(TLoader(_Indexed(8), broken, batch_size=2))
