"""The transforms the reference registers but no shipped config uses, in
the port (data/pipelines.py, data/warp.py) against the JAX package's
(which calls OpenCV), and the grayscale read (data/image_io.py) against
`cv2.imread(path, IMREAD_GRAYSCALE)`, on the CPU.

- `load_bin_ann` (255 -> 1, the reduce-zero variant with its 254 quirk)
  equal to the JAX package's, on gray and colour label files;
- `shift` equal to the JAX package's with the same Generator (its draws,
  the image in chunks of 4 channels, the labels nearest), and
  `warp.translate` equal to `cv2.warpAffine` bit for bit: float32
  bilinear and uint8 / float32 nearest, 1-4 channels (2 takes OpenCV's
  older fixed-point code), fractional and half-pixel shifts, shifts past
  the image, a border value;
- `crop_rect`, `resize_shortest_edge` (the max_size cap too) and
  `setr_resize` (ratio, range and value modes, the crop-size floor,
  keep_ratio off) equal to the JAX package's, image and labels, with the
  resize in the host core and in its numpy twin;
- IMREAD_GRAYSCALE on every PNG colour type and bit depth (gray 1-16
  bits, gray + alpha, RGB and RGBA of 8 and 16 bits, palettes of 1-8 bits
  with and without tRNS, Adam7), on files OpenCV and PIL write, and under
  an eXIf orientation, with the host core and the numpy twin.
"""
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from multimodal_sam_adapter_torch.data import image_io
from multimodal_sam_adapter_torch.data import pipelines as port
from multimodal_sam_adapter_torch.data.warp import translate
from multimodal_sam_adapter_tpu.data import pipelines as jax_pipelines
from tests.test_torch_image_io import CHANNELS, KINDS, _chunk, encode


def _same(got, want):
    assert want is not None
    assert got.shape == want.shape and got.dtype == want.dtype, (
        got.shape, got.dtype, want.shape, want.dtype)
    np.testing.assert_array_equal(got, want)


def _gray_check(path):
    want = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    for native in (True, False):
        _same(image_io.imread(path, "grayscale", native=native), want)


def _sample(rng, h, w, c, classes=5):
    img = (rng.random((h, w, c)) * 255).astype(np.float32)
    gt = rng.integers(0, classes, (h, w)).astype(np.uint8)
    gt[rng.random((h, w)) < 0.1] = 255
    return {"img": img, "gt": gt, "meta": {}}


def _copy(sample):
    return {"img": sample["img"].copy(), "gt": sample["gt"].copy(),
            "meta": dict(sample["meta"])}


def _same_sample(got, want):
    _same(got["img"], want["img"])
    _same(got["gt"], want["gt"])
    assert got["meta"] == want["meta"]


# ------------------------------------------------------------ grayscale read

@pytest.mark.parametrize("color,depth,lace,trns", KINDS)
def test_grayscale_equals_opencv_on_every_png_kind(tmp_path, color, depth,
                                                   lace, trns):
    rng = np.random.default_rng(depth * 100 + color * 10 + lace)
    top = 1 << depth
    for i, (h, w) in enumerate(((1, 1), (13, 29), (40, 7))):
        palette = key = None
        if color == 3:
            n = int(rng.integers(1, min(top, 256) + 1))
            palette = rng.integers(0, 256, (n, 3))
            samples = rng.integers(0, top, (h, w, 1))
            if trns:
                key = bytes(rng.integers(0, 256, int(rng.integers(1, n + 1)))
                            .astype(np.uint8))
        else:
            samples = rng.integers(0, top, (h, w, CHANNELS[color]))
            if trns:
                key = struct.pack(">" + "H" * CHANNELS[color],
                                  *map(int, samples[0, 0]))
        path = tmp_path / f"k{i}.png"
        path.write_bytes(encode(samples, color, depth, palette, key, lace,
                                tuple(int(f) for f in rng.permutation(5))))
        _gray_check(path)


def test_grayscale_equals_opencv_on_files_opencv_and_pil_write(tmp_path):
    rng = np.random.default_rng(4)
    h, w = 21, 34
    for i, (shape, dtype) in enumerate((
            ((h, w), np.uint8), ((h, w, 3), np.uint8), ((h, w, 4), np.uint8),
            ((h, w), np.uint16), ((h, w, 3), np.uint16),
            ((h, w, 4), np.uint16))):
        img = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
        path = tmp_path / f"cv{i}.png"
        assert cv2.imwrite(str(path), img)
        _gray_check(path)
    u8 = lambda *s: rng.integers(0, 256, (h, w) + s).astype(np.uint8)  # noqa
    files = []
    for bits in (1, 2, 4, 8):
        im = Image.fromarray(rng.integers(0, 1 << bits, (h, w))
                             .astype(np.uint8), "P")
        im.putpalette(list(rng.integers(0, 256, 3 << bits)))
        files += [(im, dict(bits=bits)), (im, dict(bits=bits, transparency=(
            bytes(rng.integers(0, 256, 1 << bits).astype(np.uint8)))))]
    files += [(Image.fromarray(np.dstack([u8(), u8()]), "LA"), {}),
              (Image.fromarray(u8() >= 128), {}),
              (Image.fromarray(u8(3), "RGB"), dict(transparency=(1, 2, 3))),
              (Image.fromarray(u8(4), "RGBA"), {})]
    for i, (im, kw) in enumerate(files):
        path = tmp_path / f"pil{i}.png"
        im.save(path, **kw)
        _gray_check(path)


@pytest.mark.parametrize("orientation", [1, 3, 6, 8])
def test_grayscale_turns_by_exif_as_opencv_does(tmp_path, orientation):
    img = np.arange(4 * 7 * 3, dtype=np.uint8).reshape(4, 7, 3) * 2
    tiff = (b"II" + struct.pack("<HIH", 42, 8, 1)
            + struct.pack("<HHIH", 0x0112, 3, 1, orientation)
            + b"\x00\x00" + struct.pack("<I", 0))
    data = image_io.encode_png(img)
    at = data.index(b"IDAT") - 4
    path = tmp_path / f"exif{orientation}.png"
    path.write_bytes(data[:at] + _chunk(b"eXIf", tiff) + data[at:])
    _gray_check(path)


# --------------------------------------------------------------- load_bin_ann

@pytest.mark.parametrize("reduce_zero_label", [False, True])
def test_load_bin_ann_equals_jax(tmp_path, reduce_zero_label):
    rng = np.random.default_rng(5)
    gray = rng.choice(np.array([0, 1, 2, 253, 254, 255], np.uint8), (30, 17))
    colour = rng.integers(0, 256, (30, 17, 3)).astype(np.uint8)
    colour[:4] = 255                     # white: gray 255 -> 1
    for i, img in enumerate((gray, colour)):
        path = str(tmp_path / f"ann{i}.png")
        image_io.imwrite(path, img)
        _same(port.load_bin_ann(path, reduce_zero_label),
              jax_pipelines.load_bin_ann(path, reduce_zero_label))


# ------------------------------------------------------------------ the shift

def _cv_warp(img, dx, dy, interpolation, border_value):
    mat = np.float32([[1, 0, dx], [0, 1, dy]])
    bv = (tuple([float(border_value)] * img.shape[2])
          if img.ndim == 3 else border_value)
    return cv2.warpAffine(img, mat, (img.shape[1], img.shape[0]),
                          flags=interpolation,
                          borderMode=cv2.BORDER_CONSTANT, borderValue=bv)


SHIFTS = ((3.3, -2.7), (0.51, 0.49), (-5.123, 7.777), (1 / 64, -1 / 3),
          (0.5, -1.5), (-2.5, 0.5), (40.2, 0.1), (-0.25, -60.0), (0.0, 0.0))


@pytest.mark.parametrize("cn", [1, 2, 3, 4])
def test_translate_bilinear_float32_equals_opencv(cn):
    rng = np.random.default_rng(cn)
    for h, w in ((37, 53), (1, 9), (16, 1)):
        img = (rng.standard_normal((h, w, cn)) * 50).astype(np.float32)
        if cn == 1:
            img = img[..., 0]
        for dx, dy in SHIFTS:
            for bv in (0.0, 7.0):
                want = _cv_warp(img, dx, dy, cv2.INTER_LINEAR, bv)
                _same(translate(img, dx, dy, bv), want)


@pytest.mark.parametrize("cn", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_translate_nearest_equals_opencv(cn, dtype):
    rng = np.random.default_rng(10 + cn)
    img = rng.integers(0, 255, (29, 41, cn)).astype(dtype)
    if cn == 1:
        img = img[..., 0]
    for dx, dy in SHIFTS:
        for bv in (0, 255):
            want = _cv_warp(img, dx, dy, cv2.INTER_NEAREST, bv)
            _same(translate(img, dx, dy, bv, "nearest"), want)


def test_translate_refuses_what_it_does_not_compute():
    with pytest.raises(TypeError, match="float32"):
        translate(np.zeros((4, 4), np.uint8), 0.5, 0.5)
    with pytest.raises(ValueError, match="C <= 4"):
        translate(np.zeros((4, 4, 5), np.float32), 0.5, 0.5)


@pytest.mark.parametrize("channels", [3, 6])
def test_shift_equals_jax(channels):
    """prob 1 and 0.5 over several seeds: the same draws, the same image
    (chunks of 4 channels: a 6-channel image takes the 4- and 2-channel
    codes) and the same nearest labels."""
    for seed in range(6):
        sample = _sample(np.random.default_rng(seed), 33, 47, channels)
        for prob in (1.0, 0.5):
            kw = dict(x_trans=9.5, y_trans=4.25, prob=prob, pad_val=3.0,
                      seg_pad_val=255)
            got = port.shift(_copy(sample), np.random.default_rng(seed), **kw)
            want = jax_pipelines.shift(_copy(sample),
                                       np.random.default_rng(seed), **kw)
            _same_sample(got, want)


# ----------------------------------------------------- crops and the resizes

def test_crop_rect_equals_jax():
    sample = _sample(np.random.default_rng(1), 45, 62, 6)
    for box in ((0.1, 0.9, 0.0, 0.5), (0.0, 1.0, 0.33, 0.67),
                (0.5, 0.5, 0.2, 0.8)):
        _same_sample(port.crop_rect(_copy(sample), box),
                     jax_pipelines.crop_rect(_copy(sample), box))


@pytest.mark.parametrize("native", [True, False])
def test_resize_shortest_edge_equals_jax(native):
    rng = np.random.default_rng(2)
    for (h, w, c), scale, max_size in (((45, 62, 3), 40, 100),
                                       ((62, 45, 6), (30, 50), 60),
                                       ((20, 90, 4), 40, 120),
                                       ((33, 33, 1), 17.5, 1000)):
        sample = _sample(rng, h, w, c)
        got = port.resize_shortest_edge(_copy(sample), scale, max_size,
                                        native=native)
        want = jax_pipelines.resize_shortest_edge(_copy(sample), scale,
                                                  max_size)
        _same_sample(got, want)


SETR = {
    "ratio": dict(img_scale=(64, 48), ratio_range=(0.5, 2.0)),
    "range": dict(img_scale=[(80, 40), (48, 24)], multiscale_mode="range"),
    "value": dict(img_scale=[(80, 40), (48, 24), (32, 32)],
                  multiscale_mode="value"),
    "floor_wide": dict(img_scale=(64, 32), ratio_range=(0.5, 1.0),
                       crop_size=40, setr_multi_scale=True),
    "floor_tall": dict(img_scale=[(80, 40), (48, 24)],
                       multiscale_mode="range", crop_size=30,
                       setr_multi_scale=True),
    "no_keep_ratio": dict(img_scale=(70, 30), ratio_range=(0.8, 1.2),
                          keep_ratio=False),
}


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("mode", sorted(SETR))
def test_setr_resize_equals_jax(mode, native):
    for seed in range(3):
        hwc = (37, 53, 6) if mode != "floor_tall" else (53, 37, 3)
        sample = _sample(np.random.default_rng(seed), *hwc)
        got = port.setr_resize(_copy(sample), np.random.default_rng(seed),
                               native=native, **SETR[mode])
        want = jax_pipelines.setr_resize(
            _copy(sample), np.random.default_rng(seed), **SETR[mode])
        _same_sample(got, want)
