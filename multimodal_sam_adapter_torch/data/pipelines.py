"""Host-side data pipelines, the port's own copy of
multimodal_sam_adapter_tpu/data/pipelines.py.

A sample is a dict
  {'img': (H, W, C) float32 (OpenCV BGR channel order, like the reference),
   'gt': (H, W) uint8 or None, 'meta': {...}}

Nothing here uses OpenCV, which the card's machine lacks: images and
labels are read by data/image_io.py (PNG, equal to cv2.imread) and resized
by data/resize.py (equal to cv2.resize), so the samples equal the JAX
package's bit for bit (tests/test_torch_shared_copies.py,
tests/test_torch_train_data.py).

Test side: the multimodal image and annotation loaders, the mmcv-style
deterministic resize, the per-modality normalisation, the bottom/right pad
and `TestPipeline`. Normalise and pad run in numpy (the JAX package may
fuse them in its native core, within 1e-5 of the numpy path).

Train side: `TrainPipeline` and its transforms (Gaussian blur, random-ratio
resize, random crop with the cat_max_ratio re-crop loop, flip, photometric
distortion, then normalise + pad through the native core of data/native.py
or its numpy twin):

- bilinear resize of the float image and nearest resize of the labels:
  data/resize.py, as on the test side;
- the 8-bit BGR <-> HSV round trip of the photometric step: OpenCV's own
  arithmetic (the fixed-point BGR2HSV tables; HSV2BGR in float32 with its
  fused multiply-adds, the cast truncating in the 32-pixel SIMD blocks of
  each row and rounding in the row's scalar tail, as its AVX2 build does),
  equal to OpenCV on every input the step produces;
- the 3x3, sigma-0 Gaussian blur: the separable [1/4, 1/2, 1/4] with
  OpenCV's BORDER_REFLECT_101.

Each transform makes the same calls on the numpy Generator as the JAX
package's, in the same order, so a seed gives the same crop, flip and
photometric draws in both.

The transforms the reference registers but no shipped config uses, ported
with the JAX package's semantics and draws and not called by either
package's pipelines: `load_bin_ann` (a grayscale read, 255 -> 1),
`shift` (a random translation: data/warp.py, equal to cv2.warpAffine),
`crop_rect`, `resize_shortest_edge` and `setr_resize` (on data/resize.py).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from . import native as _native
from .image_io import imread
from .resize import resize as imresize
from .resize import resize_channels, resize_nearest
from .warp import translate

# ---------------------------------------------------------------------------
# mmcv-compatible resize helpers (`imresize` is data/resize.py's `resize`:
# size is (w, h))
# ---------------------------------------------------------------------------


def rescale_size(old_wh: Tuple[int, int], scale) -> Tuple[int, int]:
    """mmcv.rescale_size: fit (w, h) inside `scale` keeping aspect ratio."""
    w, h = old_wh
    if isinstance(scale, (float, int)) and not isinstance(scale, bool):
        factor = float(scale)
    else:
        max_long, max_short = max(scale), min(scale)
        factor = min(max_long / max(h, w), max_short / min(h, w))
    return int(w * factor + 0.5), int(h * factor + 0.5)


def imrescale(img: np.ndarray, scale, interpolation: str = "bilinear"):
    new_wh = rescale_size((img.shape[1], img.shape[0]), scale)
    return imresize(img, new_wh, interpolation)


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------

def load_multimodal_image(img_path: str, mod_paths: Sequence[str],
                          mod_channels: Sequence[int]) -> np.ndarray:
    """RGB image (OpenCV color, BGR) + aux modalities concatenated along
    channels. 1-channel aux image files are tiled to 3 channels; a .npz aux
    (MUSES) loads 'arr_0' and expands a 2-D map to one channel."""
    parts = [imread(img_path, "color").astype(np.float32)]
    for path, ch in zip(mod_paths, mod_channels):
        if path.endswith(".npz"):
            with np.load(path) as z:
                m = z["arr_0"] if "arr_0" in z else z[list(z.keys())[0]]
            m = np.asarray(m, np.float32)
        elif ch == 1:
            m = imread(path, "unchanged")
            m = np.tile(np.asarray(m, np.float32)[:, :, None], (1, 1, 3))
        else:
            m = imread(path, "color").astype(np.float32)
        if m.ndim == 2:
            m = m[:, :, None]
        parts.append(m.astype(np.float32))
    return np.concatenate(parts, axis=2)


def load_annotation(path: str, reduce_zero_label: bool = False) -> np.ndarray:
    gt = imread(path, "unchanged")
    if gt.ndim == 3:
        gt = gt[:, :, 0]
    gt = gt.astype(np.int32)
    if reduce_zero_label:
        # overflow-safe reduce-zero: 0 -> 255 (ignored), k -> k - 1
        gt[gt == 0] = 256
        gt = gt - 1
    return np.clip(gt, 0, 255).astype(np.uint8)


def load_bin_ann(path: str, reduce_zero_label: bool = False) -> np.ndarray:
    """Binary annotation (the reference's LoadBinAnn): the grayscale read,
    255 mapped to 1, then the reduce-zero variant with the reference's 254
    sentinel quirk."""
    gt = imread(path, "grayscale").astype(np.uint8)
    gt[gt == 255] = 1
    if reduce_zero_label:
        gt = gt.astype(np.int32)
        gt[gt == 0] = 255
        gt = gt - 1
        gt[gt == 254] = 255
        gt = np.clip(gt, 0, 255).astype(np.uint8)
    return gt


# ---------------------------------------------------------------------------
# deterministic transforms
# ---------------------------------------------------------------------------

def resize_multimodal(sample: Dict, img_scale, keep_ratio: bool = True,
                      seg_scale=None) -> Dict:
    """Test-time resize. img_scale is (w, h) mmcv-style."""
    img = sample["img"]
    if keep_ratio:
        new_wh = rescale_size((img.shape[1], img.shape[0]), img_scale)
        img = resize_channels(img, new_wh)
    else:
        img = resize_channels(img, img_scale)
    sample["img"] = img
    if sample.get("gt") is not None:
        scale = seg_scale or img_scale
        if keep_ratio:
            sample["gt"] = imrescale(sample["gt"], scale, "nearest")
        else:
            sample["gt"] = imresize(sample["gt"], scale, "nearest")
    sample.setdefault("meta", {})["img_shape"] = img.shape
    return sample


def crop_rect(sample: Dict, box_crop: Tuple[float, float, float, float]
              ) -> Dict:
    """Fixed fractional-box crop (the reference's CropRect): box_crop =
    (y1, y2, x1, x2) as fractions of the image's height and width."""
    fy1, fy2, fx1, fx2 = box_crop

    def crop(a):
        y1, y2 = int(fy1 * a.shape[0]), int(fy2 * a.shape[0])
        x1, x2 = int(fx1 * a.shape[1]), int(fx2 * a.shape[1])
        return a[y1:y2, x1:x2]

    sample["img"] = crop(sample["img"])
    if sample.get("gt") is not None:
        sample["gt"] = crop(sample["gt"])
    sample.setdefault("meta", {})["img_shape"] = sample["img"].shape
    return sample


def resize_shortest_edge(sample: Dict, scale, max_size: int,
                         native: bool = True) -> Dict:
    """detectron2's shortest-edge resize (the reference's
    ResizeShortestEdge): the short edge to `scale` unless the long edge
    would pass `max_size`, which it is then fitted to."""
    img = sample["img"]
    h, w = img.shape[:2]
    size = float(scale if isinstance(scale, (int, float)) else min(scale))
    f = size / min(h, w)
    nh, nw = (size, f * w) if h < w else (f * h, size)
    if max(nh, nw) > max_size:
        f2 = max_size / max(nh, nw)
        nh, nw = nh * f2, nw * f2
    nh, nw = int(nh + 0.5), int(nw + 0.5)
    sample["img"] = resize_channels(img, (nw, nh), native=native)
    if sample.get("gt") is not None:
        sample["gt"] = resize_nearest(sample["gt"], (nw, nh))
    sample.setdefault("meta", {})["img_shape"] = sample["img"].shape
    return sample


def setr_resize(sample: Dict, rng: np.random.Generator, img_scale=None,
                multiscale_mode: str = "range", ratio_range=None,
                keep_ratio: bool = True, crop_size=None,
                setr_multi_scale: bool = False, native: bool = True) -> Dict:
    """SETR's multiscale resize (the reference's SETR_Resize): the scale
    from a ratio of the first scale (`ratio_range`), a random long and
    short edge between two scales ('range'), or one of the scales
    ('value'); with `setr_multi_scale` (and keep_ratio, crop_size) the
    image's short edge goes to max(the scale's short edge, crop_size)."""
    scales = ([tuple(img_scale)] if isinstance(img_scale[0], (int, float))
              else [tuple(s) for s in img_scale])
    if ratio_range is not None:
        r = rng.uniform(*ratio_range)
        scale = (int(scales[0][0] * r), int(scales[0][1] * r))
    elif multiscale_mode == "range" and len(scales) == 2:
        longs, shorts = [max(s) for s in scales], [min(s) for s in scales]
        scale = (int(rng.integers(min(longs), max(longs) + 1)),
                 int(rng.integers(min(shorts), max(shorts) + 1)))
    else:  # 'value': one of the scales
        scale = scales[int(rng.integers(len(scales)))]
    img = sample["img"]
    if setr_multi_scale and keep_ratio and crop_size is not None:
        new_short = max(min(scale), crop_size)
        h, w = img.shape[:2]
        if h > w:
            scale = (new_short * h / w, new_short)
        else:
            scale = (new_short, new_short * w / h)
    if keep_ratio:
        new_wh = rescale_size((img.shape[1], img.shape[0]), scale)
        sample["img"] = resize_channels(img, new_wh, native=native)
    else:
        sample["img"] = resize_channels(img, scale[::-1],
                                        native=native)
    if sample.get("gt") is not None:
        if keep_ratio:
            sample["gt"] = imrescale(sample["gt"], scale, "nearest")
        else:
            sample["gt"] = imresize(sample["gt"], scale[::-1], "nearest")
    sample.setdefault("meta", {})["img_shape"] = sample["img"].shape
    return sample


def normalize_multimodal(sample: Dict, modalities_ch: Sequence[int],
                         means: Sequence[Sequence[float]],
                         stds: Sequence[Sequence[float]],
                         to_rgb: Sequence[bool], norm_by_max: bool = False,
                         norm_by_max_rgb_only: bool = False) -> Dict:
    """Per-modality (x[/255] - mean) / std with an optional BGR->RGB flip.
    norm_by_max_rgb_only=True is the MUSES variant (only the RGB slice is
    divided by 255)."""
    out = sample["img"].copy()
    start = 0
    for i, ch in enumerate(modalities_ch):
        sl = out[..., start: start + ch]
        if norm_by_max and (i == 0 or not norm_by_max_rgb_only):
            sl = sl / 255.0
        if to_rgb[i] and ch == 3:
            sl = sl[..., ::-1]
        mean = np.asarray(means[i], np.float32)
        std = np.asarray(stds[i], np.float32)
        out[..., start: start + ch] = (sl - mean) / std
        start += ch
    sample["img"] = out
    return sample


def pad_to_size(sample: Dict, size: Tuple[int, int], pad_val: float = 0.0,
                seg_pad_val: int = 255) -> Dict:
    """Pad bottom/right to (h, w)."""
    img = sample["img"]
    ph = max(size[0] - img.shape[0], 0)
    pw = max(size[1] - img.shape[1], 0)
    if ph or pw:
        sample["img"] = np.pad(img, ((0, ph), (0, pw), (0, 0)),
                               constant_values=pad_val)
        if sample.get("gt") is not None:
            sample["gt"] = np.pad(sample["gt"], ((0, ph), (0, pw)),
                                  constant_values=seg_pad_val)
    sample.setdefault("meta", {})["pad_shape"] = sample["img"].shape
    return sample


def _normalize_stats(modalities_ch, n: dict):
    """Per-modality (means, stds, to_rgb) from a config's `normalize`
    block; n['aux'] is one stats dict or a list, one per aux modality."""
    aux = n["aux"]
    aux_list = (list(aux) if isinstance(aux, (list, tuple))
                else [aux for _ in modalities_ch[1:]])
    means = [n["rgb"]["mean"]] + [a["mean"] for a in aux_list]
    stds = [n["rgb"]["std"]] + [a["std"] for a in aux_list]
    to_rgb = list(n.get("to_rgb", (True,) * len(modalities_ch)))
    return means, stds, to_rgb


class TestPipeline:
    """Deterministic eval pipeline: resize (keep_ratio), pad (FMB pads
    before normalising), normalise, then an optional pad."""

    def __init__(self, cfg: dict, modalities_ch=(3, 3), pad_size=None):
        self.cfg = cfg
        self.modalities_ch = tuple(modalities_ch)
        self.pad_size = pad_size

    def __call__(self, sample: Dict, scale_ratio: float = 1.0) -> Dict:
        """scale_ratio != 1 is the reference's MultiScaleFlipAug img_ratios
        (--aug-test): the test img_scale times the ratio."""
        c = self.cfg
        sample.setdefault("meta", {})["ori_shape"] = sample["img"].shape
        if c.get("resize"):
            scale = c["resize"]["img_scale"]
            if scale_ratio != 1.0:
                scale = (int(scale[0] * scale_ratio),
                         int(scale[1] * scale_ratio))
            sample = resize_multimodal(
                sample, scale, keep_ratio=c["resize"].get("keep_ratio", True),
                seg_scale=c["resize"].get("seg_scale"))
        elif scale_ratio != 1.0:
            H, W = sample["img"].shape[:2]
            sample = resize_multimodal(
                sample, (int(W * scale_ratio), int(H * scale_ratio)),
                keep_ratio=True)
        if c.get("pad"):
            sample = pad_to_size(sample, c["pad"]["size"])
        n = c["normalize"]
        means, stds, to_rgb = _normalize_stats(self.modalities_ch, n)
        sample = normalize_multimodal(
            sample, self.modalities_ch, means, stds, to_rgb,
            bool(n["norm_by_max"]), bool(n.get("rgb_only_255", False)))
        if self.pad_size is not None:
            sample = pad_to_size(sample, self.pad_size)
        return sample


# ---------------------------------------------------------------------------
# train-time transforms
# ---------------------------------------------------------------------------

def resize_bilinear_hwc(img: np.ndarray, size_wh: Tuple[int, int],
                        native: bool = True) -> np.ndarray:
    """(H, W, C) image -> (h, w, C) float32: the JAX package's
    `_resize_multichannel` (cv2 INTER_LINEAR in chunks of 4 channels), bit
    for bit; `native=False` resizes with data/resize.py's numpy twin."""
    return resize_channels(np.asarray(img, np.float32), size_wh,
                           native=native)


def random_scale_resize(sample: Dict, rng: np.random.Generator, img_scale,
                        ratio_range=(0.5, 2.0), native: bool = True) -> Dict:
    """Train-time random-ratio resize (keep_ratio)."""
    ratio = rng.uniform(*ratio_range)
    base = (int(img_scale[0] * ratio), int(img_scale[1] * ratio))
    img = sample["img"]
    new_wh = rescale_size((img.shape[1], img.shape[0]), base)
    sample["img"] = resize_bilinear_hwc(img, new_wh, native)
    if sample.get("gt") is not None:
        sample["gt"] = resize_nearest(sample["gt"], new_wh)
    return sample


def random_crop(sample: Dict, rng: np.random.Generator,
                crop_size: Tuple[int, int], cat_max_ratio: float = 1.0,
                ignore_index: int = 255,
                retry_multilabel: bool = False) -> Dict:
    """(h, w) crop with the cat_max_ratio re-crop loop (up to 10 tries).
    retry_multilabel=True is the reference's RandomCropGen: re-crop rounds
    go on until the crop holds >= 2 labels (at most 100 rounds)."""
    img = sample["img"]
    ch, cw = crop_size

    def get_bbox():
        mh = max(img.shape[0] - ch, 0)
        mw = max(img.shape[1] - cw, 0)
        y = rng.integers(0, mh + 1)
        x = rng.integers(0, mw + 1)
        return y, y + ch, x, x + cw

    y1, y2, x1, x2 = get_bbox()
    if sample.get("gt") is not None and cat_max_ratio < 1.0:
        for _ in range(100 if retry_multilabel else 1):
            labels = np.empty(0)
            for try_ in range(10):
                gt = sample["gt"][y1:y2, x1:x2]
                labels, counts = np.unique(gt, return_counts=True)
                counts = counts[labels != ignore_index]
                if (len(counts) > 1
                        and counts.max() / counts.sum() < cat_max_ratio):
                    break
                # mmseg's RandomCrop draws a new box after every failure,
                # the 10th too (the crop kept is then unevaluated);
                # RandomCropGen keeps the last evaluated box
                if try_ < 9 or not retry_multilabel:
                    y1, y2, x1, x2 = get_bbox()
            else:
                if retry_multilabel and len(labels) < 2:
                    y1, y2, x1, x2 = get_bbox()
                    continue
            break
    sample["img"] = img[y1:y2, x1:x2]
    if sample.get("gt") is not None:
        sample["gt"] = sample["gt"][y1:y2, x1:x2]
    return sample


def random_flip(sample: Dict, rng: np.random.Generator,
                prob: float = 0.5) -> Dict:
    if rng.random() < prob:
        sample["img"] = np.ascontiguousarray(sample["img"][:, ::-1])
        if sample.get("gt") is not None:
            sample["gt"] = np.ascontiguousarray(sample["gt"][:, ::-1])
    return sample


def _imtranslate(img: np.ndarray, dx: float, dy: float, border_value,
                 interpolation: str = "bilinear") -> np.ndarray:
    """mmcv.imtranslate: data/warp.py's cv2.warpAffine, constant border,
    an (H, W, 1) image kept 3-D."""
    out = translate(img, dx, dy, border_value, interpolation)
    return out[:, :, None] if img.ndim == 3 and out.ndim == 2 else out


def shift(sample: Dict, rng: np.random.Generator, x_trans: float,
          y_trans: float, prob: float = 0.5, pad_val: float = 0,
          seg_pad_val: int = 0) -> Dict:
    """Random translation (the reference's Shift) by uniform draws in
    [-x_trans, x_trans] and [-y_trans, y_trans]: the image bilinear in
    chunks of 4 channels, the labels nearest (the reference passed
    bilinear for label maps, which mixes labels; the JAX package does not
    replicate that, nor does the port)."""
    if rng.random() < prob:
        dx = rng.uniform(-1, 1) * x_trans
        dy = rng.uniform(-1, 1) * y_trans
        img = sample["img"]
        if img.shape[2] > 4:
            img = np.concatenate([
                _imtranslate(img[..., s:s + 4], dx, dy, pad_val)
                for s in range(0, img.shape[2], 4)], axis=2)
        else:
            img = _imtranslate(img, dx, dy, pad_val)
        sample["img"] = img
        if sample.get("gt") is not None:
            sample["gt"] = _imtranslate(sample["gt"], dx, dy, seg_pad_val,
                                        "nearest")
    return sample


# OpenCV's 8-bit BGR2HSV: saturation and hue by fixed-point tables
_HSV_SHIFT = 12
_LEVELS = np.arange(256, dtype=np.float64)
_SDIV = np.where(_LEVELS > 0, np.round((255 << _HSV_SHIFT)
                                       / np.maximum(_LEVELS, 1)),
                 0).astype(np.int64)
_HDIV180 = np.where(_LEVELS > 0, np.round((180 << _HSV_SHIFT)
                                          / (6.0 * np.maximum(_LEVELS, 1))),
                    0).astype(np.int64)
# HSV2BGR: which of (v, p, q, t) each of b, g, r takes, by hue sector
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                     [2, 1, 0]])
# pixels a SIMD block of OpenCV's HSV2BGR takes (its AVX2 build)
_CV_SIMD_PIXELS = 32


def bgr_to_hsv_u8(bgr: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(uint8 BGR, COLOR_BGR2HSV): H in [0, 180), S, V."""
    x = bgr.astype(np.int64)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV180[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


def _fma32(a, b, c):
    """float32 a * b + c rounded once (a fused multiply-add): the float64
    product of two float32 values is exact."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def hsv_to_bgr_u8(hsv: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(uint8 HSV, COLOR_HSV2BGR) for H in [0, 180): S and V
    scaled to [0, 1] in float32, the sector values v (1 - s), v fma(-s, f,
    1), v fma(-s, 1 - f, 1), and each channel x * 255 cast to uint8 by
    truncation in each row's whole SIMD blocks, by rounding in its tail."""
    f32 = np.float32
    one = f32(1)
    h = hsv[..., 0].astype(f32) * f32(6.0 / 180.0)
    s = hsv[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = hsv[..., 2].astype(f32) * f32(1.0 / 255.0)
    h = np.where(h >= 6, h - f32(6), h)
    sector = np.floor(h).astype(np.int64)
    f = h - sector.astype(f32)
    tab = np.stack([v, v * (one - s), v * _fma32(-s, f, one),
                    v * _fma32(-s, one - f, one)], -1)
    out = np.take_along_axis(tab, _SECTORS[sector], -1)
    out = np.where((s == 0)[..., None], v[..., None], out) * f32(255)
    width = out.shape[-2]
    simd = np.arange(width) < width // _CV_SIMD_PIXELS * _CV_SIMD_PIXELS
    out = np.where(simd[:, None], np.trunc(out), np.rint(out))
    return np.clip(out, 0, 255).astype(np.uint8)


def photometric_distortion(sample: Dict, rng: np.random.Generator,
                           brightness_delta: float = 32,
                           contrast_range=(0.5, 1.5),
                           saturation_range=(0.5, 1.5), hue_delta: int = 18,
                           rgb_ch: int = 3) -> Dict:
    """mmseg's PhotoMetricDistortion on the first `rgb_ch` channels."""
    img = sample["img"]
    rgb = img[..., :rgb_ch].copy()

    def convert(x, alpha=1.0, beta=0.0):
        return np.clip(x.astype(np.float32) * alpha + beta, 0, 255)

    if rng.integers(2):
        rgb = convert(rgb, beta=rng.uniform(-brightness_delta,
                                            brightness_delta))
    contrast_first = rng.integers(2)
    if contrast_first and rng.integers(2):
        rgb = convert(rgb, alpha=rng.uniform(*contrast_range))
    if rng.integers(2):
        hsv = bgr_to_hsv_u8(rgb.astype(np.uint8)).astype(np.float32)
        hsv[..., 1] = np.clip(hsv[..., 1] * rng.uniform(*saturation_range),
                              0, 255)
        rgb = hsv_to_bgr_u8(hsv.astype(np.uint8)).astype(np.float32)
    if rng.integers(2):
        hsv = bgr_to_hsv_u8(rgb.astype(np.uint8)).astype(np.int32)
        hsv[..., 0] = (hsv[..., 0] + rng.integers(-hue_delta, hue_delta)) % 180
        rgb = hsv_to_bgr_u8(hsv.astype(np.uint8)).astype(np.float32)
    if (not contrast_first) and rng.integers(2):
        rgb = convert(rgb, alpha=rng.uniform(*contrast_range))

    img = img.copy()
    img[..., :rgb_ch] = rgb
    sample["img"] = img
    return sample


def gaussian_blur3(x: np.ndarray) -> np.ndarray:
    """cv2.GaussianBlur(x, (3, 3), 0) on an (H, W, C) float image: the
    separable [1/4, 1/2, 1/4], BORDER_REFLECT_101."""
    f32 = np.float32
    p = np.pad(x.astype(f32), ((0, 0), (1, 1), (0, 0)), mode="reflect")
    r = f32(0.25) * p[:, :-2] + f32(0.5) * p[:, 1:-1] + f32(0.25) * p[:, 2:]
    p = np.pad(r, ((1, 1), (0, 0), (0, 0)), mode="reflect")
    return f32(0.25) * p[:-2] + f32(0.5) * p[1:-1] + f32(0.25) * p[2:]


def random_gaussian_blur(sample: Dict, rng: np.random.Generator,
                         kernel_size: int = 3, p: float = 0.2,
                         rgb_ch: int = 3) -> Dict:
    if rng.random() < p:
        if kernel_size != 3:
            raise NotImplementedError(
                f"Gaussian blur of size {kernel_size}: only 3 is ported")
        img = sample["img"].copy()
        img[..., :rgb_ch] = gaussian_blur3(img[..., :rgb_ch])
        sample["img"] = img
    return sample


def normalize_then_pad(sample: Dict, modalities_ch, n: dict, pad_size=None,
                       pad_val: float = 0.0, seg_pad_val: int = 255,
                       native: bool = True) -> Dict:
    """Normalise then pad. Two 3-channel modalities (every bimodal config)
    go through the fused core of data/native.py (`native`) or its bit-equal
    numpy twin, one pass over the image; other layouts through
    `normalize_multimodal` and `pad_to_size`, as the JAX package does."""
    means, stds, to_rgb = _normalize_stats(modalities_ch, n)
    norm_by_max = bool(n["norm_by_max"])
    rgb_only = bool(n.get("rgb_only_255", False))
    img = sample["img"]
    fusable = (len(modalities_ch) == 2
               and all(c == 3 for c in modalities_ch)
               and img.ndim == 3 and img.shape[2] == sum(modalities_ch))
    if not fusable:
        sample = normalize_multimodal(sample, modalities_ch, means, stds,
                                      to_rgb, norm_by_max, rgb_only)
        if pad_size is not None:
            sample = pad_to_size(sample, pad_size, pad_val, seg_pad_val)
        return sample
    out_hw = (img.shape[0], img.shape[1]) if pad_size is None else (
        max(pad_size[0], img.shape[0]), max(pad_size[1], img.shape[1]))
    div255 = [norm_by_max and (i == 0 or not rgb_only)
              for i in range(len(modalities_ch))]
    norm = (_native.normalize_pad_native if native
            else _native.normalize_pad_numpy)
    sample["img"] = norm(img, modalities_ch, means, stds, to_rgb, div255,
                         out_hw, pad_val)
    gt = sample.get("gt")
    if gt is not None and gt.shape[:2] != out_hw:
        pad = _native.pad_label_native if native else _native.pad_label_numpy
        sample["gt"] = pad(gt, out_hw, seg_pad_val)
    sample.setdefault("meta", {})["pad_shape"] = sample["img"].shape
    return sample


class TrainPipeline:
    """The reference's train pipeline for all three datasets: blur,
    random-ratio resize, crop, flip, photometric distortion, normalise and
    pad. `native=False` resizes and normalises in numpy (bit-equal)
    instead of the native core. The sample dict passed in is left as it
    was."""

    def __init__(self, cfg: dict, modalities_ch=(3, 3), native: bool = True):
        self.cfg = cfg
        self.modalities_ch = tuple(modalities_ch)
        self.native = native

    def __call__(self, sample: Dict, rng: np.random.Generator) -> Dict:
        c = self.cfg
        sample = dict(sample)
        if "meta" in sample:
            sample["meta"] = dict(sample["meta"])
        if c.get("gaussian_blur"):
            sample = random_gaussian_blur(
                sample, rng, c["gaussian_blur"]["kernel_size"],
                c["gaussian_blur"]["p"])
        sample = random_scale_resize(sample, rng, c["resize"]["img_scale"],
                                     c["resize"]["ratio_range"], self.native)
        sample = random_crop(sample, rng, c["crop"]["crop_size"],
                             c["crop"]["cat_max_ratio"])
        sample = random_flip(sample, rng, c["flip"]["prob"])
        if c.get("photometric"):
            sample = photometric_distortion(sample, rng)
        return normalize_then_pad(
            sample, self.modalities_ch, c["normalize"],
            pad_size=c["pad"]["size"], pad_val=c["pad"]["pad_val"],
            seg_pad_val=c["pad"]["seg_pad_val"], native=self.native)
