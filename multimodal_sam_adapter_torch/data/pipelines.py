"""Host-side test pipeline (numpy + OpenCV), the port's own copy of the
test-time part of multimodal_sam_adapter_tpu/data/pipelines.py.

A sample is a dict
  {'img': (H, W, C) float32 (OpenCV BGR channel order, like the reference),
   'gt': (H, W) uint8 or None, 'meta': {...}}

What is here: the multimodal image and annotation loaders, the mmcv-style
deterministic resize, the per-modality normalisation, the bottom/right pad
and `TestPipeline`, which composes them. The training transforms wait for
the training slice. OpenCV is imported inside the functions that read or
resize images, so importing this module does not need it. Normalise and pad
run in numpy (the JAX package may fuse them in its native core, within
1e-5 of the numpy path).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def _cv2():
    import cv2

    return cv2


# ---------------------------------------------------------------------------
# mmcv-compatible resize helpers
# ---------------------------------------------------------------------------

def imresize(img: np.ndarray, size_wh: Tuple[int, int],
             interpolation: str = "bilinear") -> np.ndarray:
    """mmcv.imresize: size is (w, h)."""
    cv2 = _cv2()
    flags = {"nearest": cv2.INTER_NEAREST, "bilinear": cv2.INTER_LINEAR,
             "bicubic": cv2.INTER_CUBIC}[interpolation]
    return cv2.resize(img, size_wh, interpolation=flags)


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


def _resize_multichannel(img: np.ndarray, size_wh, interpolation="bilinear"):
    """OpenCV resizes at most 4 channels at once: resize in chunks of 4."""
    chunks = []
    for s in range(0, img.shape[2], 4):
        o = imresize(img[..., s: s + 4], size_wh, interpolation)
        chunks.append(o[..., None] if o.ndim == 2 else o)
    return chunks[0] if len(chunks) == 1 else np.concatenate(chunks, axis=2)


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------

def load_multimodal_image(img_path: str, mod_paths: Sequence[str],
                          mod_channels: Sequence[int]) -> np.ndarray:
    """RGB image (OpenCV color, BGR) + aux modalities concatenated along
    channels. 1-channel aux image files are tiled to 3 channels; a .npz aux
    (MUSES) loads 'arr_0' and expands a 2-D map to one channel."""
    cv2 = _cv2()
    parts = [cv2.imread(img_path, cv2.IMREAD_COLOR).astype(np.float32)]
    for path, ch in zip(mod_paths, mod_channels):
        if path.endswith(".npz"):
            with np.load(path) as z:
                m = z["arr_0"] if "arr_0" in z else z[list(z.keys())[0]]
            m = np.asarray(m, np.float32)
        elif ch == 1:
            m = cv2.imread(path, cv2.IMREAD_UNCHANGED)
            m = np.tile(np.asarray(m, np.float32)[:, :, None], (1, 1, 3))
        else:
            m = cv2.imread(path, cv2.IMREAD_COLOR).astype(np.float32)
        if m.ndim == 2:
            m = m[:, :, None]
        parts.append(m.astype(np.float32))
    return np.concatenate(parts, axis=2)


def load_annotation(path: str, reduce_zero_label: bool = False) -> np.ndarray:
    cv2 = _cv2()
    gt = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if gt.ndim == 3:
        gt = gt[:, :, 0]
    gt = gt.astype(np.int32)
    if reduce_zero_label:
        # overflow-safe reduce-zero: 0 -> 255 (ignored), k -> k - 1
        gt[gt == 0] = 256
        gt = gt - 1
    return np.clip(gt, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# deterministic transforms
# ---------------------------------------------------------------------------

def resize_multimodal(sample: Dict, img_scale, keep_ratio: bool = True,
                      seg_scale=None) -> Dict:
    """Test-time resize. img_scale is (w, h) mmcv-style."""
    img = sample["img"]
    if keep_ratio:
        new_wh = rescale_size((img.shape[1], img.shape[0]), img_scale)
        img = _resize_multichannel(img, new_wh, "bilinear")
    else:
        img = _resize_multichannel(img, img_scale, "bilinear")
    sample["img"] = img
    if sample.get("gt") is not None:
        scale = seg_scale or img_scale
        if keep_ratio:
            sample["gt"] = imrescale(sample["gt"], scale, "nearest")
        else:
            sample["gt"] = imresize(sample["gt"], scale, "nearest")
    sample.setdefault("meta", {})["img_shape"] = img.shape
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
