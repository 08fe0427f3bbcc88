"""`cv2.resize` without OpenCV: the resizes of the test and train
pipelines and of `engine/visualize.py`, equal to the OpenCV build the JAX
package reads with (opencv-python 5.0 with its IPP, ippicv 2026.0) bit for
bit, which tests/test_torch_image_io.py holds.

`resize(img, (w, h), interpolation)` takes an (H, W) or (H, W, C) array:

- `"nearest"`, any dtype: OpenCV's INTER_NEAREST index rule,
  src = min(floor(dst * (1 / (dst_size / src_size))), src_size - 1).
- `"bilinear"` on float32 (INTER_LINEAR). OpenCV hands 1, 3 and 4 channels
  with both source sides of at least 2 pixels to IPP's linear resize:
  source coordinates (d + 0.5) * (src / dst) - 0.5 in float64, the
  fraction rounded to float32, replicated borders; a horizontal pass
  fma(s1 - s0, wx, s0), then a vertical pass fma(h1 - h0, wy, h0) with one
  exception: in the replicated border strips IPP's own blocking takes the
  vertical step unfused, h0 + (h1 - h0) * wy, in whole 16-pixel blocks of
  a strip for 4 channels and, in a strip's remainder of more than 4
  pixels, in every channel for 4 channels and in the first two for 3
  (`_unfused_in_strips`). Other layouts take OpenCV's own code: float32
  coordinates (float)((d + 0.5) * scale - 0.5), the weights 1 - f and f,
  the horizontal pass s0 * a0 + s1 * a1 into float32 rows (the border
  columns clamped to weight 0), the vertical pass h0 * b0 + h1 * b1 with
  the rows clamped and the weights not; at an exact 2x downscale its
  INTER_AREA, (((a + b) + c) + d) * 0.25.
- `"bilinear"` on uint8 (OpenCV's own; IPP is not exact there, so OpenCV
  does not call it): 11-bit weights cvRound(w * 2048), the horizontal pass
  in int, the vertical pass as its SIMD code computes every element here,
  (((h0 >> 4) * b0) >> 16) + (((h1 >> 4) * b1) >> 16) + 2 >> 2 saturated;
  at an exact 2x, (a + b + c + d + 2) >> 2 for 1, 3 and 4 channels and
  cvRound((a + b + c + d) * 0.25) otherwise.
- The same size is a copy.

The float32 passes run in the host core (csrc/host/image_core.cpp, built
by data/native.py; `native=False` runs the numpy twin, bit-equal to it).
`resize_channels` resizes more than 4 channels in chunks of at most 4, as
the JAX package's pipelines call OpenCV.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from . import native as _native

_F32 = np.float32
# IPP's blocking of a border strip: whole blocks of 16 pixels, then a
# remainder taken fused when it is at most 4 pixels
_STRIP_BLOCK = 16
_STRIP_FUSED_REMAINDER = 4


def fma32(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once. The float64 product of two float32
    values is exact; the float64 sum's own rounding error (TwoSum) settles
    the float32 ties that rounding twice would break the wrong way."""
    a, b, c = (np.asarray(v, _F32).astype(np.float64) for v in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    r = s.astype(_F32)
    r64 = r.astype(np.float64)
    nb = np.nextafter(r, np.where(s > r64, _F32(np.inf), _F32(-np.inf)))
    tie = (s != r64) & (s - r64 == nb.astype(np.float64) - s) & (err != 0)
    return np.where(tie & ((err > 0) == (s > r64)), nb, r)


# ---------------------------------------------------------------------------
# coefficients
# ---------------------------------------------------------------------------

def _ipp_taps(src: int, dst: int):
    """IPP: per output index the two source indices (clamped), the float32
    fraction and the float64 coordinate."""
    x = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    i = np.floor(x).astype(np.int64)
    f = (x - i).astype(_F32)
    return (np.clip(i, 0, src - 1).astype(np.int32),
            np.clip(i + 1, 0, src - 1).astype(np.int32), f, x)


def _cv_taps(src: int, dst: int, clamp_weights: bool):
    """OpenCV's own: per output index the two source indices (clamped) and
    the float32 weights (1 - f, f); columns past the border take weight 0
    (`clamp_weights`), rows keep theirs."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(_F32)
    i = np.floor(f).astype(np.int64)
    f = (f - i.astype(_F32)).astype(_F32)
    if clamp_weights:
        out = (i < 0) | (i >= src - 1)
        f[out] = 0
        i = np.clip(i, 0, src - 1)
    return (np.clip(i, 0, src - 1).astype(np.int32),
            np.clip(i + 1, 0, src - 1).astype(np.int32), _F32(1) - f, f)


def _unfused_in_strips(x: np.ndarray, src: int, cn: int) -> np.ndarray:
    """(dst, cn) True where IPP takes the vertical step unfused: in the left
    (x < 0) and right (x >= src - 1) border strips, by its blocking."""
    mask = np.zeros((len(x), cn), bool)
    for strip in (np.flatnonzero(x < 0), np.flatnonzero(x >= src - 1)):
        whole = len(strip) // _STRIP_BLOCK * _STRIP_BLOCK
        if cn == 4:
            mask[strip[:whole]] = True
        if len(strip) - whole > _STRIP_FUSED_REMAINDER:
            rest = strip[whole:]
            if cn == 4:
                mask[rest] = True
            elif cn == 3:
                mask[rest, :2] = True
    return mask


def _plan_f32(sh: int, sw: int, dh: int, dw: int, cn: int):
    """The float32 INTER_LINEAR plan: (mode, x taps, y taps, fused flags)
    for the two-pass kernel, or None for the 2x INTER_AREA."""
    if cn in (1, 3, 4) and min(sh, sw) >= 2:
        x0, x1, wx, x = _ipp_taps(sw, dw)
        y0, y1, wy, _ = _ipp_taps(sh, dh)
        fused = ~_unfused_in_strips(x, sw, cn)
        return (1, (x0, x1, np.zeros_like(wx), wx),
                (y0, y1, np.zeros_like(wy), wy), fused)
    if sw == 2 * dw and sh == 2 * dh:
        return None
    return (0, _cv_taps(sw, dw, True), _cv_taps(sh, dh, False),
            np.ones((dw, cn), bool))


# ---------------------------------------------------------------------------
# the two passes: host core and numpy twin
# ---------------------------------------------------------------------------

def _two_pass_numpy(src, mode, xt, yt, fused):
    """(sh, sw, cn) float32 -> (dh, dw, cn), the arithmetic of
    msa_resize_f32."""
    x0, x1, a0, a1 = xt
    y0, y1, b0, b1 = yt
    p0, p1 = src[:, x0], src[:, x1]
    if mode == 0:
        h = p0 * a0[None, :, None] + p1 * a1[None, :, None]
        h0, h1 = h[y0], h[y1]
        return h0 * b0[:, None, None] + h1 * b1[:, None, None]
    h = fma32(p1 - p0, a1[None, :, None], p0)
    h0, h1 = h[y0], h[y1]
    d = h1 - h0
    wy = np.broadcast_to(b1[:, None, None], d.shape)
    return np.where(fused[None], fma32(d, wy, h0), h0 + d * wy)


def _two_pass_native(img, c0, cn, dh, dw, mode, xt, yt, fused, out):
    """Channels c0:c0 + cn of the contiguous (sh, sw, C) float32 `img` into
    the same channels of `out` (dh, dw, C)."""
    lib = _native.load_native()
    _, sw, C = img.shape
    fp, ip = _native._FP, _native._IP
    x0, x1, a0, a1 = (np.ascontiguousarray(t) for t in xt)
    y0, y1, b0, b1 = (np.ascontiguousarray(t) for t in yt)
    flags = np.ascontiguousarray(fused, np.uint8)
    lib.msa_resize_f32(
        img[..., c0:].ctypes.data_as(fp), sw, C,
        out[..., c0:].ctypes.data_as(fp), dh, dw, C, cn,
        x0.ctypes.data_as(ip), x1.ctypes.data_as(ip),
        a0.ctypes.data_as(fp), a1.ctypes.data_as(fp),
        y0.ctypes.data_as(ip), y1.ctypes.data_as(ip),
        b0.ctypes.data_as(fp), b1.ctypes.data_as(fp),
        flags.ctypes.data_as(_native._U8P), mode)


def _area2(x: np.ndarray) -> np.ndarray:
    """OpenCV's INTER_AREA at an exact 2x on float32, scalar order."""
    return (((x[0::2, 0::2] + x[0::2, 1::2]) + x[1::2, 0::2])
            + x[1::2, 1::2]) * _F32(0.25)


def _linear_f32(img: np.ndarray, dw: int, dh: int, native: bool,
                chunk: int) -> np.ndarray:
    """(sh, sw, C) float32, C resized as chunks of at most `chunk`."""
    sh, sw, C = img.shape
    img = np.ascontiguousarray(img, _F32)
    out = np.empty((dh, dw, C), _F32)
    for c0 in range(0, C, chunk):
        cn = min(chunk, C - c0)
        plan = _plan_f32(sh, sw, dh, dw, cn)
        if plan is None:
            out[..., c0:c0 + cn] = _area2(img[..., c0:c0 + cn])
        elif native:
            _two_pass_native(img, c0, cn, dh, dw, *plan, out)
        else:
            out[..., c0:c0 + cn] = _two_pass_numpy(img[..., c0:c0 + cn],
                                                   *plan)
    return out


# ---------------------------------------------------------------------------
# uint8 and nearest (numpy: integer arithmetic)
# ---------------------------------------------------------------------------

def _fixed_point(w: np.ndarray) -> np.ndarray:
    """saturate_cast<short>(w * 2048): float32 product, rounded half to
    even."""
    return np.rint((w * _F32(2048)).astype(np.float64)).astype(np.int64)


def _linear_u8(img: np.ndarray, dw: int, dh: int) -> np.ndarray:
    sh, sw, cn = img.shape
    x = img.astype(np.int64)
    if sw == 2 * dw and sh == 2 * dh:
        s = x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]
        if cn in (1, 3, 4):
            return ((s + 2) >> 2).astype(np.uint8)
        return np.rint(s * 0.25).astype(np.uint8)
    x0, x1, a0, a1 = _cv_taps(sw, dw, True)
    y0, y1, b0, b1 = _cv_taps(sh, dh, False)
    h = (x[:, x0] * _fixed_point(a0)[None, :, None]
         + x[:, x1] * _fixed_point(a1)[None, :, None])
    v = (((h[y0] >> 4) * _fixed_point(b0)[:, None, None]) >> 16) + (
        ((h[y1] >> 4) * _fixed_point(b1)[:, None, None]) >> 16)
    v = np.clip(v, -32768, 32767)
    return np.clip((v + 2) >> 2, 0, 255).astype(np.uint8)


def _nearest_index(src: int, dst: int) -> np.ndarray:
    return np.minimum(np.floor(np.arange(dst) * (1.0 / (dst / src))),
                      src - 1).astype(np.int64)


def resize_nearest(img: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, size_wh, interpolation=INTER_NEAREST)."""
    w, h = size_wh
    return img[_nearest_index(img.shape[0], h)[:, None],
               _nearest_index(img.shape[1], w)[None, :]]


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def resize(img: np.ndarray, size_wh: Tuple[int, int],
           interpolation: str = "bilinear", native: bool = True
           ) -> np.ndarray:
    """cv2.resize(img, size_wh, interpolation=...) for "nearest" (any
    dtype) and "bilinear" (float32 or uint8). One channel, (H, W) or
    (H, W, 1), gives an (H', W') output, as OpenCV does."""
    w, h = int(size_wh[0]), int(size_wh[1])
    if w <= 0 or h <= 0:
        raise ValueError(f"resize to {size_wh}: sides must be positive")
    if interpolation not in ("nearest", "bilinear"):
        raise ValueError(f"interpolation {interpolation!r}: only 'nearest' "
                         f"and 'bilinear' are ported")
    x = img[..., None] if img.ndim == 2 else img
    if interpolation == "nearest":
        out = resize_nearest(x, (w, h))
    elif x.shape[:2] == (h, w):
        out = x.copy()
    elif img.dtype == np.float32:
        out = _linear_f32(x, w, h, native, chunk=x.shape[2])
    elif img.dtype == np.uint8:
        out = _linear_u8(x, w, h)
    else:
        raise TypeError(f"bilinear resize of {img.dtype}: float32 and uint8 "
                        f"are ported")
    return out[..., 0] if out.shape[2] == 1 else out


def resize_channels(img: np.ndarray, size_wh: Tuple[int, int],
                    interpolation: str = "bilinear", native: bool = True
                    ) -> np.ndarray:
    """An (H, W, C) image resized in chunks of at most 4 channels (OpenCV
    resizes at most 4 at once in the JAX package's pipelines); keeps the
    channel axis for C == 1."""
    w, h = int(size_wh[0]), int(size_wh[1])
    if (interpolation == "bilinear" and img.dtype == np.float32
            and img.shape[:2] != (h, w)):
        return _linear_f32(img, w, h, native, chunk=4)
    chunks = [resize(img[..., s:s + 4], (w, h), interpolation, native)
              for s in range(0, img.shape[2], 4)]
    chunks = [c[..., None] if c.ndim == 2 else c for c in chunks]
    return chunks[0] if len(chunks) == 1 else np.concatenate(chunks, axis=2)
