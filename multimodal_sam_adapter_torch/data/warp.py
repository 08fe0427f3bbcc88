"""`cv2.warpAffine` of a translation without OpenCV: the `shift` transform's
`mmcv.imtranslate` (data/pipelines.py), equal to the OpenCV build the JAX
package calls (opencv-python 5.0) bit for bit, which
tests/test_torch_transforms_extra.py holds.

`translate(img, dx, dy, border_value, interpolation)` is
cv2.warpAffine(img, float32 [[1, 0, dx], [0, 1, dy]], (w, h), flags,
BORDER_CONSTANT, border_value) of an (H, W) or (H, W, C <= 4) array.
OpenCV inverts the matrix in float64 (source = destination - (dx, dy),
dx and dy rounded to float32 first) and then takes one of two codes:

- 1, 3 and 4 channels: its SIMD warp kernels. The source coordinates in
  float32, x - dx and y - dy; bilinear (float32 images) as two horizontal
  lerps and a vertical one, each a fused multiply-add, fma(a, v01 - v00,
  v00), a = x - floor(x); nearest (any dtype) the corner at the
  coordinates rounded half to even. Corners outside the image read the
  border value.
- 2 channels: the remap of OpenCV's older code. Coordinates in fixed point
  from the float64 matrix (1/1024 of a pixel, rounded), then cut to 1/32
  pixel (INTER_BITS = 5) for bilinear, whose weights are the products
  (1 - i/32 or i/32) x (1 - j/32 or j/32) in float32 summed left to right
  over the corners (v00 w0 + v01 w1) + v10 w2 + v11 w3, a pixel whose four
  corners all lie outside the border value itself; nearest: the corner at
  floor(coordinate + 1/2) in that fixed point.

Bilinear takes float32 only: the pipelines translate the float32 image
bilinearly and the uint8 labels by nearest.
"""
from __future__ import annotations

import numpy as np

# OpenCV's fixed point for its remap-based warps: AB_BITS, INTER_BITS
_AB_SCALE = 1 << 10
_INTER_BITS = 5
_TAB = 1 << _INTER_BITS
_TAB_W = np.stack([np.float32(1) - np.arange(_TAB, dtype=np.float32)
                   / np.float32(_TAB),
                   np.arange(_TAB, dtype=np.float32) / np.float32(_TAB)])


def _fma32(a, b, c):
    """float32 a * b + c rounded once (the float64 product of two float32
    values is exact)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _padded(img: np.ndarray, border_value) -> np.ndarray:
    """img with a one-pixel frame of the border value: an index clipped
    to [-1, side] reads the image inside and the border outside."""
    pad = ((1, 1), (1, 1)) + ((0, 0),) * (img.ndim - 2)
    return np.pad(img, pad, constant_values=border_value)


def _corner(padded: np.ndarray, iy: np.ndarray, ix: np.ndarray):
    h, w = padded.shape[0] - 2, padded.shape[1] - 2
    return padded[np.clip(iy, -1, h)[:, None] + 1,
                  np.clip(ix, -1, w)[None, :] + 1]


def _fixed_point(side: int, shift: float, nearest: bool) -> np.ndarray:
    """OpenCV's fixed-point source coordinate of each destination index:
    cvRound(-shift * 1024) + cvRound(index * 1024) + the rounding offset,
    then >> 10 (nearest) or >> 5 (bilinear: 1/32-pixel units)."""
    base = int(np.rint(-shift * _AB_SCALE))
    base += _AB_SCALE // 2 if nearest else _AB_SCALE // _TAB // 2
    fixed = base + np.arange(side, dtype=np.int64) * _AB_SCALE
    return fixed >> (10 if nearest else 10 - _INTER_BITS)


def translate(img: np.ndarray, dx: float, dy: float, border_value=0.0,
              interpolation: str = "bilinear") -> np.ndarray:
    """cv2.warpAffine of `img` by (dx, dy), constant border (see above).
    An (H, W, 1) input comes back as (H, W), as OpenCV returns it."""
    img = np.asarray(img)
    cn = 1 if img.ndim == 2 else img.shape[2]
    if img.ndim not in (2, 3) or cn > 4:
        raise ValueError(f"translate takes (H, W) or (H, W, C <= 4), not "
                         f"{img.shape}")
    if interpolation not in ("bilinear", "nearest"):
        raise ValueError(f"interpolation {interpolation!r}")
    if interpolation == "bilinear" and img.dtype != np.float32:
        raise TypeError(f"bilinear translate takes float32, not {img.dtype}")
    if img.ndim == 3 and cn == 1:
        img = img[..., 0]
    h, w = img.shape[:2]
    dx64, dy64 = float(np.float32(dx)), float(np.float32(dy))
    padded = _padded(img, border_value)
    if cn == 2:
        return _remap(img, padded, dx64, dy64, border_value,
                      interpolation == "nearest")
    f32 = np.float32
    sx = np.arange(w, dtype=f32) + f32(-dx64)
    sy = np.arange(h, dtype=f32) + f32(-dy64)
    if interpolation == "nearest":
        return _corner(padded, np.rint(sy).astype(np.int64),
                       np.rint(sx).astype(np.int64))
    ix, iy = np.floor(sx), np.floor(sy)
    a, b = (sx - ix)[None, :], (sy - iy)[:, None]
    if img.ndim == 3:
        a, b = a[..., None], b[..., None]
    ix, iy = ix.astype(np.int64), iy.astype(np.int64)
    v00, v01 = _corner(padded, iy, ix), _corner(padded, iy, ix + 1)
    v10, v11 = _corner(padded, iy + 1, ix), _corner(padded, iy + 1, ix + 1)
    top = _fma32(a, v01 - v00, v00)
    bottom = _fma32(a, v11 - v10, v10)
    return _fma32(b, bottom - top, top)


def _remap(img, padded, dx, dy, border_value, nearest: bool) -> np.ndarray:
    """OpenCV's older fixed-point warp (2 channels)."""
    h, w = img.shape[:2]
    X = _fixed_point(w, dx, nearest)
    Y = _fixed_point(h, dy, nearest)
    if nearest:
        return _corner(padded, Y, X)
    sx, sy = X >> _INTER_BITS, Y >> _INTER_BITS
    vx, vy = _TAB_W[:, X & (_TAB - 1)], _TAB_W[:, Y & (_TAB - 1)]
    w0, w1 = vy[0][:, None] * vx[0][None, :], vy[0][:, None] * vx[1][None, :]
    w2, w3 = vy[1][:, None] * vx[0][None, :], vy[1][:, None] * vx[1][None, :]
    v00, v01 = _corner(padded, sy, sx), _corner(padded, sy, sx + 1)
    v10, v11 = _corner(padded, sy + 1, sx), _corner(padded, sy + 1, sx + 1)
    out = (((v00 * w0[..., None] + v01 * w1[..., None]) + v10 * w2[..., None])
           + v11 * w3[..., None])
    outside = ((sx >= w) | (sx + 1 < 0))[None, :] | (
        (sy >= h) | (sy + 1 < 0))[:, None]
    out[outside] = border_value
    return out
