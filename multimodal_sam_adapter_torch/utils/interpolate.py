"""Interpolation with the reference's torch semantics (half-pixel sampling,
align_corners=False, no antialiasing, bicubic a = -0.75).

The counterpart of multimodal_sam_adapter_tpu/utils/interpolate.py, which
re-implements exactly these F.interpolate modes. Maps are NCHW.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, out_hw: Sequence[int]) -> torch.Tensor:
    """Bilinear resize of an NCHW map."""
    out_hw = (int(out_hw[0]), int(out_hw[1]))
    if tuple(x.shape[-2:]) == out_hw:
        return x
    return F.interpolate(x, size=out_hw, mode="bilinear", align_corners=False)


def resize_bicubic(x: torch.Tensor, out_hw: Sequence[int]) -> torch.Tensor:
    """Bicubic (a = -0.75) resize of an NCHW map."""
    out_hw = (int(out_hw[0]), int(out_hw[1]))
    if tuple(x.shape[-2:]) == out_hw:
        return x
    return F.interpolate(x, size=out_hw, mode="bicubic", align_corners=False)


def interp_linear_1d(table: torch.Tensor, new_len: int) -> torch.Tensor:
    """Linear resize along axis 0 of an (L, C) table (rel-pos tables)."""
    if table.shape[0] == new_len:
        return table
    t = F.interpolate(table.t()[None], size=int(new_len), mode="linear",
                      align_corners=False)
    return t[0].t()
