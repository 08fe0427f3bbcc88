"""Sine positional encoding (DETR's, normalized): the counterpart of
multimodal_sam_adapter_tpu/models/mask2former/positional_encoding.py.
Computed in float32, then cast."""
from __future__ import annotations

import math

import torch


def sine_positional_encoding(h: int, w: int, num_feats: int = 128,
                             temperature: float = 10000.0,
                             normalize: bool = True,
                             scale: float = 2 * math.pi, eps: float = 1e-6,
                             dtype: torch.dtype = torch.float32,
                             device=None) -> torch.Tensor:
    """(h, w, 2 * num_feats): the y features, then the x features (the
    variant without a padding mask)."""
    f32 = dict(dtype=torch.float32, device=device)
    y = torch.arange(1, h + 1, **f32)[:, None].expand(h, w)
    x = torch.arange(1, w + 1, **f32)[None, :].expand(h, w)
    if normalize:
        y = y / (h + eps) * scale
        x = x / (w + eps) * scale
    dim_t = temperature ** (
        2 * torch.div(torch.arange(num_feats, **f32), 2,
                      rounding_mode="floor") / num_feats)

    def interleave(t):
        t = t[:, :, None] / dim_t
        return torch.stack([t[:, :, 0::2].sin(), t[:, :, 1::2].cos()],
                           dim=3).reshape(h, w, -1)

    return torch.cat([interleave(y), interleave(x)], dim=-1).to(dtype)


class SinePositionalEncoding:
    def __init__(self, num_feats: int = 128, normalize: bool = True):
        self.num_feats = num_feats
        self.normalize = normalize

    def __call__(self, h: int, w: int, dtype: torch.dtype = torch.float32,
                 device=None) -> torch.Tensor:
        return sine_positional_encoding(h, w, self.num_feats,
                                        normalize=self.normalize,
                                        dtype=dtype, device=device)
