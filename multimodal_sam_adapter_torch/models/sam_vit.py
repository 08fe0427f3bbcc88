"""SAM ViT blocks (ViTDet style): the counterpart of
multimodal_sam_adapter_tpu/models/sam_vit.py.

Windowed blocks run K1 (ops/window_attention.py) on the windows of the
zero-padded grid; global blocks run K2 (ops/flash_attention.py) over the
whole grid. Both read the raw qkv projection and return heads-packed
output, so no head-split transpose sits around the kernels. When autograd
records, each kernel runs inside its autograd Function, whose backward is
the plain version's autodiff. The blocks have no drop path, as the JAX
package's ViTBlock has none (its only drop path in the stages is the
extractors', models/adapter.py).
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..nn.layers import MLPBlock
from ..ops.attention import window_partition, window_unpartition
from ..ops.flash_attention import flash_attention
from ..ops.window_attention import window_attention


class PatchEmbed(nn.Module):
    """16x16 patch embedding: NCHW image -> tokens (B, Hp*Wp, C), Hp, Wp."""

    def __init__(self, in_chans: int = 3, embed_dim: int = 1024,
                 patch_size: int = 16):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, patch_size)

    def forward(self, x: torch.Tensor):
        x = self.proj(x)
        _, _, Hp, Wp = x.shape
        return x.flatten(2).transpose(1, 2), Hp, Wp


class ViTAttention(nn.Module):
    """Multi-head attention with the decomposed rel-pos bias.

    input_size fixes the rel-pos tables: (ws, ws) for a windowed block, the
    pretraining grid for a global one (resized on the fly to other grids).
    """

    def __init__(self, dim: int, num_heads: int, input_size: Tuple[int, int],
                 windowed: bool):
        super().__init__()
        self.num_heads = num_heads
        self.windowed = windowed
        head_dim = dim // num_heads
        self.scale = head_dim ** -0.5
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1,
                                                  head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1,
                                                  head_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C), B folding the windows of a windowed block."""
        B, H, W, C = x.shape
        qkv = self.qkv(x.reshape(B, H * W, C))
        if self.windowed:
            out = window_attention(qkv, self.rel_pos_h, self.rel_pos_w, H,
                                   self.num_heads, self.scale)
        else:
            out = flash_attention(qkv, self.rel_pos_h, self.rel_pos_w, (H, W),
                                  self.num_heads, self.scale)
        return self.proj(out).view(B, H, W, C)


class ViTBlock(nn.Module):
    """Pre-norm transformer block; window_size 0 means global attention."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 window_size: int = 0,
                 input_size: Tuple[int, int] = (64, 64)):
        super().__init__()
        self.window_size = window_size
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        attn_size = (window_size, window_size) if window_size else input_size
        self.attn = ViTAttention(dim, num_heads, attn_size,
                                 windowed=window_size > 0)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        """x: token stream (B, H*W, C)."""
        B, N, C = x.shape
        x = x.view(B, H, W, C)
        y = self.norm1(x)
        if self.window_size > 0:
            # zero padding comes before the qkv projection, as in SAM: the
            # padded tokens carry the qkv bias and are attended unmasked
            y, pad_hw = window_partition(y, self.window_size)
        y = self.attn(y)
        if self.window_size > 0:
            y = window_unpartition(y, self.window_size, pad_hw, (H, W))
        x = x + y
        x = x + self.mlp(self.norm2(x))
        return x.reshape(B, N, C)
