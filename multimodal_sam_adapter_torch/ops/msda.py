"""Multi-scale deformable attention module: the counterpart of
multimodal_sam_adapter_tpu/ops/msda.py:MSDeformAttention.

Query-conditioned sampling offsets and attention weights, a `ratio`-shrunk
value projection, and the sampling core of ops/msda_cuda.py (the K3/K4
kernel on the card, grid_sample on the CPU).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .msda_cuda import ms_deform_attn


def msda_directional_bias_init(n_heads: int, n_levels: int,
                               n_points: int) -> np.ndarray:
    """Directional grid init of the sampling-offset bias: head h points at
    compass direction 2*pi*h/n_heads, point p sits (p + 1) steps out."""
    thetas = np.arange(n_heads, dtype=np.float64) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], axis=-1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for p in range(n_points):
        grid[:, :, p, :] *= p + 1
    return grid.reshape(-1).astype(np.float32)


class MSDeformAttention(nn.Module):
    def __init__(self, d_model: int, n_levels: int = 4, n_heads: int = 8,
                 n_points: int = 4, ratio: float = 1.0):
        super().__init__()
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, n_points
        d_value = int(d_model * ratio)
        self.sampling_offsets = nn.Linear(d_model,
                                          n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model,
                                           n_heads * n_levels * n_points)
        self.value_proj = nn.Linear(d_model, d_value)
        self.output_proj = nn.Linear(d_value, d_model)

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor,
                input_flatten: torch.Tensor,
                spatial_shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """query (B, Lq, C); reference_points (B or 1, Lq, n_levels, 2) in
        [0, 1] as (x, y); input_flatten (B, S, C), S = sum(H_l * W_l).
        Returns (B, Lq, C)."""
        value = self.value_proj(input_flatten)
        out = ms_deform_attn(value, spatial_shapes, reference_points,
                             self.sampling_offsets(query),
                             self.attention_weights(query), self.n_heads,
                             self.n_points)
        return self.output_proj(out)
