"""ViT-Adapter interaction modules and the bimodal spatial prior module:
the counterpart of multimodal_sam_adapter_tpu/models/adapter.py.

- `Injector`: ViT tokens attend to the pyramid (3-level MSDA, K3) and add
  the result scaled by gamma;
- `Extractor`: pyramid tokens attend to the ViT grid (1-level MSDA, K4),
  then a ConvFFN with a multi-scale depthwise conv, its output under drop
  path in train mode (the only drop path of the stages, as in the JAX
  package: its injector and ViT blocks have none);
- `InteractionBlock`: injector, a span of the backbone's ViT blocks,
  extractor (and two extra extractors in the last stage);
- `SpatialPriorModuleBimodal`: TwinConvNeXt + fusion neck + 1x1
  projections to the ViT width. c1 stays a spatial NCHW map; c2..c4 become
  token streams.

Reference points and spatial shapes are static functions of the input
geometry and are passed in by the backbone.
"""
from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..nn.layers import DropPath, gelu
from ..ops.msda import MSDeformAttention
from .fusion_neck import RoadFormer2Neck
from .twin_convnext import CONVNEXT_ARCHS, TwinConvNeXt

Shapes = Tuple[Tuple[int, int], ...]


def reference_points(spatial_shapes: Sequence[Tuple[int, int]]) -> np.ndarray:
    """Pixel-centre reference points normalized per level, concatenated:
    (1, sum(HW), 1, 2) as (x, y)."""
    pts = []
    for H, W in spatial_shapes:
        ys = (np.arange(H, dtype=np.float32) + 0.5) / H
        xs = (np.arange(W, dtype=np.float32) + 0.5) / W
        yy, xx = np.meshgrid(ys, xs, indexing="ij")
        pts.append(np.stack([xx.reshape(-1), yy.reshape(-1)], axis=-1))
    return np.concatenate(pts, axis=0)[None, :, None, :]


@functools.lru_cache(maxsize=32)
def _reference_points(shapes: Shapes, n_levels: int,
                      device: torch.device) -> torch.Tensor:
    """(1, Lq, n_levels, 2) float32 on `device`, broadcast over levels.
    Made outside inference mode whatever the caller's mode: a cached
    inference tensor could not be saved for a later training backward
    (the MSDA Function saves the points for its recompute)."""
    with torch.inference_mode(False):
        ref = torch.as_tensor(reference_points(shapes), device=device)
        return ref.expand(1, ref.shape[1], n_levels, 2).contiguous()


class DWConvMS(nn.Module):
    """Shared 3x3 depthwise conv over the 16n / 4n / n token split of the
    pyramid stream [c2 (2H x 2W), c3 (H x W), c4 (H/2 x W/2)]."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, padding=1, groups=dim)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        B, N, C = x.shape
        n = N // 21
        parts = []
        for lo, hi, h, w in ((0, 16 * n, 2 * H, 2 * W),
                             (16 * n, 20 * n, H, W),
                             (20 * n, N, H // 2, W // 2)):
            t = x[:, lo:hi].transpose(1, 2).reshape(B, C, h, w)
            parts.append(self.dwconv(t).flatten(2).transpose(1, 2))
        return torch.cat(parts, dim=1)


class ConvFFN(nn.Module):
    """fc1 -> multi-scale dwconv -> GELU -> fc2."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = DWConvMS(hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        return self.fc2(gelu(self.dwconv(self.fc1(x), H, W)))


class Injector(nn.Module):
    """query(ViT) + gamma * MSDA(query_norm(ViT) <- feat_norm(pyramid))."""

    def __init__(self, dim: int, num_heads: int, n_points: int,
                 n_levels: int, deform_ratio: float):
        super().__init__()
        self.query_norm = nn.LayerNorm(dim, eps=1e-6)
        self.feat_norm = nn.LayerNorm(dim, eps=1e-6)
        self.attn = MSDeformAttention(dim, n_levels, num_heads, n_points,
                                      deform_ratio)
        self.gamma = nn.Parameter(torch.zeros(dim))

    def forward(self, query, feat, query_hw: Tuple[int, int],
                value_shapes: Shapes) -> torch.Tensor:
        refs = _reference_points((tuple(query_hw),), len(value_shapes),
                                 query.device)
        attn = self.attn(self.query_norm(query), refs, self.feat_norm(feat),
                         value_shapes)
        return query + self.gamma.to(attn.dtype) * attn


class Extractor(nn.Module):
    """query(pyramid) + MSDA(<- ViT grid), then query +
    drop_path(ConvFFN(LN(query)))."""

    def __init__(self, dim: int, num_heads: int, n_points: int,
                 deform_ratio: float, cffn_ratio: float,
                 drop_path: float = 0.0):
        super().__init__()
        self.query_norm = nn.LayerNorm(dim, eps=1e-6)
        self.feat_norm = nn.LayerNorm(dim, eps=1e-6)
        self.attn = MSDeformAttention(dim, 1, num_heads, n_points,
                                      deform_ratio)
        self.ffn = ConvFFN(dim, int(dim * cffn_ratio))
        self.ffn_norm = nn.LayerNorm(dim, eps=1e-6)
        self.drop_path = DropPath(drop_path)

    def forward(self, query, feat, query_shapes: Shapes,
                hw: Tuple[int, int]) -> torch.Tensor:
        refs = _reference_points(tuple(query_shapes), 1, query.device)
        query = query + self.attn(self.query_norm(query), refs,
                                  self.feat_norm(feat), (tuple(hw),))
        return query + self.drop_path(self.ffn(self.ffn_norm(query), hw[0],
                                               hw[1]))


class InteractionBlock(nn.Module):
    """Injector -> ViT blocks -> extractor (+ 2 extra in the last stage).
    The ViT blocks belong to the backbone (`blocks.N` in the checkpoint)
    and are handed in."""

    def __init__(self, dim: int, num_heads: int, n_points: int,
                 deform_ratio: float, cffn_ratio: float,
                 extra_extractor: bool, drop_path: float = 0.0):
        super().__init__()
        self.injector = Injector(dim, num_heads, n_points, 3, deform_ratio)
        self.extractor = Extractor(dim, num_heads, n_points, deform_ratio,
                                   cffn_ratio, drop_path)
        self.extra_extractors = nn.ModuleList(
            Extractor(dim, num_heads, n_points, deform_ratio, cffn_ratio,
                      drop_path)
            for _ in range(2 if extra_extractor else 0))

    def forward(self, x, c, blocks: Sequence[nn.Module],
                hw: Tuple[int, int], pyramid_shapes: Shapes):
        H, W = hw
        x = self.injector(x, c, hw, pyramid_shapes)
        for blk in blocks:
            x = blk(x, H, W)
        for ext in (self.extractor, *self.extra_extractors):
            c = ext(c, x, pyramid_shapes, hw)
        return x, c


class SpatialPriorModuleBimodal(nn.Module):
    """TwinConvNeXt + fusion neck + 1x1 projections to embed_dim.

    Returns c1 (B, E, H/4, W/4) spatial and c2..c4 as (B, HW_l, E) tokens.
    """

    def __init__(self, embed_dim: int, arch: str, img_size: int,
                 in_chans=(3, 3), conv_drop_path_rate: float = 0.0):
        super().__init__()
        chans = CONVNEXT_ARCHS[arch]["channels"]
        concat = [2 * c for c in chans]
        self.twin_conv = TwinConvNeXt(arch, in_chans,
                                      drop_path_rate=conv_drop_path_rate)
        self.smart_fusion = RoadFormer2Neck(
            concat, [(img_size // 2 ** (i + 2)) ** 2 for i in range(4)])
        for i, c in enumerate(concat):
            setattr(self, f"fc{i + 1}", nn.Conv2d(c, embed_dim, 1))

    def forward(self, x: torch.Tensor, x_aux: torch.Tensor
                ) -> List[torch.Tensor]:
        feats = self.smart_fusion(self.twin_conv(x, x_aux))
        outs = []
        for i, f in enumerate(feats):
            p = getattr(self, f"fc{i + 1}")(f)
            outs.append(p if i == 0 else p.flatten(2).transpose(1, 2))
        return outs
