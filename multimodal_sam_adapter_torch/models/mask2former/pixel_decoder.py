"""MSDeformAttn pixel decoder: the counterpart of
multimodal_sam_adapter_tpu/models/mask2former/pixel_decoder.py (the
reference's msdeformattn_pixel_decoder.py).

Takes the backbone's four NCHW maps (strides 4 / 8 / 16 / 32), runs a
deformable-attention encoder over the three coarse levels, in the order
stride 32, 16, 8, through the port's MSDeformAttention (K3 on the card,
grid_sample on the CPU), then adds the encoder's stride-8 output into the
stride-4 level top-down. Returns the mask features (B, C, H/4, W/4) and the
three memories (stride 32, 16, 8) for the transformer decoder.

Parameter names are the reference checkpoint's keys under `pixel_decoder.`.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.msda import MSDeformAttention
from ...utils.interpolate import resize_bilinear
from ..adapter import _reference_points
from .positional_encoding import sine_positional_encoding


class ConvGN(nn.Module):
    """mmcv's ConvModule with GroupNorm(32): `conv`, `gn`, then ReLU when
    `relu`."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 1,
                 bias: bool = True, relu: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size,
                              padding=kernel_size // 2, bias=bias)
        self.gn = nn.GroupNorm(32, cout, eps=1e-5)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.gn(self.conv(x))
        return F.relu(x) if self.relu else x


class FFN(nn.Module):
    """mmcv's FFN of two layers: `layers.0.0` Linear + ReLU, `layers.1`
    Linear (no residual: the caller adds it)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Sequential(nn.Linear(dim, hidden), nn.ReLU()),
            nn.Linear(hidden, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x)


class DeformableEncoderLayer(nn.Module):
    """MSDA over the three levels, LayerNorm, FFN, LayerNorm (post-norm).
    The positional embedding drives the query only (the sampling offsets
    and attention weights), never the value or the residual."""

    def __init__(self, dim: int = 256, num_heads: int = 8, n_points: int = 4,
                 n_levels: int = 3, ffn_dim: int = 1024):
        super().__init__()
        self.attentions = nn.ModuleList(
            [MSDeformAttention(dim, n_levels, num_heads, n_points)])
        self.ffns = nn.ModuleList([FFN(dim, ffn_dim)])
        self.norms = nn.ModuleList(nn.LayerNorm(dim, eps=1e-5)
                                   for _ in range(2))

    def forward(self, x, pos, ref_points, spatial_shapes):
        x = self.norms[0](x + self.attentions[0](x + pos, ref_points, x,
                                                 spatial_shapes))
        return self.norms[1](x + self.ffns[0](x))


class _Encoder(nn.Module):
    def __init__(self, num_layers: int, **layer_kw):
        super().__init__()
        self.layers = nn.ModuleList(DeformableEncoderLayer(**layer_kw)
                                    for _ in range(num_layers))


class MSDeformAttnPixelDecoder(nn.Module):
    def __init__(self, in_channels: int, feat_channels: int = 256,
                 num_encoder_layers: int = 6, num_heads: int = 8,
                 n_points: int = 4, num_outs: int = 3, ffn_dim: int = 1024):
        super().__init__()
        C = feat_channels
        self.num_outs = num_outs
        self.input_convs = nn.ModuleList(ConvGN(in_channels, C)
                                         for _ in range(3))
        self.encoder = _Encoder(num_encoder_layers, dim=C,
                                num_heads=num_heads, n_points=n_points,
                                n_levels=3, ffn_dim=ffn_dim)
        self.level_encoding = nn.Embedding(3, C)
        self.lateral_convs = nn.ModuleList([ConvGN(in_channels, C,
                                                   bias=False)])
        self.output_convs = nn.ModuleList([ConvGN(C, C, 3, bias=False,
                                                  relu=True)])
        self.mask_feature = nn.Conv2d(C, C, 1)

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """feats: four NCHW maps, strides 4 / 8 / 16 / 32 -> (mask features
        (B, C, H/4, W/4), memories [stride 32, 16, 8] NCHW)."""
        enc_feats = [feats[3], feats[2], feats[1]]
        shapes = tuple((int(f.shape[2]), int(f.shape[3])) for f in enc_feats)
        B = feats[0].shape[0]
        tokens, pos_tokens = [], []
        for i, f in enumerate(enc_feats):
            t = self.input_convs[i](f)
            h, w = shapes[i]
            pos = sine_positional_encoding(h, w, t.shape[1] // 2,
                                           dtype=t.dtype, device=t.device)
            pos = pos + self.level_encoding.weight[i].to(t.dtype)
            tokens.append(t.flatten(2).transpose(1, 2))
            pos_tokens.append(pos.reshape(1, h * w, -1))
        x = torch.cat(tokens, dim=1)
        pos = torch.cat(pos_tokens, dim=1).expand(B, -1, -1)
        # (1, S, 3, 2) float32, contiguous: the kernel's layout for
        # batch-broadcast points (the JAX package casts them to x's dtype)
        refs = _reference_points(shapes, len(shapes), x.device)
        for layer in self.encoder.layers:
            x = layer(x, pos, refs, shapes)

        outs = []
        for (h, w), t in zip(shapes, x.split([h * w for h, w in shapes],
                                             dim=1)):
            outs.append(t.transpose(1, 2).reshape(B, -1, h, w))
        y = self.lateral_convs[0](feats[0])
        y = y + resize_bilinear(outs[-1], y.shape[-2:])
        y = self.output_convs[0](y)
        return self.mask_feature(y), outs[:self.num_outs]
