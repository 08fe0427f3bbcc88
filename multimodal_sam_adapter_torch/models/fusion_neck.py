"""RoadFormer2-style cross-modal fusion neck on NCHW maps: the counterpart
of multimodal_sam_adapter_tpu/models/fusion_neck.py.

Per pyramid level the twin-branch feature is split into its RGB and
auxiliary halves; each half passes a global channel-attention encoder (GFE)
and a MobileNetV2 local encoder; the global halves fuse through a
bidirectional cross-modal channel attention (GFFM) and a recalibration
(FFRM), the local halves through a gated dwconv MLP; two learnable scalars
blend the paths and a coordinate attention finishes the level. The grouped
convolutions are plain `nn.Conv2d(groups=...)` (the JAX package's
block-diagonal dense forms are TPU workarounds). Parameter names follow the
reference checkpoint.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import (BatchNorm2d, ConvNormAct, Scale, Scale2, gelu,
                         h_swish)


class _WithBiasLayerNorm(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))


class RestormerLayerNorm(nn.Module):
    """Channel LayerNorm (eps 1e-5) of an NCHW map, params under `body`."""

    def __init__(self, channels: int):
        super().__init__()
        self.body = _WithBiasLayerNorm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 2, 3, 1)
        x = F.layer_norm(x, x.shape[-1:], self.body.weight, self.body.bias,
                         1e-5)
        return x.permute(0, 3, 1, 2)


class ChannelAttention(nn.Module):
    """Transposed (channel) attention: grouped 1x1 then grouped 3x3 qkv,
    per-head L2-normalized q/k over space, (C/heads)^2 attention."""

    def __init__(self, dim: int, num_heads: int = 8, groups: int = 1):
        super().__init__()
        self.num_heads = num_heads
        self.qkv1 = nn.Conv2d(dim, dim * 3, 1, groups=groups, bias=False)
        self.qkv2 = nn.Conv2d(dim * 3, dim * 3, 3, padding=1, groups=groups,
                              bias=False)
        self.proj = nn.Conv2d(dim, dim, 1, bias=False)
        self.scale = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.scale2 = nn.Parameter(torch.tensor(1.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        q, k, v = self.qkv2(self.qkv1(x)).chunk(3, dim=1)
        shape = (B, self.num_heads, C // self.num_heads, H * W)
        q = F.normalize(q.reshape(shape), dim=-1)
        k = F.normalize(k.reshape(shape), dim=-1)
        attn = torch.matmul(q, k.transpose(-2, -1)).float()
        attn = (attn * self.scale.float()).softmax(dim=-1)
        out = torch.matmul(attn.to(v.dtype), v.reshape(shape))
        out = self.proj(out.reshape(B, C, H, W))
        return x + out * self.scale2.to(x.dtype)


class GFE(nn.Module):
    """Global feature encoder: x + ChannelAttention(LN(x))."""

    def __init__(self, dim: int, num_heads: int = 8, groups: int = 32):
        super().__init__()
        self.norm1 = RestormerLayerNorm(dim)
        self.attn = ChannelAttention(dim, num_heads, groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.attn(self.norm1(x))


class MobileNetV2Block(nn.Module):
    """Local encoder: inverted bottleneck scaled by a learnable scalar."""

    def __init__(self, channels: int):
        super().__init__()
        hidden = channels * 2
        self.bottleneckBlock = nn.Sequential(
            nn.Conv2d(channels, hidden, 1, bias=False), nn.ReLU6(),
            nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden,
                      bias=False), nn.ReLU6(),
            nn.Conv2d(hidden, channels, 1, bias=False))
        self.scale = nn.Parameter(torch.tensor(0.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bottleneckBlock(x) * self.scale.to(x.dtype) + x


class GFFM(nn.Module):
    """Bidirectional cross-modal channel attention, then a LayerNorm over
    the flattened spatial axis (its weight has H*W entries)."""

    def __init__(self, hw: int):
        super().__init__()
        self.gammax = Scale(0.0)
        self.gammay = Scale(0.0)
        self.norm = nn.LayerNorm(hw, eps=1e-5)

    def forward(self, xy: torch.Tensor) -> torch.Tensor:
        B, C2, H, W = xy.shape
        x, y = xy.chunk(2, dim=1)
        fx = x.reshape(B, C2 // 2, H * W)
        fy = y.reshape(B, C2 // 2, H * W)
        ax = torch.matmul(fx, fy.transpose(1, 2)).float().softmax(dim=-1)
        ay = torch.matmul(fy, fx.transpose(1, 2)).float().softmax(dim=-1)
        outx = self.gammax(torch.matmul(ax.to(fy.dtype), fy)) + fx
        outy = self.gammay(torch.matmul(ay.to(fx.dtype), fx)) + fy
        out = self.norm(torch.cat([outx, outy], dim=1))
        return out.reshape(B, C2, H, W)


class GatedDWConvMlp(nn.Module):
    """1x1 expand to 2x -> 3x3 conv with 2 channels per group -> gelu(x1)*x2
    -> 1x1 project."""

    def __init__(self, channels: int):
        super().__init__()
        self.project_in = nn.Conv2d(channels, channels * 2, 1, bias=False)
        self.dwconv = nn.Conv2d(channels * 2, channels * 2, 3, padding=1,
                                groups=channels, bias=False)
        self.project_out = nn.Conv2d(channels, channels, 1, bias=False)

    def fused_halves(self):
        """The weights that hold two of the JAX package's kernels as the
        halves of dim 0: project_in, its project_in_gate and
        project_in_val. The factored second moment takes each half as a
        weight of its own (engine/optim.py:make_optimizer)."""
        return [self.project_in.weight]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = self.dwconv(self.project_in(x)).chunk(2, dim=1)
        return self.project_out(gelu(x1) * x2)


class FFRM(nn.Module):
    """Squeeze-excite recalibration: x + x * sigmoid(relu(GN(conv(pool))))."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv_atten = ConvNormAct(channels, channels, 1, norm="gn",
                                      act="relu",
                                      gn_groups=math.gcd(32, channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = torch.sigmoid(self.conv_atten(x.mean(dim=(2, 3), keepdim=True)))
        return x + x * a


class CoordinateAttention(nn.Module):
    def __init__(self, channels: int, reduction: int = 32):
        super().__init__()
        mip = max(8, channels // reduction)
        self.conv1 = nn.Conv2d(channels, mip, 1)
        self.bn1 = BatchNorm2d(mip, eps=1e-5)
        self.conv_h = nn.Conv2d(mip, channels, 1)
        self.conv_w = nn.Conv2d(mip, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        x_h = x.mean(dim=3, keepdim=True)                  # (B, C, H, 1)
        x_w = x.mean(dim=2, keepdim=True).transpose(2, 3)  # (B, C, W, 1)
        y = h_swish(self.bn1(self.conv1(torch.cat([x_h, x_w], dim=2))))
        a_h = torch.sigmoid(self.conv_h(y[:, :, :H]))                  # H x 1
        a_w = torch.sigmoid(self.conv_w(y[:, :, H:])).transpose(2, 3)  # 1 x W
        return x + x * a_w * a_h


class _CABlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.coord_atten = CoordinateAttention(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.coord_atten(x)


class RoadFormer2Neck(nn.Module):
    """in_channels: per-level concat widths (2x the branch width);
    feat_hw: per-level H*W, which fixes the GFFM LayerNorm widths."""

    def __init__(self, in_channels: Sequence[int], feat_hw: Sequence[int]):
        super().__init__()
        halves = [c // 2 for c in in_channels]
        for mod in ("rgb", "sne"):
            setattr(self, f"global_feature_encoder_{mod}", nn.ModuleList(
                GFE(h, 8, math.gcd(32, h)) for h in halves))
            setattr(self, f"local_feature_encoder_{mod}", nn.ModuleList(
                MobileNetV2Block(h) for h in halves))
        self.fuse_blocks = nn.ModuleList(GFFM(hw) for hw in feat_hw)
        self.detail_feature_extractions = nn.ModuleList(
            GatedDWConvMlp(c) for c in in_channels)
        self.enhance_blocks = nn.ModuleList(FFRM(c) for c in in_channels)
        self.ca_blocks = nn.ModuleList(_CABlock(c) for c in in_channels)
        self.scale_layers = nn.ModuleList(Scale2() for _ in in_channels)

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        outs = []
        for i, feat in enumerate(feats):
            rgb, sne = feat.chunk(2, dim=1)
            g = torch.cat([self.global_feature_encoder_rgb[i](rgb),
                           self.global_feature_encoder_sne[i](sne)], dim=1)
            l = torch.cat([self.local_feature_encoder_rgb[i](rgb),
                           self.local_feature_encoder_sne[i](sne)], dim=1)
            g = self.enhance_blocks[i](self.fuse_blocks[i](g))
            l = self.detail_feature_extractions[i](l)
            outs.append(self.ca_blocks[i](self.scale_layers[i](g, l)))
        return outs
