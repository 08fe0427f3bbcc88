"""TwinConvNeXt: two weight-independent ConvNeXt trunks (RGB / auxiliary
modality) whose per-stage features are channel-concatenated. The
counterpart of multimodal_sam_adapter_tpu/models/twin_convnext.py;
parameter names follow the reference's `_x` / `_y` branch keys.

Each block runs K5 (ops/convnext_block.py), which reads and writes
channels-last maps, so the trunk stays channels-last (B, H, W, C) from the
stem to the stage norms: no permute copy sits between the blocks. In eval
mode K5 adds the shortcut itself; in train mode it returns the delta,
which stochastic depth (a rate rising linearly over each branch's blocks,
as in the JAX package) drops per sample before the add. The
modules keep the reference's structure and names (`downsample_layers_x.1.0`
is still the LayerNorm before the second downsample conv), so a reference
state_dict loads strictly; their forwards are applied by hand here.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import DropPath, LayerNorm2d
from ..ops.convnext_block import convnext_block, convnext_block_delta

CONVNEXT_ARCHS = {
    "atto": {"depths": (2, 2, 6, 2), "channels": (40, 80, 160, 320)},
    "femto": {"depths": (2, 2, 6, 2), "channels": (48, 96, 192, 384)},
    "pico": {"depths": (2, 2, 6, 2), "channels": (64, 128, 256, 512)},
    "nano": {"depths": (2, 2, 8, 2), "channels": (80, 160, 320, 640)},
    "tiny": {"depths": (3, 3, 9, 3), "channels": (96, 192, 384, 768)},
    "small": {"depths": (3, 3, 27, 3), "channels": (96, 192, 384, 768)},
    "base": {"depths": (3, 3, 27, 3), "channels": (128, 256, 512, 1024)},
    "large": {"depths": (3, 3, 27, 3), "channels": (192, 384, 768, 1536)},
    "xlarge": {"depths": (3, 3, 27, 3), "channels": (256, 512, 1024, 2048)},
    "huge": {"depths": (3, 3, 27, 3), "channels": (352, 704, 1408, 2816)},
}


class ConvNeXtBlock(nn.Module):
    """dwconv 7x7 -> LN -> Linear(4x) -> GELU -> Linear -> gamma -> drop
    path, residual, on a channels-last map (B, H, W, C)."""

    def __init__(self, channels: int, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.0):
        super().__init__()
        self.depthwise_conv = nn.Conv2d(channels, channels, 7, padding=3,
                                        groups=channels)
        self.norm = nn.LayerNorm(channels, eps=1e-6)
        self.pointwise_conv1 = nn.Linear(channels, int(mlp_ratio * channels))
        self.pointwise_conv2 = nn.Linear(int(mlp_ratio * channels), channels)
        self.gamma = nn.Parameter(torch.ones(channels))
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        args = (x, self.depthwise_conv.weight, self.depthwise_conv.bias,
                self.norm.weight, self.norm.bias, self.pointwise_conv1.weight,
                self.pointwise_conv1.bias, self.pointwise_conv2.weight,
                self.pointwise_conv2.bias, self.gamma, self.norm.eps)
        if self.training:
            return x + self.drop_path(convnext_block_delta(*args))
        return convnext_block(*args)


def _ln_last(ln: LayerNorm2d, x: torch.Tensor) -> torch.Tensor:
    """A LayerNorm2d applied to a channels-last map."""
    return F.layer_norm(x, x.shape[-1:], ln.weight, ln.bias, ln.eps)


def _conv_last(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A Conv2d on a channels-last map (B, H, W, C) -> (B, H', W', C')."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class TwinConvNeXt(nn.Module):
    def __init__(self, arch: str = "small", in_chans=(3, 3),
                 stem_patch_size: int = 4, drop_path_rate: float = 0.0):
        super().__init__()
        cfg = CONVNEXT_ARCHS[arch]
        depths, chans = cfg["depths"], cfg["channels"]
        # per block of a branch, rising linearly from 0 to drop_path_rate
        total = sum(depths)
        dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        starts = [sum(depths[:i]) for i in range(4)]
        for br, cin in zip(("x", "y"), in_chans):
            down = nn.ModuleList([nn.Sequential(
                nn.Conv2d(cin, chans[0], stem_patch_size, stem_patch_size),
                LayerNorm2d(chans[0]))])
            for i in range(1, 4):
                down.append(nn.Sequential(
                    LayerNorm2d(chans[i - 1]),
                    nn.Conv2d(chans[i - 1], chans[i], 2, 2)))
            setattr(self, f"downsample_layers_{br}", down)
            setattr(self, f"stages_{br}", nn.ModuleList([
                nn.Sequential(*[ConvNeXtBlock(c, drop_path_rate=dpr[s + j])
                                for j in range(d)])
                for d, c, s in zip(depths, chans, starts)]))
            for i, c in enumerate(chans):
                setattr(self, f"norm_{br}{i}", LayerNorm2d(c))

    def _branch(self, br: str, x: torch.Tensor) -> List[torch.Tensor]:
        """x (B, C_in, H, W) -> four NCHW-shaped views of channels-last
        stage outputs."""
        down = getattr(self, f"downsample_layers_{br}")
        stages = getattr(self, f"stages_{br}")
        x = _ln_last(down[0][1], down[0][0](x).permute(0, 2, 3, 1))
        outs = []
        for i in range(4):
            if i:
                x = _conv_last(down[i][1], _ln_last(down[i][0], x))
            x = stages[i](x.contiguous())
            outs.append(_ln_last(getattr(self, f"norm_{br}{i}"), x)
                        .permute(0, 3, 1, 2))
        return outs

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> List[torch.Tensor]:
        return [torch.cat([a, b], dim=1)
                for a, b in zip(self._branch("x", x), self._branch("y", y))]
