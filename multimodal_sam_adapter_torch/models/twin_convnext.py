"""TwinConvNeXt: two weight-independent ConvNeXt trunks (RGB / auxiliary
modality) whose per-stage features are channel-concatenated. The
counterpart of multimodal_sam_adapter_tpu/models/twin_convnext.py (its XLA
path); parameter names follow the reference's `_x` / `_y` branch keys.
"""
from __future__ import annotations

from typing import List

import torch
from torch import nn

from ..nn.layers import LayerNorm2d, gelu

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
    """dwconv 7x7 -> LN -> Linear(4x) -> GELU -> Linear -> gamma, residual."""

    def __init__(self, channels: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.depthwise_conv = nn.Conv2d(channels, channels, 7, padding=3,
                                        groups=channels)
        self.norm = nn.LayerNorm(channels, eps=1e-6)
        self.pointwise_conv1 = nn.Linear(channels, int(mlp_ratio * channels))
        self.pointwise_conv2 = nn.Linear(int(mlp_ratio * channels), channels)
        self.gamma = nn.Parameter(torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.depthwise_conv(x).permute(0, 2, 3, 1)
        y = self.pointwise_conv2(gelu(self.pointwise_conv1(self.norm(y))))
        y = y * self.gamma.to(y.dtype)
        return x + y.permute(0, 3, 1, 2)


class TwinConvNeXt(nn.Module):
    def __init__(self, arch: str = "small", in_chans=(3, 3),
                 stem_patch_size: int = 4):
        super().__init__()
        cfg = CONVNEXT_ARCHS[arch]
        depths, chans = cfg["depths"], cfg["channels"]
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
                nn.Sequential(*[ConvNeXtBlock(c) for _ in range(d)])
                for d, c in zip(depths, chans)]))
            for i, c in enumerate(chans):
                setattr(self, f"norm_{br}{i}", LayerNorm2d(c))

    def _branch(self, br: str, x: torch.Tensor) -> List[torch.Tensor]:
        down = getattr(self, f"downsample_layers_{br}")
        stages = getattr(self, f"stages_{br}")
        outs = []
        for i in range(4):
            x = stages[i](down[i](x))
            outs.append(getattr(self, f"norm_{br}{i}")(x))
        return outs

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> List[torch.Tensor]:
        return [torch.cat([a, b], dim=1)
                for a, b in zip(self._branch("x", x), self._branch("y", y))]
