"""Layer library (PyTorch), the counterpart of multimodal_sam_adapter_tpu/nn.

Layout, decided once here for the whole package:

- convolutional feature maps are NCHW, PyTorch's own layout: the ConvNeXt
  trunk, the fusion neck, the spatial prior, the pyramid and the head;
- token streams are (B, N, C), and the ViT blocks work on (B, H, W, C), as
  SAM's reference encoder does;
- the public surface (`EncoderDecoder.forward` / `features`, the inference
  engine) keeps the JAX package's NHWC layout: input (B, H, W, 6), logits
  (B, H, W, classes), features (B, h, w, C).

Parameter names follow the reference PyTorch checkpoints (the keys that
`engine/convert_full.py:convert_full_checkpoint` of the JAX package reads),
so a reference state_dict loads with strict=True.

The port runs inference only: dropout and stochastic depth are identities,
BatchNorm uses its running statistics, and GELU is the exact erf form.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, the reference's form in every module."""
    return F.gelu(x)


def h_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return F.relu6(x + 3.0) / 6.0


def h_swish(x: torch.Tensor) -> torch.Tensor:
    return x * h_sigmoid(x)


class LayerNorm2d(nn.Module):
    """LayerNorm over the channels of an NCHW map ('LN2d' in the reference).

    The JAX package's LayerNorm over the trailing NHWC axis."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 2, 3, 1)
        x = F.layer_norm(x, x.shape[-1:], self.weight, self.bias, self.eps)
        return x.permute(0, 3, 1, 2)


class BiasFreeLayerNorm(nn.Module):
    """Restormer bias-free LN over the trailing axis: x / sqrt(var + eps) * w
    (the variance is mean-subtracted, x is not recentred)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.float().var(-1, keepdim=True, unbiased=False)
        y = x.float() * torch.rsqrt(var + self.eps) * self.weight.float()
        return y.to(x.dtype)


class DropPath(nn.Module):
    """Stochastic depth. The port runs inference only, where it is the
    identity; a training forward with a nonzero rate is refused."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.rate > 0:
            raise NotImplementedError("training is not ported yet")
        return x


class Scale(nn.Module):
    """Learnable scalar multiplier."""

    def __init__(self, init_value: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(float(init_value)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale.to(x.dtype)


class Scale2(nn.Module):
    """Two learnable scalars blending two inputs: x * s1 + y * s2."""

    def __init__(self):
        super().__init__()
        self.scale1 = nn.Parameter(torch.tensor(1.0))
        self.scale2 = nn.Parameter(torch.tensor(1.0))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return x * self.scale1.to(x.dtype) + y * self.scale2.to(x.dtype)


class ConvNormAct(nn.Module):
    """mmcv ConvModule: Conv2d -> norm -> activation on NCHW.

    norm: None, 'bn' (submodule `bn`) or 'gn' (submodule `gn`); the conv has
    a bias only without a norm, as in mmcv. act: None, 'relu' or 'gelu'.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 1,
                 stride: int = 1, padding: int = 0, groups: int = 1,
                 norm: Optional[str] = None, act: Optional[str] = "relu",
                 gn_groups: int = 32):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel_size, stride, padding,
                              groups=groups, bias=norm is None)
        self.norm_name = norm
        if norm == "bn":
            self.bn = nn.BatchNorm2d(out_ch, eps=1e-5)
        elif norm == "gn":
            self.gn = nn.GroupNorm(gn_groups, out_ch, eps=1e-5)
        elif norm is not None:
            raise ValueError(f"unknown norm {norm!r}")
        if act not in (None, "relu", "gelu"):
            raise ValueError(f"unknown activation {act!r}")
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.norm_name == "bn":
            x = self.bn(x)
        elif self.norm_name == "gn":
            x = self.gn(x)
        if self.act == "relu":
            x = F.relu(x)
        elif self.act == "gelu":
            x = gelu(x)
        return x


class MLPBlock(nn.Module):
    """Linear -> GELU -> Linear (SAM's MLPBlock)."""

    def __init__(self, dim: int, mlp_dim: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, mlp_dim)
        self.lin2 = nn.Linear(mlp_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(gelu(self.lin1(x)))
