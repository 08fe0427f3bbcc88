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

In eval mode dropout and stochastic depth are identities and BatchNorm
uses its running statistics; in train mode their masks come from a key set
from outside (`set_dropout_key`, the counterpart of the JAX package's
'dropout' rng), so that a recompute under activation checkpointing
(`checkpoint`) draws the same masks. GELU is the exact erf form.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

_MASK64 = (1 << 64) - 1


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def fold_in(key: int, data: int) -> int:
    """A new 63-bit key from `key` and `data` (splitmix64), as
    jax.random.fold_in derives one: the train step's key from (seed,
    step), each module's seed from (key, its index)."""
    return _splitmix64((key & _MASK64) ^ _splitmix64(data & _MASK64)) >> 1


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


class KeyedDropout(nn.Module):
    """Dropout in train mode: where(mask, x / keep, 0) elementwise, as
    flax's Dropout. The mask is drawn from a generator seeded with the
    module's `seed` (`set_dropout_key`), not from torch's default
    generators, so that it is a function of (key, module) alone: the
    recompute under `checkpoint` and the kernel and plain paths draw the
    same masks."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.seed: Optional[int] = None

    def mask_shape(self, x: torch.Tensor):
        return x.shape

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0:
            return x
        if self.seed is None:
            raise RuntimeError("no dropout key: call set_dropout_key(model, "
                               "key) before a train-mode forward")
        keep = 1.0 - self.rate
        g = torch.Generator(device=x.device).manual_seed(self.seed)
        mask = torch.rand(self.mask_shape(x), generator=g,
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


class DropPath(KeyedDropout):
    """Stochastic depth: whole samples dropped (timm's drop_path, the JAX
    package's nn.layers.DropPath)."""

    def mask_shape(self, x: torch.Tensor):
        return (x.shape[0],) + (1,) * (x.dim() - 1)


def set_dropout_key(model: nn.Module, key: Optional[int]) -> None:
    """Seed every `KeyedDropout` of `model` for the next train-mode
    forward (and its recomputes): the i-th in module order draws from
    fold_in(key, i). None unsets them."""
    drops = (m for m in model.modules() if isinstance(m, KeyedDropout))
    for i, m in enumerate(drops):
        m.seed = None if key is None else fold_in(key, i)


def checkpoint(fn: Callable, *args, module: nn.Module):
    """fn(*args) under torch.utils.checkpoint (non-reentrant): nothing
    inside is saved for the backward, which runs fn again. The recompute
    would update the running statistics of every train-mode BatchNorm of
    `module` (the modules fn runs) a second time, so they are put back as
    the forward left them after it."""
    norms = [m for m in module.modules()
             if isinstance(m, nn.modules.batchnorm._BatchNorm)
             and m.track_running_stats]
    calls = []

    def run(*a):
        calls.append(None)
        if len(calls) == 1 or not norms:
            return fn(*a)
        saved = [[b.clone() for b in (m.running_mean, m.running_var,
                                      m.num_batches_tracked)]
                 for m in norms]
        try:
            return fn(*a)
        finally:
            for m, (mean, var, n) in zip(norms, saved):
                m.running_mean.copy_(mean)
                m.running_var.copy_(var)
                m.num_batches_tracked.copy_(n)

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)


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
