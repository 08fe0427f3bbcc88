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
(`checkpoint`) draws the same masks, and each sample's mask from its row
in the global batch, so that N ranks draw the masks of one process on the
global batch. Train-mode BatchNorm normalises with the statistics of the
global batch (merged over the ranks, parallel/ddp.py, or over the data
group of a tensor-parallel mesh, parallel/tp.py), as the JAX package's
BatchNorm under a batch-sharded mesh. GELU is the exact erf form.
"""
from __future__ import annotations

import contextvars
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..parallel.ddp import rank_world

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
    flax's Dropout. The mask is drawn from a generator seeded from the
    module's `seed` (`set_dropout_key`), not from torch's default
    generators, so that it is a function of (key, module) alone: the
    recompute under `checkpoint` and the kernel and plain paths draw the
    same masks. Under data parallelism (`shard` = (rank, world), every
    rank holding B samples) sample b's mask comes from fold_in(seed,
    rank x B + b), its row in the global batch, so that each rank draws
    the masks one process draws for its rows: one draw (one launch) a
    sample."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.seed: Optional[int] = None
        self.shard = (0, 1)

    def mask_shape(self, x: torch.Tensor):
        return (1,) + tuple(x.shape[1:])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0:
            return x
        if self.seed is None:
            raise RuntimeError("no dropout key: call set_dropout_key(model, "
                               "key) before a train-mode forward")
        keep = 1.0 - self.rate
        first = self.shard[0] * x.shape[0]
        g = torch.Generator(device=x.device)
        u = [torch.rand(self.mask_shape(x), device=x.device,
                        generator=g.manual_seed(fold_in(self.seed, first + b)))
             for b in range(x.shape[0])]
        u = u[0] if len(u) == 1 else torch.cat(u)
        return torch.where(u < keep, x / keep,
                           torch.zeros((), dtype=x.dtype, device=x.device))


class DropPath(KeyedDropout):
    """Stochastic depth: whole samples dropped (timm's drop_path, the JAX
    package's nn.layers.DropPath)."""

    def mask_shape(self, x: torch.Tensor):
        return (1,) * x.dim()


class KeyedDraws:
    """A module whose train-mode loss draws at random (the Mask2Former
    head's point samples): `set_dropout_key` gives it the step's key
    itself as `seed`, and `shard`, as it gives each `KeyedDropout` its
    own."""
    seed: Optional[int] = None
    shard: Tuple[int, int] = (0, 1)


def set_dropout_key(model: nn.Module, key: Optional[int],
                    shard: Tuple[int, int] = (0, 1)) -> None:
    """Seed every `KeyedDropout` of `model` for the next train-mode
    forward (and its recomputes): the i-th in module order draws from
    fold_in(key, i), for the rows of the global batch that rank `shard[0]`
    of `shard[1]` holds (rank x B ... rank x B + B - 1). Under tensor
    parallelism `shard` is (data rank, data size): the model ranks of a
    data row hold the same samples and draw the same masks. Every
    `KeyedDraws` gets `key`. None unsets them."""
    drops = (m for m in model.modules() if isinstance(m, KeyedDropout))
    for i, m in enumerate(drops):
        m.seed = None if key is None else fold_in(key, i)
        m.shard = tuple(shard)
    for m in model.modules():
        if isinstance(m, KeyedDraws):
            m.seed, m.shard = key, tuple(shard)


_RECOMPUTING = contextvars.ContextVar("recomputing", default=False)


def recomputing() -> bool:
    """Whether the caller runs inside a `checkpoint` region's recompute
    (the backward's second run of fn), not its forward."""
    return _RECOMPUTING.get()


def checkpoint(fn: Callable, *args, module: nn.Module):
    """fn(*args) under torch.utils.checkpoint (non-reentrant): nothing
    inside is saved for the backward, which runs fn again (`recomputing()`
    is true inside that run). The recompute would update the running
    statistics of every train-mode BatchNorm of `module` (the modules fn
    runs) a second time, so they are put back as the forward left them
    after it."""
    norms = [m for m in module.modules()
             if isinstance(m, nn.modules.batchnorm._BatchNorm)
             and m.track_running_stats]
    calls = []

    def run(*a):
        calls.append(None)
        if len(calls) == 1:
            return fn(*a)
        saved = [[b.clone() for b in (m.running_mean, m.running_var,
                                      m.num_batches_tracked)]
                 for m in norms]
        token = _RECOMPUTING.set(True)
        try:
            return fn(*a)
        finally:
            _RECOMPUTING.reset(token)
            for m, (mean, var, n) in zip(norms, saved):
                m.running_mean.copy_(mean)
                m.running_var.copy_(var)
                m.num_batches_tracked.copy_(n)

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)


class _PlainSyncBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the global batch, NCHW, on ranks on the
    CPU. The forward sums each channel's x and x^2 in float32 over this
    rank's batch and over all of them (one all-reduce of [sum, sum of
    squares, count]); the backward all-reduces the two per-channel sums of
    the gradient (dy, dy * x_hat) the same way."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        C = x.shape[1]
        xf = x.float()
        # the pixel count rides along in float32: exact below 2^24
        stats = torch.cat([xf.sum((0, 2, 3)), xf.square().sum((0, 2, 3)),
                           xf.new_full((1,), x.numel() // C)])
        dist.all_reduce(stats, group=group)
        n = stats[-1]
        mean = stats[:C] / n
        # flax's form: E[x^2] - E[x]^2, clamped at 0
        var = (stats[C:2 * C] / n - mean.square()).clamp(min=0)
        invstd = torch.rsqrt(var + eps)
        y = ((xf - mean[:, None, None]) * (invstd * weight.float())[:, None,
                                                                      None]
             + bias.float()[:, None, None]).to(x.dtype)
        ctx.save_for_backward(x, weight, mean, invstd, n)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd, n = ctx.saved_tensors
        C = x.shape[1]
        dyf = dy.float()
        xhat = (x.float() - mean[:, None, None]) * invstd[:, None, None]
        sums = torch.cat([dyf.sum((0, 2, 3)), (dyf * xhat).sum((0, 2, 3))])
        dweight, dbias = sums[C:].clone(), sums[:C].clone()
        dist.all_reduce(sums, group=ctx.group)
        dx = (dyf - sums[:C, None, None] / n
              - xhat * (sums[C:, None, None] / n)) * (
                  invstd * weight.float())[:, None, None]
        return dx.to(x.dtype), dweight.to(weight.dtype), dbias.to(
            weight.dtype), None, None


class _CudaSyncBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the global batch on ranks on cards, with
    the fused kernels of torch's SyncBatchNorm: each rank's per-channel
    mean and 1/std (batch_norm_stats), one all-reduce of the ranks' rows
    [mean, 1/std, count] (zero but for this rank's row, which gloo and
    NCCL both take on a card), their merge (batch_norm_gather_stats_with_
    counts) and the normalisation (batch_norm_elemt); the backward's two
    per-channel sums (batch_norm_backward_reduce) all-reduced, then
    batch_norm_backward_elemt."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group, rank, world):
        x = x.contiguous()
        C = x.shape[1]
        mean, invstd = torch.batch_norm_stats(x, eps)
        rows = mean.new_zeros((world, 2 * C + 1), dtype=torch.float32)
        rows[rank, :C] = mean
        rows[rank, C:2 * C] = invstd
        rows[rank, -1] = x.numel() // C
        dist.all_reduce(rows, group=group)
        counts = rows[:, -1]
        # given running statistics the merge takes the counts in their
        # dtype, float32 (given none, in x's: inexact in bf16); these are
        # scratch ones, which it updates with momentum 0
        scratch = rows.new_zeros((2, C))
        mean, invstd = torch.batch_norm_gather_stats_with_counts(
            x, rows[:, :C], rows[:, C:2 * C], scratch[0], scratch[1], 0.0,
            eps, counts)
        y = torch.batch_norm_elemt(x, weight, bias, mean, invstd, eps)
        ctx.save_for_backward(x, weight, mean, invstd,
                              counts.to(torch.int32))
        ctx.group = group
        var = (invstd.pow(-2) - eps).clamp(min=0)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd, counts = ctx.saved_tensors
        C = x.shape[1]
        sum_dy, sum_dy_xmu, dweight, dbias = torch.batch_norm_backward_reduce(
            dy.contiguous(), x, mean, invstd, weight, True, True, True)
        sums = torch.cat([sum_dy, sum_dy_xmu])
        dist.all_reduce(sums, group=ctx.group)
        dx = torch.batch_norm_backward_elemt(
            dy.contiguous(), x, mean, invstd, weight.to(mean.dtype),
            sums[:C], sums[C:], counts)
        return dx, dweight, dbias, None, None, None, None


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm over (N, H, W) of an NCHW map, the JAX package's
    nn.layers.BatchNorm: in train mode the statistics of the global batch
    (this rank's, merged over every rank of the process group) normalise
    with the biased variance, and the running statistics move as flax's
    do, momentum 0.1 (flax's 0.9) with the biased variance (torch's own
    BatchNorm and SyncBatchNorm use the unbiased one). One process runs
    torch's fused BatchNorm (native_batch_norm) and takes the variance
    from its 1/std; ranks run `_CudaSyncBatchNorm` on cards and
    `_PlainSyncBatchNorm` on the CPU. The ranks are those of
    `process_group`: None, every rank of the process group; on a
    tensor-parallel mesh its data group (`set_sync_group`), since the
    model ranks of a data row hold the same samples. In eval mode torch's
    BatchNorm on the running statistics. A subclass of nn.BatchNorm2d:
    the same state_dict keys, and every isinstance check on norms holds."""

    process_group: Optional[dist.ProcessGroup] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        group = self.process_group
        if group is None:
            rank, world = rank_world()
        else:
            rank, world = dist.get_rank(group), dist.get_world_size(group)
        if world > 1 and x.is_cuda:
            y, mean, var = _CudaSyncBatchNorm.apply(
                x, self.weight, self.bias, self.eps, group, rank, world)
        elif world > 1:
            y, mean, var = _PlainSyncBatchNorm.apply(
                x, self.weight, self.bias, self.eps, group)
        else:
            y, mean, invstd = torch.native_batch_norm(
                x, self.weight, self.bias, None, None, True, 0.0, self.eps)
            var = None
        with torch.no_grad():
            if var is None:
                var = (invstd.pow(-2) - self.eps).clamp_(min=0)
            self.running_mean.lerp_(mean.to(self.running_mean.dtype),
                                    self.momentum)
            self.running_var.lerp_(var.to(self.running_var.dtype),
                                   self.momentum)
            self.num_batches_tracked.add_(1)
        return y


def set_sync_group(model: nn.Module,
                   group: Optional[dist.ProcessGroup]) -> None:
    """Merge the train-mode statistics of every `BatchNorm2d` of `model`
    over the ranks of `group` (None: every rank)."""
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.process_group = group


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
            self.bn = BatchNorm2d(out_ch, eps=1e-5)
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
