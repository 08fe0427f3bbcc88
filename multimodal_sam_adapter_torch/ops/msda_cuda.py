"""K3/K4: multi-scale deformable attention sampling.

`ms_deform_attn` takes the module's raw projections (value, sampling
offsets, attention logits) and the reference points, and returns the
sampled (B, Lq, heads * D) output. On a CUDA tensor it launches one
hand-written kernel (csrc/msda.cu) on them as they are: the softmax over
levels x points, the absolute sampling coordinates and the bilinear gather
all happen inside it, with no torch op and no host-to-device copy around
it. The level count and the points per level are template parameters of
the kernel, so it serves the 3-level injectors (K3) and the 1-level
extractors (K4); `msda_plan` picks its launch. When autograd records the
call it goes through `MSDeformAttnFunction`: the kernel forward, and the
autodiff of the plain version recomputed as its backward. On a CPU tensor
it runs the plain `grid_sample` version, `ms_deform_attn_plain`.

Replaces multimodal_sam_adapter_tpu/ops/msda_pallas.py:
_digit_pallas_call_multi_prep (K3) and _digit_pallas_call_prep (K4), and
their custom_vjp _make_ms_deform_attn_flat_cached.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..utils import flops
from . import kernels

Shapes = Sequence[Tuple[int, int]]

SMS = 132                  # streaming multiprocessors of an H100 SXM
MAX_LEVELS = 4             # the kernel's template levels: 1 ... 4
POINTS = (2, 4)            # the kernel's template points per level
BLOCK_THREADS = 256        # csrc/msda.cu kMsdaMaxThreads
MAX_BLOCK_QUERIES = 64     # blockDim.z
INT32 = 2 ** 31


class MsdaPlan(NamedTuple):
    vec: int                 # channels a thread loads and stores at once
    lanes: int               # threads a (batch, query, head): lanes*vec = D
    heads_per_block: int     # block (lanes, heads_per_block,
    queries_per_block: int   # queries_per_block)
    grid: Tuple[int, int, int]   # (query blocks, batch, head groups)


def msda_plan(B: int, Lq: int, M: int, D: int, L: int, P: int,
              dtype: torch.dtype, value_ptr_alignment: int) -> MsdaPlan:
    """The kernel's launch for value (B, S, M*D) and Lq queries of L levels
    x P points. VEC: the widest load of at most 16 bytes that divides D and
    that the value pointer's alignment (bytes, a power of two) allows.
    A block holds the most heads (a divisor of M) whose lanes fit
    BLOCK_THREADS, and the most queries that fill it, halved while the
    grid would give fewer than 4 blocks an SM. Raises ValueError on what
    the kernel does not take."""
    esize = {torch.bfloat16: 2, torch.float32: 4}.get(dtype)
    if esize is None:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {dtype}")
    if not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"the kernel takes 1 to {MAX_LEVELS} levels, got {L}")
    if P not in POINTS:
        raise ValueError(f"the kernel takes {POINTS} points a level, got {P}")
    if min(B, Lq, M, D) < 1 or max(B, M) > 65535:
        raise ValueError(f"bad shape: B={B}, Lq={Lq}, heads={M}, D={D}")
    if Lq * M * L * P * 2 >= INT32 or Lq * M * D >= INT32:
        raise ValueError(f"{Lq} queries x {M} heads exceed 32-bit indices")
    vec = next(v for v in (16 // esize, 8 // esize, 4 // esize, 2 // esize)
               if v >= 1 and D % v == 0 and value_ptr_alignment % (v * esize)
               == 0)
    lanes = D // vec
    if lanes > BLOCK_THREADS:
        raise ValueError(f"a head of {lanes} lanes exceeds a block of "
                         f"{BLOCK_THREADS} threads")
    hpb = max(h for h in range(1, M + 1)
              if M % h == 0 and lanes * h <= BLOCK_THREADS)
    qpb = min(BLOCK_THREADS // (lanes * hpb), MAX_BLOCK_QUERIES)
    while qpb > 1 and -(-Lq // qpb) * B * (M // hpb) < 4 * SMS:
        qpb //= 2
    return MsdaPlan(vec, lanes, hpb, qpb, (-(-Lq // qpb), B, M // hpb))


def kernel_name(levels: int) -> str:
    """The launch count's name: K3 (the injectors' levels) or K4 (one)."""
    return "msda_multi_level" if levels > 1 else "msda_single_level"


def pointer_alignment(t: torch.Tensor) -> int:
    """The largest power of two, up to 16, that divides t's address."""
    ptr = t.data_ptr()
    return 16 if ptr % 16 == 0 else ptr & -ptr


@flops.counted(lambda args: kernel_name(len(args[1])))
def ms_deform_attn(value: torch.Tensor, spatial_shapes: Shapes,
                   reference_points: torch.Tensor, offsets: torch.Tensor,
                   attn_logits: torch.Tensor, n_heads: int,
                   n_points: int) -> torch.Tensor:
    """value (B, S, M*D) with S = sum(H_l * W_l); reference_points
    (B or 1, Lq, L, 2) as (x, y) in [0, 1]; offsets (B, Lq, M*L*P*2) in
    level pixels; attn_logits (B, Lq, M*L*P) before the softmax.
    Returns (B, Lq, M*D) in value's dtype."""
    tensors = (value, reference_points, offsets, attn_logits)
    if not kernels.use_kernel(kernel_name(len(spatial_shapes)), *tensors):
        return ms_deform_attn_plain(value, spatial_shapes, reference_points,
                                    offsets, attn_logits, n_heads, n_points)
    shapes = tuple(tuple(int(v) for v in hw) for hw in spatial_shapes)
    if kernels.records_grad(*tensors):
        return MSDeformAttnFunction.apply(*tensors, shapes, n_heads,
                                          n_points)
    return ms_deform_attn_cuda(value, shapes, reference_points, offsets,
                               attn_logits, n_heads, n_points)


def _plain_from_tensors(value, reference_points, offsets, attn_logits,
                        spatial_shapes, n_heads, n_points):
    return ms_deform_attn_plain(value, spatial_shapes, reference_points,
                                offsets, attn_logits, n_heads, n_points)


class MSDeformAttnFunction(torch.autograd.Function):
    """K3/K4 under autograd, the counterpart of the JAX package's
    _make_ms_deform_attn_flat_cached: the one-launch gather on the raw
    projections forward; backward, the autodiff of `ms_deform_attn_plain`
    recomputed, into value, offsets and attention logits (and the
    reference points only when they require grad)."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, value, reference_points, offsets, attn_logits,
                spatial_shapes, n_heads, n_points):
        ctx.save_for_backward(value, reference_points, offsets, attn_logits)
        ctx.args = (spatial_shapes, n_heads, n_points)
        return ms_deform_attn_cuda(value, spatial_shapes, reference_points,
                                   offsets, attn_logits, n_heads, n_points)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, grad):
        return kernels.plain_vjp(_plain_from_tensors, ctx.saved_tensors,
                                 ctx.args, grad,
                                 ctx.needs_input_grad[:4]) + (None,) * 3


def ms_deform_attn_plain(value, spatial_shapes: Shapes, reference_points,
                         offsets, attn_logits, n_heads: int,
                         n_points: int) -> torch.Tensor:
    """The plain version from the raw projections: the softmax over levels
    x points and the sampling locations in float32, then
    `ms_deform_attn_core_pytorch`."""
    B, Lq, _ = offsets.shape
    L, M, P = len(spatial_shapes), n_heads, n_points
    offs = offsets.float().view(B, Lq, M, L, P, 2)
    attn = attn_logits.float().view(B, Lq, M, L * P).softmax(-1)
    attn = attn.view(B, Lq, M, L, P)
    ref = reference_points.float()[:, :, None, :, None, :]
    wh = torch.tensor([[w, h] for h, w in spatial_shapes],
                      dtype=torch.float32, device=value.device)
    loc = ref + offs / wh[None, None, None, :, None, :]
    S = value.shape[1]
    v = value.float().view(B, S, M, -1)
    return ms_deform_attn_core_pytorch(v, spatial_shapes, loc,
                                       attn).to(value.dtype)


def ms_deform_attn_core_pytorch(value: torch.Tensor, spatial_shapes: Shapes,
                                sampling_locations: torch.Tensor,
                                attention_weights: torch.Tensor
                                ) -> torch.Tensor:
    """The plain version: per-level grid_sample (bilinear, zero padding,
    align_corners=False) and the attention-weighted sum.

    value (B, S, M, D); sampling_locations (B, Lq, M, L, P, 2) as (x, y)
    in [0, 1]; attention_weights (B, Lq, M, L, P). Returns (B, Lq, M*D).
    """
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    values = value.split([h * w for h, w in spatial_shapes], dim=1)
    grids = 2 * sampling_locations - 1
    samples = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        v = values[lvl].flatten(2).transpose(1, 2).reshape(B * M, D, h, w)
        g = grids[:, :, :, lvl].transpose(1, 2).flatten(0, 1)
        samples.append(F.grid_sample(v, g, mode="bilinear",
                                     padding_mode="zeros",
                                     align_corners=False))
    att = attention_weights.transpose(1, 2).reshape(B * M, 1, Lq, L * P)
    out = (torch.stack(samples, dim=-2).flatten(-2) * att).sum(-1)
    return out.view(B, M * D, Lq).transpose(1, 2).contiguous()


def ms_deform_attn_cuda(value: torch.Tensor, spatial_shapes: Shapes,
                        reference_points: torch.Tensor, offsets: torch.Tensor,
                        attn_logits: torch.Tensor, n_heads: int,
                        n_points: int) -> torch.Tensor:
    """The kernel on the raw projections, as `ms_deform_attn` takes them:
    value (B, S, M*D) contiguous; offsets (B, Lq, M*L*P*2) and attn_logits
    (B, Lq, M*L*P) contiguous and 16-byte aligned, in value's dtype;
    reference_points (B or 1, Lq, L, 2) float32 contiguous. One launch;
    returns (B, Lq, M*D)."""
    B, S, MD = value.shape
    L, M, P = len(spatial_shapes), n_heads, n_points
    Lq = offsets.shape[1]
    if MD % M:
        raise ValueError(f"value width {MD} is not a multiple of {M} heads")
    if S != sum(h * w for h, w in spatial_shapes):
        raise ValueError(f"value has {S} rows, the levels {spatial_shapes}")
    dt = value.dtype
    if value.device.type != "cuda" or not value.is_contiguous():
        raise ValueError("value: expected a contiguous CUDA tensor")
    kernels.check_operand("offsets", offsets, dt, (B, Lq, M * L * P * 2))
    kernels.check_operand("attn_logits", attn_logits, dt, (B, Lq, M * L * P))
    Bref = reference_points.shape[0]
    if Bref not in (1, B) or not reference_points.is_contiguous() or (
            reference_points.dtype != torch.float32) or tuple(
            reference_points.shape[1:]) != (Lq, L, 2) or (
            reference_points.device != value.device):
        raise ValueError(f"reference_points: expected contiguous float32 "
                         f"(1 or {B}, {Lq}, {L}, 2) on {value.device}, got "
                         f"{reference_points.dtype} "
                         f"{tuple(reference_points.shape)}")
    plan = msda_plan(B, Lq, M, MD // M, L, P, dt, pointer_alignment(value))
    if S * MD >= INT32:
        raise ValueError(f"value {tuple(value.shape)} exceeds 32-bit indices")
    shapes = (ctypes.c_int * (2 * L))(
        *[int(v) for hw in spatial_shapes for v in hw])
    out = torch.empty((B, Lq, MD), dtype=dt, device=value.device)
    lib = kernels.library()
    with torch.cuda.device(value.device):
        status = lib.msa_deform_attn(
            value.data_ptr(), offsets.data_ptr(), attn_logits.data_ptr(),
            reference_points.data_ptr(), out.data_ptr(), B, Lq, S, M,
            MD // M, L, P, shapes, 0 if Bref == 1 else Lq * L * 2,
            plan.vec, plan.lanes, plan.heads_per_block,
            plan.queries_per_block, plan.grid[0],
            kernels.dtype_code(value), kernels.current_stream(value))
    kernels.check_status(kernel_name(L), status)
    kernels.count_launch(kernel_name(L))
    return out
