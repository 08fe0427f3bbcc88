"""K3/K4: multi-scale deformable attention sampling.

`ms_deform_attn` takes the module's raw projections (value, sampling
offsets, attention logits) and the reference points, and returns the
sampled (B, Lq, heads * D) output. On a CUDA tensor it computes the absolute
sampling coordinates and the softmax over levels x points in torch and
launches the hand-written direct-gather kernel (csrc/msda.cu); the level
count is a launch parameter, so the same kernel serves the 3-level
injectors (K3) and the 1-level extractors (K4). On a CPU tensor it runs the
plain `grid_sample` version, `ms_deform_attn_core_pytorch`.

Replaces multimodal_sam_adapter_tpu/ops/msda_pallas.py:
_digit_pallas_call_multi_prep (K3) and _digit_pallas_call_prep (K4).
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from . import kernels

Shapes = Sequence[Tuple[int, int]]


def ms_deform_attn(value: torch.Tensor, spatial_shapes: Shapes,
                   reference_points: torch.Tensor, offsets: torch.Tensor,
                   attn_logits: torch.Tensor, n_heads: int,
                   n_points: int) -> torch.Tensor:
    """value (B, S, M*D) with S = sum(H_l * W_l); reference_points
    (B or 1, Lq, L, 2) as (x, y) in [0, 1]; offsets (B, Lq, M*L*P*2) in
    level pixels; attn_logits (B, Lq, M*L*P) before the softmax.
    Returns (B, Lq, M*D) in value's dtype."""
    B, Lq, _ = offsets.shape
    L, M, P = len(spatial_shapes), n_heads, n_points
    offs = offsets.float().view(B, Lq, M, L, P, 2)
    attn = attn_logits.float().view(B, Lq, M, L * P).softmax(-1)
    attn = attn.view(B, Lq, M, L, P)
    ref = reference_points.float()[:, :, None, :, None, :]
    wh = torch.tensor([[w, h] for h, w in spatial_shapes],
                      dtype=torch.float32, device=value.device)
    wh = wh[None, None, None, :, None, :]
    if kernels.use_kernel(value):
        coords = (ref * wh + offs - 0.5).expand(B, Lq, M, L, P, 2)
        return ms_deform_attn_cuda(value, spatial_shapes,
                                   coords.contiguous(), attn.contiguous(),
                                   n_heads)
    loc = ref + offs / wh
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
                        coords: torch.Tensor, attn: torch.Tensor,
                        n_heads: int) -> torch.Tensor:
    """value (B, S, M*D); coords (B, Lq, M, L, P, 2) float32 absolute level
    pixel coordinates (x, y); attn (B, Lq, M, L, P) float32 softmaxed
    weights. Returns (B, Lq, M*D)."""
    B, S, MD = value.shape
    _, Lq, M, L, P, _ = coords.shape
    if M != n_heads or MD % M or L != len(spatial_shapes):
        raise ValueError("value, coords and spatial_shapes disagree")
    if S != sum(h * w for h, w in spatial_shapes):
        raise ValueError(f"value has {S} rows, the levels {spatial_shapes}")
    kernels.check_operand("value", value, value.dtype)
    kernels.check_operand("coords", coords, torch.float32, (B, Lq, M, L, P, 2))
    kernels.check_operand("attn", attn, torch.float32, (B, Lq, M, L, P))
    shapes = (ctypes.c_int * (2 * L))(
        *[int(v) for hw in spatial_shapes for v in hw])
    out = torch.empty((B, Lq, MD), dtype=value.dtype, device=value.device)
    lib = kernels.library()
    with torch.cuda.device(value.device):
        status = lib.msa_deform_attn(
            value.data_ptr(), coords.data_ptr(), attn.data_ptr(),
            out.data_ptr(), B, Lq, S, M, MD // M, L, P, shapes,
            kernels.dtype_code(value), kernels.current_stream(value))
    name = "msda_multi_level" if L > 1 else "msda_single_level"
    kernels.check_status(name, status)
    kernels.count_launch(name)
    return out
