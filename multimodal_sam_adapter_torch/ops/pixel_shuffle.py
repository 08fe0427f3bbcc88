"""K6: the eval-mode f1 assembly of the backbone, fused.

`pixel_shuffle_up_bn` computes f1 = (ConvTranspose2d_2x2s2(c2) + c1 + x1) *
scale + shift, the eval BatchNorm as a per-channel affine with the
transposed conv's bias folded into `shift`. On a CUDA tensor it launches
the hand-written kernel (csrc/pixel_shuffle.cu): one GEMM whose epilogue
writes each (dy, dx) phase to its interleaved output pixel, so the
depth-to-space never exists as a tensor. On a CPU tensor it runs the plain
version, `pixel_shuffle_up_bn_plain`.

Replaces multimodal_sam_adapter_tpu/ops/pixel_shuffle.py:
pixel_shuffle_up_bn (Pallas).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import kernels


def pixel_shuffle_up_bn(c2: torch.Tensor, weight: torch.Tensor,
                        c1: torch.Tensor, x1: torch.Tensor,
                        scale: torch.Tensor, shift: torch.Tensor
                        ) -> torch.Tensor:
    """c2 (B, C, H, W); weight (C, O, 2, 2), torch's ConvTranspose2d layout;
    c1, x1 (B, O, 2H, 2W); scale, shift (O,) float32. Returns
    (B, O, 2H, 2W) in c1's dtype."""
    if kernels.use_kernel("pixel_shuffle_up_bn", c2, weight, c1, x1, scale,
                          shift):
        return pixel_shuffle_up_bn_cuda(c2, weight, c1, x1, scale, shift)
    return pixel_shuffle_up_bn_plain(c2, weight, c1, x1, scale, shift)


def pixel_shuffle_up_bn_plain(c2, weight, c1, x1, scale, shift
                              ) -> torch.Tensor:
    y = F.conv_transpose2d(c2, weight, None, stride=2) + c1 + x1
    out = y.float() * scale[:, None, None] + shift[:, None, None]
    return out.to(c1.dtype)


def pixel_shuffle_up_bn_cuda(c2, weight, c1, x1, scale, shift
                             ) -> torch.Tensor:
    """c2 must hold its pixels as rows of C contiguous values (a
    channels-last map, or a view of a token stream), any batch stride; c1
    and x1 any strides. C % 8 == 0, O % 32 == 0."""
    B, C, H, W = c2.shape
    O = weight.shape[1]
    if C % 8 or O % 32:
        raise ValueError(f"the kernel takes C % 8 == 0 and O % 32 == 0, "
                         f"got C={C}, O={O}")
    dt = c2.dtype
    if c2.device.type != "cuda" or c2.dtype not in (torch.float32,
                                                    torch.bfloat16):
        raise TypeError(f"c2: expected a float32/bfloat16 CUDA tensor")
    if (c2.stride(1) != 1 or c2.stride(3) != C or c2.stride(2) != W * C
            or c2.stride(0) % 8 or c2.data_ptr() % 16):
        raise ValueError(f"c2: expected pixel rows of C contiguous values, "
                         f"got strides {c2.stride()}")
    kernels.check_operand("weight", weight, dt, (C, O, 2, 2))
    kernels.check_operand("scale", scale, torch.float32, (O,))
    kernels.check_operand("shift", shift, torch.float32, (O,))
    for name, t in (("c1", c1), ("x1", x1)):
        if t.device != c2.device or t.dtype != dt:
            raise TypeError(f"{name}: expected {dt} on {c2.device}")
        if tuple(t.shape) != (B, O, 2 * H, 2 * W):
            raise ValueError(f"{name}: expected shape {(B, O, 2 * H, 2 * W)},"
                             f" got {tuple(t.shape)}")
    out = torch.empty((B, O, 2 * H, 2 * W), dtype=dt, device=c2.device)
    lib = kernels.library()
    with torch.cuda.device(c2.device):
        status = lib.msa_pixel_shuffle_up_bn(
            c2.data_ptr(), c2.stride(0), weight.data_ptr(), c1.data_ptr(),
            *c1.stride(), x1.data_ptr(), *x1.stride(), scale.data_ptr(),
            shift.data_ptr(), out.data_ptr(), B, H, W, C, O,
            kernels.dtype_code(c2), kernels.current_stream(c2))
    kernels.check_status("pixel_shuffle_up_bn", status)
    kernels.count_launch("pixel_shuffle_up_bn")
    return out
