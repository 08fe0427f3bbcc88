"""K5: one ConvNeXt block, fused.

`convnext_block` takes a channels-last map x (B, H, W, C) and the block's
parameters in torch's own layouts (depthwise weight (C, 1, 7, 7), Linear
weights (HID, C) and (C, HID)) and returns the block OUTPUT, the shortcut
added: x + gamma * (fc2(gelu(fc1(LN(dwconv(x))))) + b2). (The TPU kernel
returns the pre-residual delta and leaves the add to XLA; here the add is
the kernel's epilogue, which saves one pass over the map.) On a CUDA tensor
it launches the hand-written kernel (csrc/convnext_block.cu), on a CPU
tensor it runs the plain version, `convnext_block_plain`.

Replaces multimodal_sam_adapter_tpu/ops/convnext_block.py:
convnext_block_fused_fwd (Pallas).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import kernels


def convnext_block(x: torch.Tensor, dw: torch.Tensor, dw_b: torch.Tensor,
                   ln_g: torch.Tensor, ln_b: torch.Tensor, w1: torch.Tensor,
                   b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                   gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    if kernels.use_kernel(x):
        return convnext_block_cuda(x, dw, dw_b, ln_g, ln_b, w1, b1, w2, b2,
                                   gamma, eps)
    return convnext_block_plain(x, dw, dw_b, ln_g, ln_b, w1, b1, w2, b2,
                                gamma, eps)


def convnext_block_plain(x, dw, dw_b, ln_g, ln_b, w1, b1, w2, b2, gamma,
                         eps: float = 1e-6) -> torch.Tensor:
    """The reference block's composition on a channels-last map: depthwise
    conv, LayerNorm, Linear, exact GELU, Linear, layer scale, shortcut."""
    C = x.shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2), dw, dw_b, padding=3, groups=C)
    y = F.layer_norm(y.permute(0, 2, 3, 1), (C,), ln_g, ln_b, eps)
    y = F.linear(F.gelu(F.linear(y, w1, b1)), w2, b2)
    return x + y * gamma.to(y.dtype)


def convnext_block_cuda(x, dw, dw_b, ln_g, ln_b, w1, b1, w2, b2, gamma,
                        eps: float = 1e-6) -> torch.Tensor:
    """x (B, H, W, C) contiguous; every parameter of x's dtype and device.
    C and HID multiples of 8, C at most 768. Returns x + block(x)."""
    B, H, W, C = x.shape
    HID = w1.shape[0]
    if C % 8 or HID % 8 or C > 768:
        raise ValueError(f"the kernel takes C, HID multiples of 8 and "
                         f"C <= 768, got C={C}, HID={HID}")
    dt = x.dtype
    kernels.check_operand("x", x, dt)
    kernels.check_operand("dw", dw, dt, (C, 1, 7, 7))
    kernels.check_operand("w1", w1, dt, (HID, C))
    kernels.check_operand("w2", w2, dt, (C, HID))
    kernels.check_operand("b1", b1, dt, (HID,))
    for name, t in (("dw_b", dw_b), ("ln_g", ln_g), ("ln_b", ln_b),
                    ("b2", b2), ("gamma", gamma)):
        kernels.check_operand(name, t, dt, (C,))
    out = torch.empty_like(x)
    lib = kernels.library()
    splits, partials, counters = 1, None, None
    if dt == torch.bfloat16:
        # the kernel's plan: blocks per pixel tile that share its hidden axis
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        n = ctypes.c_int(1)
        tiles = lib.msa_convnext_block_plan(B, H, W, C, HID, sms,
                                            ctypes.byref(n))
        splits = n.value
        if splits > 1:
            partials = torch.empty((splits, B * H * W, C),
                                   dtype=torch.float32, device=x.device)
            counters = torch.zeros(tiles, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        status = lib.msa_convnext_block(
            x.data_ptr(), dw.data_ptr(), dw_b.data_ptr(), ln_g.data_ptr(),
            ln_b.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), gamma.data_ptr(), out.data_ptr(), B, H, W, C, HID,
            float(eps), splits,
            None if partials is None else partials.data_ptr(),
            None if counters is None else counters.data_ptr(),
            kernels.dtype_code(x), kernels.current_stream(x))
    kernels.check_status("convnext_block", status)
    kernels.count_launch("convnext_block")
    return out
