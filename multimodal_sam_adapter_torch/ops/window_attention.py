"""K1: windowed attention with the decomposed rel-pos bias.

`window_attention` takes the raw (windows, N, 3*C) qkv projection and
returns the heads-packed (windows, N, C) output. On a CUDA tensor it
launches the hand-written kernel (csrc/window_attention.cu), on a CPU tensor
it runs the plain version, `window_attention_plain`.

Replaces multimodal_sam_adapter_tpu/ops/window_attention.py:
window_attention_laneblock_fwd (Pallas).
"""
from __future__ import annotations

import torch

from . import kernels
from .attention import (attention_with_decomposed_rel_pos, get_rel_pos,
                        merge_heads, split_heads)


def window_attention(qkv: torch.Tensor, rel_pos_h: torch.Tensor,
                     rel_pos_w: torch.Tensor, ws: int, num_heads: int,
                     scale: float) -> torch.Tensor:
    if kernels.use_kernel(qkv):
        N = ws * ws
        d = qkv.shape[-1] // (3 * num_heads)
        rh = get_rel_pos(ws, ws, rel_pos_h).reshape(N, d).to(qkv.dtype)
        rw = get_rel_pos(ws, ws, rel_pos_w).reshape(N, d).to(qkv.dtype)
        return window_attention_cuda(qkv, rh.contiguous(), rw.contiguous(),
                                     ws, num_heads, scale)
    return window_attention_plain(qkv, rel_pos_h, rel_pos_w, ws, num_heads,
                                  scale)


def window_attention_plain(qkv, rel_pos_h, rel_pos_w, ws: int,
                           num_heads: int, scale: float) -> torch.Tensor:
    q, k, v = split_heads(qkv, num_heads)
    o = attention_with_decomposed_rel_pos(q, k, v, rel_pos_h, rel_pos_w,
                                          (ws, ws), scale)
    return merge_heads(o, num_heads)


def window_attention_cuda(qkv: torch.Tensor, rh: torch.Tensor,
                          rw: torch.Tensor, ws: int, num_heads: int,
                          scale: float) -> torch.Tensor:
    """qkv (windows, ws*ws, 3*C); rh, rw: (ws*ws, d) get_rel_pos tables,
    row qh * ws + kh. Returns (windows, ws*ws, C)."""
    Wn, N, F3 = qkv.shape
    C = F3 // 3
    d = C // num_heads
    if N != ws * ws or F3 != 3 * num_heads * d:
        raise ValueError(f"qkv {tuple(qkv.shape)} does not match ws={ws}, "
                         f"heads={num_heads}")
    if Wn * num_heads > 65535:
        raise ValueError(f"{Wn} windows x {num_heads} heads exceed the grid")
    kernels.check_operand("qkv", qkv, qkv.dtype)
    kernels.check_operand("rh", rh, qkv.dtype, (N, d))
    kernels.check_operand("rw", rw, qkv.dtype, (N, d))
    out = torch.empty((Wn, N, C), dtype=qkv.dtype, device=qkv.device)
    lib = kernels.library()
    with torch.cuda.device(qkv.device):
        status = lib.msa_window_attention(
            qkv.data_ptr(), rh.data_ptr(), rw.data_ptr(), out.data_ptr(),
            Wn, num_heads, d, ws, float(scale), kernels.dtype_code(qkv),
            kernels.current_stream(qkv))
    kernels.check_status("window_attention", status)
    kernels.count_launch("window_attention")
    return out
