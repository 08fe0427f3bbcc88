"""K2: global attention with the decomposed rel-pos bias.

`flash_attention` takes the raw (B, N, 3*C) qkv projection over an (H, W)
token grid and returns the heads-packed (B, N, C) output. On a CUDA tensor
it computes the rel terms in torch and launches the hand-written
online-softmax kernel (csrc/flash_attention.cu); on a CPU tensor it runs the
plain version, `flash_attention_plain`.

Replaces multimodal_sam_adapter_tpu/ops/flash_attention.py:
flash_attention_lane (Pallas). The TPU path derives the rel terms from a
second q projection (a TPU layout workaround); here q is sliced from qkv.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import kernels
from .attention import (attention_with_decomposed_rel_pos, get_rel_pos,
                        merge_heads, split_heads)


def rel_terms(qkv: torch.Tensor, rel_pos_h: torch.Tensor,
              rel_pos_w: torch.Tensor, q_hw: Tuple[int, int],
              num_heads: int):
    """rel_h (B*heads, N, H) and rel_w (B*heads, N, W) from the q slice of
    qkv, in float32: at bf16 their rounding alone would move the softmax
    (the terms reach |q| |R| ~ 10)."""
    B, N, F3 = qkv.shape
    C = F3 // 3
    d = C // num_heads
    H, W = q_hw
    r_q = qkv[..., :C].reshape(B, H, W, num_heads, d).float()
    Rh = get_rel_pos(H, H, rel_pos_h).float()
    Rw = get_rel_pos(W, W, rel_pos_w).float()
    rel_h = torch.einsum("bhwmc,hkc->bmhwk", r_q, Rh).reshape(
        B * num_heads, N, H)
    rel_w = torch.einsum("bhwmc,wkc->bmhwk", r_q, Rw).reshape(
        B * num_heads, N, W)
    return rel_h.contiguous(), rel_w.contiguous()


def flash_attention(qkv: torch.Tensor, rel_pos_h: torch.Tensor,
                    rel_pos_w: torch.Tensor, q_hw: Tuple[int, int],
                    num_heads: int, scale: float) -> torch.Tensor:
    if kernels.use_kernel(qkv):
        rel_h, rel_w = rel_terms(qkv, rel_pos_h, rel_pos_w, q_hw, num_heads)
        return flash_attention_cuda(qkv, rel_h, rel_w, q_hw, num_heads,
                                    scale)
    return flash_attention_plain(qkv, rel_pos_h, rel_pos_w, q_hw, num_heads,
                                 scale)


def flash_attention_plain(qkv, rel_pos_h, rel_pos_w, q_hw: Tuple[int, int],
                          num_heads: int, scale: float) -> torch.Tensor:
    q, k, v = split_heads(qkv, num_heads)
    o = attention_with_decomposed_rel_pos(q, k, v, rel_pos_h, rel_pos_w,
                                          tuple(q_hw), scale)
    return merge_heads(o, num_heads)


def flash_attention_cuda(qkv: torch.Tensor, rel_h: torch.Tensor,
                         rel_w: torch.Tensor, q_hw: Tuple[int, int],
                         num_heads: int, scale: float) -> torch.Tensor:
    """qkv (B, H*W, 3*C); rel_h (B*heads, H*W, H) and rel_w
    (B*heads, H*W, W) float32. Returns (B, H*W, C)."""
    B, N, F3 = qkv.shape
    H, W = q_hw
    C = F3 // 3
    d = C // num_heads
    if N != H * W or F3 != 3 * num_heads * d:
        raise ValueError(f"qkv {tuple(qkv.shape)} does not match grid "
                         f"{q_hw}, heads={num_heads}")
    if B * num_heads > 65535:
        raise ValueError(f"batch {B} x {num_heads} heads exceed the grid")
    kernels.check_operand("qkv", qkv, qkv.dtype)
    kernels.check_operand("rel_h", rel_h, torch.float32,
                          (B * num_heads, N, H))
    kernels.check_operand("rel_w", rel_w, torch.float32,
                          (B * num_heads, N, W))
    out = torch.empty((B, N, C), dtype=qkv.dtype, device=qkv.device)
    lib = kernels.library()
    with torch.cuda.device(qkv.device):
        status = lib.msa_flash_attention(
            qkv.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(),
            out.data_ptr(), B, num_heads, d, H, W, float(scale),
            kernels.dtype_code(qkv), kernels.current_stream(qkv))
    kernels.check_status("flash_attention", status)
    kernels.count_launch("flash_attention")
    return out
