"""K2: global attention with the decomposed rel-pos bias.

`flash_attention` takes the raw (B, N, 3*C) qkv projection over an (H, W)
token grid and returns the heads-packed (B, N, C) output. On a CUDA tensor
it launches the hand-written kernel (csrc/flash_attention.cu): bfloat16 on
the wgmma/TMA core, which computes the rel terms itself from the resized
(2H - 1, d) and (2W - 1, d) tables (`rel_table_parts`); float32 on the
CUDA cores, with the rel terms computed in torch (`rel_terms`). On a CPU
tensor it runs the plain version, `flash_attention_plain`.

Replaces multimodal_sam_adapter_tpu/ops/flash_attention.py:
flash_attention_lane (Pallas). The TPU path derives the rel terms from a
second q projection (a TPU layout workaround); here q is sliced from qkv.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import kernels
from .attention import (attention_with_decomposed_rel_pos,
                        check_table_parts, get_rel_pos, merge_heads,
                        rel_table_parts, split_heads)

# the bf16 kernel's key tile: two whole grid rows in 128 rows of shared
# memory, so a grid side is at most 64 (and its table 127 rows)
GLOBAL_TILE_KEYS = 128
GLOBAL_TILE_ROWS = 2


def global_key_tiles(q_hw: Tuple[int, int]) -> int:
    """Key tiles of the bf16 kernel over an (H, W) grid: tiles of two grid
    rows (2W <= 128 keys, the rest of the tile masked), ceil(H / 2) of
    them; the last holds one row when H is odd."""
    H, W = q_hw
    side = GLOBAL_TILE_KEYS // GLOBAL_TILE_ROWS
    if not (1 <= H <= side and 1 <= W <= side):
        raise ValueError(f"grid {H}x{W}: the bf16 kernel takes grid sides "
                         f"of at most {side}")
    return -(-H // GLOBAL_TILE_ROWS)


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
    if not kernels.use_kernel(qkv):
        return flash_attention_plain(qkv, rel_pos_h, rel_pos_w, q_hw,
                                     num_heads, scale)
    H, W = q_hw
    if qkv.dtype == torch.bfloat16:
        return flash_attention_bf16_cuda(
            qkv, rel_table_parts(rel_pos_h, H), rel_table_parts(rel_pos_w, W),
            q_hw, num_heads, scale)
    rel_h, rel_w = rel_terms(qkv, rel_pos_h, rel_pos_w, q_hw, num_heads)
    return flash_attention_cuda(qkv, rel_h, rel_w, q_hw, num_heads, scale)


def flash_attention_plain(qkv, rel_pos_h, rel_pos_w, q_hw: Tuple[int, int],
                          num_heads: int, scale: float) -> torch.Tensor:
    q, k, v = split_heads(qkv, num_heads)
    o = attention_with_decomposed_rel_pos(q, k, v, rel_pos_h, rel_pos_w,
                                          tuple(q_hw), scale)
    return merge_heads(o, num_heads)


def _check_qkv(qkv: torch.Tensor, q_hw: Tuple[int, int], num_heads: int):
    B, N, F3 = qkv.shape
    H, W = q_hw
    C = F3 // 3
    d = C // num_heads
    if N != H * W or F3 != 3 * num_heads * d:
        raise ValueError(f"qkv {tuple(qkv.shape)} does not match grid "
                         f"{q_hw}, heads={num_heads}")
    if B * num_heads > 65535:
        raise ValueError(f"batch {B} x {num_heads} heads exceed the grid")
    return B, N, C, d


def flash_attention_cuda(qkv: torch.Tensor, rel_h: torch.Tensor,
                         rel_w: torch.Tensor, q_hw: Tuple[int, int],
                         num_heads: int, scale: float) -> torch.Tensor:
    """float32: qkv (B, H*W, 3*C); rel_h (B*heads, H*W, H) and rel_w
    (B*heads, H*W, W) float32. Returns (B, H*W, C)."""
    B, N, C, d = _check_qkv(qkv, q_hw, num_heads)
    H, W = q_hw
    kernels.check_operand("qkv", qkv, torch.float32)
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
            kernels.current_stream(qkv))
    kernels.check_status("flash_attention", status)
    kernels.count_launch("flash_attention")
    return out


def flash_attention_bf16_cuda(qkv: torch.Tensor, th: torch.Tensor,
                              tw: torch.Tensor, q_hw: Tuple[int, int],
                              num_heads: int, scale: float) -> torch.Tensor:
    """bfloat16: qkv (B, H*W, 3*C); th (parts, 2H - 1, d) and tw (parts,
    2W - 1, d) the rel-pos tables of `rel_table_parts`. Returns
    (B, H*W, C)."""
    B, N, C, d = _check_qkv(qkv, q_hw, num_heads)
    H, W = q_hw
    tiles = global_key_tiles(q_hw)
    kernels.check_operand("qkv", qkv, torch.bfloat16)
    check_table_parts("th", th, 2 * H - 1, d)
    check_table_parts("tw", tw, 2 * W - 1, d)
    out = torch.empty((B, N, C), dtype=qkv.dtype, device=qkv.device)
    lib = kernels.library()
    with torch.cuda.device(qkv.device):
        status = lib.msa_flash_attention_bf16(
            qkv.data_ptr(), th.data_ptr(), tw.data_ptr(), out.data_ptr(), B,
            num_heads, d, H, W, tiles, th.shape[0], tw.shape[0], float(scale),
            kernels.current_stream(qkv))
    kernels.check_status("flash_attention", status)
    kernels.count_launch("flash_attention")
    return out
