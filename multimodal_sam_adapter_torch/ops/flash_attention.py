"""K2: global attention with the decomposed rel-pos bias.

`flash_attention` takes the raw (B, N, 3*C) qkv projection over an (H, W)
token grid and returns the heads-packed (B, N, C) output. On a CUDA tensor
it launches the hand-written kernel (csrc/flash_attention.cu): bfloat16 on
the wgmma/TMA core, which computes the rel terms itself from the resized
(2H - 1, d) and (2W - 1, d) tables (`rel_table_parts`); float32 on the
CUDA cores, with the rel terms computed in torch (`rel_terms`). When
autograd records the call it goes through `FlashAttentionFunction`: the
kernel forward, and as its backward the plain version's autodiff one band
of query rows at a time (`flash_attention_backward`). On a CPU tensor it
runs the plain version, `flash_attention_plain`.

Replaces multimodal_sam_adapter_tpu/ops/flash_attention.py:
flash_attention_lane (Pallas), and its custom_vjp _make_diff_flash_lane
with the banded backward _dense_flash_bwd. The TPU path derives the rel
terms from a second q projection (a TPU layout workaround); here q is
sliced from qkv, and the rel terms' dq is added into qkv's q slice.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..utils import flops
from . import kernels
from .attention import (attention_with_decomposed_rel_pos,
                        check_table_parts, get_rel_pos, merge_heads,
                        rel_pos_bias_terms, rel_table_parts, scores_f32,
                        split_heads)

# the bf16 kernel's key tile: two whole grid rows in 128 rows of shared
# memory, so a grid side is at most 64 (and its table 127 rows)
GLOBAL_TILE_KEYS = 128
GLOBAL_TILE_ROWS = 2
# query rows a band of the backward recomputes at once: the first that
# divides N (the JAX package's _dense_flash_bwd), else all N. At 64^2 x 16
# heads a band of 512 holds a (16, 512, 4096) float32 score matrix, 134 MB,
# where the whole (16, 4096, 4096) stack would take 1.07 GB
BACKWARD_BANDS = (512, 384, 256, 128, 64)


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


@flops.counted("flash_attention")
def flash_attention(qkv: torch.Tensor, rel_pos_h: torch.Tensor,
                    rel_pos_w: torch.Tensor, q_hw: Tuple[int, int],
                    num_heads: int, scale: float) -> torch.Tensor:
    if not kernels.use_kernel("flash_attention", qkv, rel_pos_h,
                              rel_pos_w):
        return flash_attention_plain(qkv, rel_pos_h, rel_pos_w, q_hw,
                                     num_heads, scale)
    if kernels.records_grad(qkv, rel_pos_h, rel_pos_w):
        return FlashAttentionFunction.apply(qkv, rel_pos_h, rel_pos_w,
                                            tuple(q_hw), num_heads, scale)
    return flash_attention_kernel(qkv, rel_pos_h, rel_pos_w, q_hw, num_heads,
                                  scale)


def flash_attention_kernel(qkv, rel_pos_h, rel_pos_w, q_hw: Tuple[int, int],
                           num_heads: int, scale: float) -> torch.Tensor:
    """The kernel's launch for `qkv`'s dtype, with its tables or rel terms
    built from the rel-pos parameters."""
    H, W = q_hw
    if qkv.dtype == torch.bfloat16:
        return flash_attention_bf16_cuda(
            qkv, rel_table_parts(rel_pos_h, H), rel_table_parts(rel_pos_w, W),
            q_hw, num_heads, scale)
    rel_h, rel_w = rel_terms(qkv, rel_pos_h, rel_pos_w, q_hw, num_heads)
    return flash_attention_cuda(qkv, rel_h, rel_w, q_hw, num_heads, scale)


def band_attention(q, k, v, rel_h, rel_w, scale: float) -> torch.Tensor:
    """The plain attention of a band of queries given their rel terms:
    q (B, C, d) against k, v (B, N, d); rel_h (B, C, H) and rel_w
    (B, C, W) with N = H * W. The arithmetic of
    `attention_with_decomposed_rel_pos`, the bias summed first."""
    attn = scores_f32(q * scale, k)
    bias = rel_h.float()[..., :, None] + rel_w.float()[..., None, :]
    attn = (attn + bias.flatten(-2)).softmax(dim=-1)
    return torch.matmul(attn.to(v.dtype), v)


def flash_attention_backward(qkv, rel_pos_h, rel_pos_w, grad,
                             q_hw: Tuple[int, int], num_heads: int,
                             scale: float):
    """(dqkv, drel_pos_h, drel_pos_w) of `flash_attention_plain` at these
    inputs against `grad` (B, N, C), computed as the JAX package's
    _dense_flash_bwd does: the rel terms once, then the attention one band
    of `BACKWARD_BANDS` query rows at a time, recomputed under autograd
    (one band's score matrix live at a time), dk and dv summed over the
    bands in float32, and the rel terms' gradient taken back through them
    to the tables and to q (dq2, added into qkv's q slice)."""
    H, W = q_hw
    B, N, F3 = qkv.shape
    d = F3 // (3 * num_heads)
    BM = B * num_heads
    q, k, v = (t.detach() for t in split_heads(qkv, num_heads))
    g = grad.reshape(B, N, num_heads, d).transpose(1, 2).reshape(BM, N, d)
    with torch.enable_grad():
        q_rel = q.clone().requires_grad_()
        tables = (rel_pos_h.detach().requires_grad_(),
                  rel_pos_w.detach().requires_grad_())
        rel_h, rel_w = rel_pos_bias_terms(q_rel, *tables, q_hw, q_hw)
    rh = rel_h.detach().reshape(BM, N, H)
    rw = rel_w.detach().reshape(BM, N, W)
    band = next((c for c in BACKWARD_BANDS if N % c == 0), N)
    dq, drh, drw = (torch.empty_like(t) for t in (q, rh, rw))
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
    with torch.enable_grad():
        kv = (k.requires_grad_(), v.requires_grad_())
        for s in range(0, N, band):
            rows = slice(s, s + band)
            qc, rhc, rwc = (t[:, rows].detach().requires_grad_()
                            for t in (q, rh, rw))
            out = band_attention(qc, *kv, rhc, rwc, scale)
            gq, grh, grw, gk, gv = torch.autograd.grad(
                out, (qc, rhc, rwc, *kv), g[:, rows].to(out.dtype))
            dq[:, rows], drh[:, rows], drw[:, rows] = gq, grh, grw
            dk += gk
            dv += gv
        dq2, drph, drpw = torch.autograd.grad(
            (rel_h, rel_w), (q_rel, *tables),
            (drh.view(rel_h.shape).to(rel_h.dtype),
             drw.view(rel_w.shape).to(rel_w.dtype)))
    dqkv = torch.stack((dq + dq2.to(dq.dtype), dk.to(k.dtype),
                        dv.to(v.dtype)))
    dqkv = dqkv.view(3, B, num_heads, N, d).permute(1, 3, 0, 2, 4)
    return dqkv.reshape(B, N, F3), drph, drpw


class FlashAttentionFunction(torch.autograd.Function):
    """K2 under autograd, the counterpart of the JAX package's
    _make_diff_flash_lane: the kernel on the raw qkv forward; backward,
    `flash_attention_backward` (banded), into qkv and both rel-pos
    parameters."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, qkv, rel_pos_h, rel_pos_w, q_hw, num_heads, scale):
        ctx.save_for_backward(qkv, rel_pos_h, rel_pos_w)
        ctx.args = (q_hw, num_heads, scale)
        return flash_attention_kernel(qkv, rel_pos_h, rel_pos_w, q_hw,
                                      num_heads, scale)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, grad):
        grads = flash_attention_backward(*ctx.saved_tensors, grad, *ctx.args)
        return tuple(g if need else None for g, need in zip(
            grads, ctx.needs_input_grad)) + (None,) * 3


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
