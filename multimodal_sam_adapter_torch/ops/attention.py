"""Windowed attention with the decomposed relative-position bias (ViTDet /
SAM), plain PyTorch: the counterpart of multimodal_sam_adapter_tpu/ops/
attention.py.

`attention_with_decomposed_rel_pos` is the plain version of both attention
kernels (ops/window_attention.py and ops/flash_attention.py).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..utils.interpolate import interp_linear_1d
from . import kernels


def window_partition(x: torch.Tensor, window_size: int):
    """(B, H, W, C) -> (B * nW, ws, ws, C), zero-padding H and W up to a
    multiple of the window. Returns the windows and the padded (Hp, Wp)."""
    B, H, W, C = x.shape
    pad_h = (window_size - H % window_size) % window_size
    pad_w = (window_size - W % window_size) % window_size
    if pad_h or pad_w:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.view(B, Hp // window_size, window_size, Wp // window_size,
               window_size, C)
    windows = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window_size,
                                                   window_size, C)
    return windows, (Hp, Wp)


def window_unpartition(windows: torch.Tensor, window_size: int,
                       pad_hw: Tuple[int, int],
                       hw: Tuple[int, int]) -> torch.Tensor:
    """Inverse of `window_partition`, cropping the padding back off."""
    Hp, Wp = pad_hw
    H, W = hw
    B = windows.shape[0] // (Hp * Wp // window_size // window_size)
    x = windows.view(B, Hp // window_size, Wp // window_size, window_size,
                     window_size, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    if Hp > H or Wp > W:
        x = x[:, :H, :W].contiguous()
    return x


def resized_rel_table(rel_pos: torch.Tensor, size: int) -> torch.Tensor:
    """The (L, C) rel-pos table linearly resized to the 2 * size - 1 rows of
    a grid side of `size` (returned as is when it has them)."""
    return interp_linear_1d(rel_pos, 2 * size - 1)


def rel_table_parts(rel_pos: torch.Tensor, size: int) -> torch.Tensor:
    """The bf16 kernels' form of a rel-pos table for a grid side of `size`:
    (parts, 2 * size - 1, C) bf16. A bf16 table of 2 * size - 1 rows is
    its own single part (a view, no copy); any other table is resized in
    float32 and split into (hi, lo) with hi + lo equal to the float32
    table to ~2^-16 relative (bf16 alone would move the bias by ~1e-2)."""
    if rel_pos.dtype == torch.bfloat16 and rel_pos.shape[0] == 2 * size - 1:
        return rel_pos.contiguous()[None]
    t = resized_rel_table(rel_pos.float(), size)
    hi = t.to(torch.bfloat16)
    return torch.stack((hi, (t - hi.float()).to(torch.bfloat16)))


def check_table_parts(name: str, t: torch.Tensor, rows: int,
                      d: int) -> None:
    """The bf16 kernels' check of a `rel_table_parts` table: (1 or 2
    parts, rows, d) bf16, contiguous, on the card."""
    kernels.check_operand(name, t, torch.bfloat16)
    if t.dim() != 3 or t.shape[0] not in (1, 2) or tuple(t.shape[1:]) != (
            rows, d):
        raise ValueError(f"{name}: expected (1 or 2, {rows}, {d}), got "
                         f"{tuple(t.shape)}")


def get_rel_pos(q_size: int, k_size: int,
                rel_pos: torch.Tensor) -> torch.Tensor:
    """Rel-pos rows for every (query, key) offset: (q_size, k_size, C).
    The table is linearly resized to 2 * max(q, k) - 1 rows first when it
    has another length."""
    rel_pos = resized_rel_table(rel_pos, max(q_size, k_size))
    dev = rel_pos.device
    q_coords = (torch.arange(q_size, device=dev)[:, None]
                * max(k_size / q_size, 1.0))
    k_coords = (torch.arange(k_size, device=dev)[None, :]
                * max(q_size / k_size, 1.0))
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long()]


def rel_pos_bias_terms(q: torch.Tensor, rel_pos_h: torch.Tensor,
                       rel_pos_w: torch.Tensor, q_hw: Tuple[int, int],
                       k_hw: Tuple[int, int]):
    """q: (B, q_h * q_w, d). Returns rel_h (B, q_h, q_w, k_h) and
    rel_w (B, q_h, q_w, k_w); the bias of key (kh, kw) is their sum."""
    q_h, q_w = q_hw
    k_h, k_w = k_hw
    Rh = get_rel_pos(q_h, k_h, rel_pos_h).to(q.dtype)
    Rw = get_rel_pos(q_w, k_w, rel_pos_w).to(q.dtype)
    B, _, dim = q.shape
    r_q = q.reshape(B, q_h, q_w, dim)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, Rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, Rw)
    return rel_h, rel_w


def scores_f32(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q k^T (..., Nq, Nk) in float32 from q and k as they are (a bf16
    product is exact in float32), with autocast off."""
    with torch.autocast(q.device.type, enabled=False):
        return torch.matmul(q.float(), k.float().transpose(-2, -1))


def attention_with_decomposed_rel_pos(q, k, v, rel_pos_h, rel_pos_w,
                                      q_hw: Tuple[int, int], scale: float):
    """Softmax attention with the decomposed rel-pos bias.

    q, k, v: (B, N, d), B folding batch, heads (and windows); N = q_h * q_w.
    The bias uses the unscaled q; the softmax runs in float32.
    Returns (B, N, d) in v's dtype. The scores are taken in float32 from
    the operands' values (the JAX package's preferred_element_type=float32:
    bf16 scores would move the softmax by ~1e-2), outside autocast.
    """
    q_h, q_w = q_hw
    B, N, _ = q.shape
    attn = scores_f32(q * scale, k)
    rel_h, rel_w = rel_pos_bias_terms(q, rel_pos_h, rel_pos_w, q_hw, q_hw)
    attn = attn.view(B, q_h, q_w, q_h, q_w)
    attn = (attn + rel_h[..., :, None].float()
            + rel_w[..., None, :].float())
    attn = attn.view(B, N, N).softmax(dim=-1)
    return torch.matmul(attn.to(v.dtype), v)


def split_heads(qkv: torch.Tensor, num_heads: int):
    """Raw (B, N, 3*C) projection (feature order s*C + h*d + dd) -> q, k, v,
    each (B * heads, N, d)."""
    B, N, F3 = qkv.shape
    d = F3 // (3 * num_heads)
    t = qkv.reshape(B, N, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    t = t.reshape(3, B * num_heads, N, d)
    return t[0], t[1], t[2]


def merge_heads(o: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B * heads, N, d) -> heads-packed (B, N, heads * d)."""
    BM, N, d = o.shape
    B = BM // num_heads
    return o.view(B, num_heads, N, d).transpose(1, 2).reshape(
        B, N, num_heads * d)
