"""K1: windowed attention with the decomposed rel-pos bias.

`window_attention` takes the raw (windows, N, 3*C) qkv projection and
returns the heads-packed (windows, N, C) output. On a CUDA tensor it
launches the hand-written kernel (csrc/window_attention.cu): bfloat16 on
the wgmma/TMA core from the (2 ws - 1, d) tables (`rel_table_parts`) and
the window's 0/1 expansion tiles (`window_expansion`), float32 on the
3xTF32 wgmma/TMA core shared with K2 from the float32 (2 ws - 1, d) tables
(`rel_table_f32`), in key tiles of whole window rows (`f32_key_tiles`).
When autograd records
the call it goes through `WindowAttentionFunction`: the kernel forward,
and the autodiff of the plain version recomputed as its backward. On a
CPU tensor it runs the plain version, `window_attention_plain`.

Replaces multimodal_sam_adapter_tpu/ops/window_attention.py:
window_attention_laneblock_fwd (Pallas), and its custom_vjp
_make_diff_window_attn_laneblock.
"""
from __future__ import annotations

import functools

import torch

from ..utils import flops
from . import kernels
from .attention import (attention_with_decomposed_rel_pos,
                        check_table_parts, f32_key_tiles,
                        merge_heads, rel_table_f32, rel_table_parts,
                        split_heads)

# keys per tile of the bf16 kernel: a window's ws^2 keys, zero-padded
WINDOW_TILES = (64, 208)
# slots of the expansion tiles: a grid row or column (< 15) each, the last
# one the mask of the padding keys
EXPANSION_SLOTS = 16


def window_keys_per_tile(ws: int) -> int:
    """Keys per tile of the bf16 kernel for a ws x ws window (its whole K
    and V stay resident): the smallest of WINDOW_TILES that holds ws^2
    keys. SAM's 14 x 14 windows take 208 (196 + 12 masked)."""
    for bk in WINDOW_TILES:
        if ws * ws <= bk:
            return bk
    raise ValueError(f"window {ws}x{ws}: the bf16 kernel holds at most "
                     f"{WINDOW_TILES[-1]} keys")


def window_expansion(ws: int, keys: int) -> torch.Tensor:
    """The bf16 kernel's 0/1 expansion tiles for a ws x ws window in a tile
    of `keys` keys: (2, keys, 16) float32. Row c of tile 0 has a 1 in slot
    c // ws (the key's grid row) or, for a padding key c >= ws^2, in slot
    15; row c of tile 1 a 1 in slot c % ws (its grid column), none for a
    padding key. A query's 16 slots of rel_h terms (slot 15: the mask)
    times tile 0, plus its rel_w slots times tile 1, is its bias of every
    key: the kernel adds it to q.k on the tensor cores."""
    if ws >= EXPANSION_SLOTS or ws * ws > keys:
        raise ValueError(f"window {ws}x{ws} in {keys} keys: no expansion")
    c = torch.arange(keys)
    valid = c < ws * ws
    e = torch.zeros((2, keys, EXPANSION_SLOTS))
    e[0, c[valid], c[valid] // ws] = 1
    e[0, c[~valid], EXPANSION_SLOTS - 1] = 1
    e[1, c[valid], c[valid] % ws] = 1
    return e


@functools.lru_cache(maxsize=None)
def _expansion_on(ws: int, keys: int, device: torch.device) -> torch.Tensor:
    return window_expansion(ws, keys).to(device=device, dtype=torch.bfloat16)


@flops.counted("window_attention")
def window_attention(qkv: torch.Tensor, rel_pos_h: torch.Tensor,
                     rel_pos_w: torch.Tensor, ws: int, num_heads: int,
                     scale: float) -> torch.Tensor:
    if not kernels.use_kernel("window_attention", qkv, rel_pos_h,
                              rel_pos_w):
        return window_attention_plain(qkv, rel_pos_h, rel_pos_w, ws,
                                      num_heads, scale)
    if kernels.records_grad(qkv, rel_pos_h, rel_pos_w):
        return WindowAttentionFunction.apply(qkv, rel_pos_h, rel_pos_w, ws,
                                             num_heads, scale)
    return window_attention_kernel(qkv, rel_pos_h, rel_pos_w, ws, num_heads,
                                   scale)


def window_attention_kernel(qkv, rel_pos_h, rel_pos_w, ws: int,
                            num_heads: int, scale: float) -> torch.Tensor:
    """The kernel's launch for `qkv`'s dtype, with its tables built from
    the rel-pos parameters."""
    if qkv.dtype == torch.bfloat16:
        return window_attention_bf16_cuda(
            qkv, rel_table_parts(rel_pos_h, ws),
            rel_table_parts(rel_pos_w, ws), ws, num_heads, scale)
    return window_attention_cuda(qkv, rel_table_f32(rel_pos_h, ws),
                                 rel_table_f32(rel_pos_w, ws), ws, num_heads,
                                 scale)


class WindowAttentionFunction(torch.autograd.Function):
    """K1 under autograd, the counterpart of the JAX package's
    _make_diff_window_attn_laneblock: the kernel on the raw qkv forward;
    backward, the autodiff of `window_attention_plain` recomputed, into
    qkv and both rel-pos parameters (the float32 tables, not the bf16
    parts the kernel read)."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, qkv, rel_pos_h, rel_pos_w, ws, num_heads, scale):
        ctx.save_for_backward(qkv, rel_pos_h, rel_pos_w)
        ctx.args = (ws, num_heads, scale)
        return window_attention_kernel(qkv, rel_pos_h, rel_pos_w, ws,
                                       num_heads, scale)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, grad):
        return kernels.plain_vjp(window_attention_plain, ctx.saved_tensors,
                                 ctx.args, grad,
                                 ctx.needs_input_grad[:3]) + (None,) * 3


def window_attention_plain(qkv, rel_pos_h, rel_pos_w, ws: int,
                           num_heads: int, scale: float) -> torch.Tensor:
    q, k, v = split_heads(qkv, num_heads)
    o = attention_with_decomposed_rel_pos(q, k, v, rel_pos_h, rel_pos_w,
                                          (ws, ws), scale)
    return merge_heads(o, num_heads)


def _check_qkv(qkv: torch.Tensor, ws: int, num_heads: int):
    Wn, N, F3 = qkv.shape
    C = F3 // 3
    d = C // num_heads
    if N != ws * ws or F3 != 3 * num_heads * d:
        raise ValueError(f"qkv {tuple(qkv.shape)} does not match ws={ws}, "
                         f"heads={num_heads}")
    if Wn * num_heads > 65535:
        raise ValueError(f"{Wn} windows x {num_heads} heads exceed the grid")
    return Wn, N, C, d


def window_attention_cuda(qkv: torch.Tensor, th: torch.Tensor,
                          tw: torch.Tensor, ws: int, num_heads: int,
                          scale: float) -> torch.Tensor:
    """float32: qkv (windows, ws*ws, 3*C); th, tw: the (2 ws - 1, d)
    rel-pos tables of `rel_table_f32`. Returns (windows, ws*ws, C)."""
    Wn, N, C, d = _check_qkv(qkv, ws, num_heads)
    window_keys_per_tile(ws)  # the windows the bf16 route takes, no more
    rows, tiles = f32_key_tiles((ws, ws))
    kernels.check_operand("qkv", qkv, torch.float32)
    kernels.check_operand("th", th, torch.float32, (2 * ws - 1, d))
    kernels.check_operand("tw", tw, torch.float32, (2 * ws - 1, d))
    out = torch.empty((Wn, N, C), dtype=qkv.dtype, device=qkv.device)
    lib = kernels.library()
    with torch.cuda.device(qkv.device):
        status = lib.msa_window_attention(
            qkv.data_ptr(), th.data_ptr(), tw.data_ptr(), out.data_ptr(),
            Wn, num_heads, d, ws, rows, tiles, float(scale),
            kernels.current_stream(qkv))
    kernels.check_status("window_attention", status)
    kernels.count_launch("window_attention")
    return out


def window_attention_bf16_cuda(qkv: torch.Tensor, th: torch.Tensor,
                               tw: torch.Tensor, ws: int, num_heads: int,
                               scale: float) -> torch.Tensor:
    """bfloat16: qkv (windows, ws*ws, 3*C); th, tw: the (parts, 2 ws - 1,
    d) rel-pos tables of `rel_table_parts`. Returns (windows, ws*ws, C)."""
    Wn, N, C, d = _check_qkv(qkv, ws, num_heads)
    bk = window_keys_per_tile(ws)
    kernels.check_operand("qkv", qkv, torch.bfloat16)
    check_table_parts("th", th, 2 * ws - 1, d)
    check_table_parts("tw", tw, 2 * ws - 1, d)
    ex = _expansion_on(ws, bk, qkv.device)
    out = torch.empty((Wn, N, C), dtype=qkv.dtype, device=qkv.device)
    lib = kernels.library()
    with torch.cuda.device(qkv.device):
        status = lib.msa_window_attention_bf16(
            qkv.data_ptr(), th.data_ptr(), tw.data_ptr(), ex.data_ptr(),
            out.data_ptr(), Wn, num_heads, d, ws, bk, th.shape[0],
            tw.shape[0], float(scale), kernels.current_stream(qkv))
    kernels.check_status("window_attention", status)
    kernels.count_launch("window_attention")
    return out
