"""K6: the eval-mode f1 assembly of the backbone, fused.

`pixel_shuffle_up_bn` computes f1 = (ConvTranspose2d_2x2s2(c2) + c1 + x1) *
scale + shift, the eval BatchNorm as a per-channel affine with the
transposed conv's bias folded into `shift`. On a CUDA tensor it launches
the hand-written kernel (csrc/pixel_shuffle.cu): one GEMM whose epilogue
writes each (dy, dx) phase to its interleaved output pixel, so the
depth-to-space never exists as a tensor. On a CPU tensor it runs the plain
version, `pixel_shuffle_up_bn_plain`.

bfloat16 takes a persistent wgmma GEMM fed by TMA, whose c1 / x1 reads and
f1 stores go by TMA too; `pixel_shuffle_plan` is its launch plan. float32
takes a CUDA-core kernel.

Replaces multimodal_sam_adapter_tpu/ops/pixel_shuffle.py:
pixel_shuffle_up_bn (Pallas).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from . import kernels

# the bf16 kernel (csrc/pixel_shuffle.cu): a tile is TILE_M pixels of one
# c2 row x TILE_N product columns (TILE_N / 4 whole channels), the
# reduction comes DEPTH at a time through a ring of STAGES
TILE_M, TILE_N, DEPTH, STAGES = 128, 128, 64, 4
# the float32 kernel: 64-pixel x 128-column tiles, one block each
F32_TILE_M, F32_TILE_N = 64, 128
# c1 / x1 layouts the bf16 kernel takes (its template instantiations)
NCHW, CHANNELS_LAST = 0, 1
LAYOUT_NAMES = {NCHW: "NCHW", CHANNELS_LAST: "channels-last"}
# the H100's SMs (the wrapper passes the card's own count) and the shared
# memory a block may take there
SMS = 132
SMEM_LIMIT = 232448


class PixelShufflePlan(NamedTuple):
    tile_m: int      # pixels of one c2 row a tile (bf16) / a block (f32)
    tile_n: int      # product columns a tile
    tiles: int
    grid: int        # blocks launched (bf16: persistent, one per SM at most)
    c1_layout: int   # NCHW or CHANNELS_LAST (bf16); -1: any strides (f32)
    x1_layout: int
    smem_bytes: int  # dynamic (bf16) or static (f32) shared memory a block


def operand_layout(name: str, strides: Sequence[int]) -> int:
    """NCHW or CHANNELS_LAST for a (B, O, 2H, 2W) operand's element strides:
    W (NCHW-like) or O (channels-last) innermost, every other stride a
    multiple of 8 values (TMA's 16 bytes). Anything else raises."""
    s = tuple(int(v) for v in strides)
    if len(s) == 4 and s[3] == 1:
        layout, outer = NCHW, (s[0], s[1], s[2])
    elif len(s) == 4 and s[1] == 1:
        layout, outer = CHANNELS_LAST, (s[0], s[2], s[3])
    else:
        raise ValueError(f"{name}: the bf16 kernel takes NCHW or channels-last"
                         f" operands, got strides {s}")
    if any(v % 8 for v in outer):
        raise ValueError(f"{name}: {LAYOUT_NAMES[layout]} strides {s} are "
                         f"not multiples of 8 values (16 bytes), which TMA "
                         f"needs")
    return layout


def bf16_smem_bytes() -> int:
    """The bf16 kernel's shared memory (csrc/pixel_shuffle.cu PsSmem): the
    ring, the c1, x1 and staging tiles of one output box each, 2 KB of
    barriers and alignment."""
    stage = TILE_M * DEPTH * 2 + DEPTH * TILE_N * 2
    return STAGES * stage + 3 * TILE_M * TILE_N * 2 + 2048


@functools.lru_cache(maxsize=None)
def pixel_shuffle_plan(B: int, H: int, W: int, C: int, O: int,
                       c1_strides: Sequence[int], x1_strides: Sequence[int],
                       dtype: torch.dtype, sms: int = SMS
                       ) -> PixelShufflePlan:
    """The kernel's plan for c2 (B, C, H, W), O output channels and the
    element strides of c1 and x1 (B, O, 2H, 2W).

    bfloat16: tiles of 128 pixels of one c2 row x 128 product columns, a
    row's last tile ragged (TMA clips it), B * H * ceil(W / 128) * (4 O /
    128) of them, walked by min(tiles, sms) persistent blocks; c1 and x1
    each NCHW or channels-last (`operand_layout`), one instantiation per
    pair. float32: one block per 64 x 128 tile, any strides."""
    if C <= 0 or C % 8 or O <= 0 or O % 32:
        raise ValueError(f"the kernel takes C % 8 == 0 and O % 32 == 0, got "
                         f"C={C}, O={O}")
    if min(B, H, W) < 0 or sms <= 0:
        raise ValueError(f"bad geometry B={B}, H={H}, W={W}, sms={sms}")
    n_cols = 4 * O // TILE_N
    if dtype == torch.float32:
        tiles = -(-B * H * W // F32_TILE_M) * (4 * O // F32_TILE_N)
        return PixelShufflePlan(F32_TILE_M, F32_TILE_N, tiles, tiles, -1, -1,
                                F32_TILE_M * (F32_TILE_N + 1) * 4)
    if dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {dtype}")
    c1_layout = operand_layout("c1", c1_strides)
    x1_layout = operand_layout("x1", x1_strides)
    tiles = B * H * -(-W // TILE_M) * n_cols
    return PixelShufflePlan(TILE_M, TILE_N, tiles, min(tiles, sms),
                            c1_layout, x1_layout, bf16_smem_bytes())


@functools.lru_cache(maxsize=None)
def _device_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _strides(t: torch.Tensor):
    """t's element strides, a batch of one given the span of an image as
    its batch stride (a view may report any stride for a dimension of size
    1; the kernel's tensor maps take the stride as it is)."""
    s = list(t.stride())
    if t.shape[0] == 1:
        s[0] = max(st * n for st, n in zip(s[1:], t.shape[1:]))
    return tuple(s)


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
    channels-last map, or a view of a token stream), its batch stride a
    multiple of 8; c1 and x1: bf16, NCHW or channels-last (see
    `operand_layout`), 16-byte aligned; float32, any strides. C % 8 == 0,
    O % 32 == 0."""
    B, C, H, W = c2.shape
    O = weight.shape[1]
    dt = c2.dtype
    if c2.device.type != "cuda" or c2.dtype not in (torch.float32,
                                                    torch.bfloat16):
        raise TypeError("c2: expected a float32/bfloat16 CUDA tensor")
    c2_bs = _strides(c2)[0]
    if (c2.stride(1) != 1 or c2.stride(3) != C or c2.stride(2) != W * C
            or c2_bs % 8 or c2.data_ptr() % 16):
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
        if dt == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"{name}: expected a 16-byte aligned tensor")
    c1_s, x1_s = _strides(c1), _strides(x1)
    plan = pixel_shuffle_plan(B, H, W, C, O, c1_s, x1_s, dt,
                              _device_sms(c2.device.index or 0))
    out = torch.empty((B, O, 2 * H, 2 * W), dtype=dt, device=c2.device)
    lib = kernels.library()
    with torch.cuda.device(c2.device):
        status = lib.msa_pixel_shuffle_up_bn(
            c2.data_ptr(), c2_bs, weight.data_ptr(), c1.data_ptr(),
            *c1_s, x1.data_ptr(), *x1_s, scale.data_ptr(),
            shift.data_ptr(), out.data_ptr(), B, H, W, C, O, plan.tile_m,
            plan.tile_n, plan.grid, plan.c1_layout, plan.x1_layout,
            plan.smem_bytes, kernels.dtype_code(c2),
            kernels.current_stream(c2))
    kernels.check_status("pixel_shuffle_up_bn", status)
    kernels.count_launch("pixel_shuffle_up_bn")
    return out
