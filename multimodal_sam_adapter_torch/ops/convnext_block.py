"""K5: one ConvNeXt block.

`convnext_block` takes a channels-last map x (B, H, W, C) and the block's
parameters in torch's own layouts (depthwise weight (C, 1, 7, 7), Linear
weights (HID, C) and (C, HID)) and returns the block OUTPUT, the shortcut
added: x + gamma * (fc2(gelu(fc1(LN(dwconv(x))))) + b2). (The TPU kernel
returns the pre-residual delta and leaves the add to XLA; here the add is
the kernel's epilogue, which saves one pass over the map.) On a CUDA tensor
it launches the hand-written kernels (csrc/convnext_block.cu), on a CPU
tensor it runs the plain version, `convnext_block_plain`.

`convnext_block_delta` returns the delta alone, gamma * (...), the JAX
kernel's contract: the kernel's delta-only mode (a null shortcut, no add
in the epilogue), for training, where drop path acts on the delta before
the add. Recovering the delta as out - x in bf16 would lose it: with the
layer scale near 1e-6 at init, |delta| << |x|. When autograd records a
call, both go through `ConvNextDeltaFunction`: the kernel's delta
forward, and the autodiff of the plain delta recomputed as its backward.
Under autocast the kernel runs in the autocast dtype, x and the
parameters cast to it, as the plain version's convolution and products
are.

Both dtypes take three launches behind one C call: a dwconv + LayerNorm
prologue that writes the normalised map xn (P, C), P = B*H*W, then two
wgmma GEMMs fed by TMA, fc1 (h = gelu(xn w1^T + b1), (P, HID)) and fc2
(out = x + (h w2^T + b2) gamma), with xn and h scratch of x's dtype
allocated here. bfloat16 multiplies on bf16 wgmma; float32 in 3xTF32 on
.tf32 wgmma (each operand split into two TF32 halves, three products a
step, ~float32 accuracy), its weights split by the prologue into a third
scratch (`scratch_shapes`). `convnext_block_plan` is their launch plan.

Replaces multimodal_sam_adapter_tpu/ops/convnext_block.py:
convnext_block_fused_fwd (Pallas), and its custom_vjp _make_diff (the VJP
of _reference_delta).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils import flops
from . import kernels

# the launch plan (csrc/convnext_block.cu)
PROLOGUE_TILE_W = 8                # pixel tile columns
PROLOGUE_TILE_ROWS = (8, 4, 2, 1)  # tile rows the prologue instantiates
# float32 dwconv outputs a prologue tile keeps in shared memory (64 KiB)
PROLOGUE_TILE_VALUES = 16384
SMEM_MAX = 232448                  # shared memory a block may take (227 KB)
FC_ROWS = 128                      # pixel rows of a GEMM tile
FC1_WIDTH = 128                    # fc1's tile width (hidden units)
FC2_WIDTHS = (64, 96, 128, 192)    # fc2's tile widths (channels)
# float32 holds two accumulators a thread (the stage's TF32 sum and the
# whole): fc2 up to 128 wide
FC2_WIDTHS_F32 = (64, 96, 128)
FC_ROW_BYTES = 128                 # a stage's reduction: one swizzled row
FC_RING_BYTES = 220 * 1024         # a GEMM block's ring and staging tiles
FC_MAX_STAGES = 8
# the H100's SMs: the prologue asks for a block on each where the map
# allows (the GEMMs take 128-row tiles whatever the card)
SMS = 132
_ITEMSIZE = {torch.bfloat16: 2, torch.float32: 4}


class ConvNextPlan(NamedTuple):
    tile_h: int    # prologue tile rows (the tile is tile_h x PROLOGUE_TILE_W)
    fc1_bn: int    # fc1 tile width
    fc2_bn: int    # fc2 tile width
    tap_slab: int  # channels whose taps the prologue stages at once


def prologue_blocks(B: int, H: int, W: int, tile_h: int) -> int:
    """Blocks of the prologue: one per tile_h x 8 tile of each image."""
    return B * -(-H // tile_h) * -(-W // PROLOGUE_TILE_W)


def fc_grid(P: int, N: int, bn: int) -> Tuple[int, int]:
    """(column tiles, row tiles) of a GEMM with P rows and N columns."""
    return -(-N // bn), -(-P // FC_ROWS)


def itemsize(dtype: torch.dtype) -> int:
    if dtype not in _ITEMSIZE:
        raise TypeError(f"the kernels take bfloat16 or float32, got {dtype}")
    return _ITEMSIZE[dtype]


def fc2_widths(dtype: torch.dtype) -> Tuple[int, ...]:
    """fc2's tile widths the kernels instantiate in `dtype`."""
    return FC2_WIDTHS_F32 if itemsize(dtype) == 4 else FC2_WIDTHS


def prologue_smem(tile_h: int, C: int, tap_slab: int,
                  dtype: torch.dtype) -> int:
    """Shared memory of a prologue block: its float32 dwconv tile and one
    slab of raw taps (csrc's `prologue_smem`)."""
    return (tile_h * PROLOGUE_TILE_W * C * 4
            + tap_slab * 49 * itemsize(dtype))


def fc_stages(dtype: torch.dtype, fc1: bool, bn: int) -> int:
    """Ring stages of a GEMM (csrc's `FcSmem::kStages`): a stage holds a
    128-row A tile and a bn-row B tile one 128-byte row deep, B twice in
    float32 (its TF32 halves); bf16 also keeps two staging tiles."""
    f32 = itemsize(dtype) == 4
    stage = FC_ROWS * FC_ROW_BYTES + (2 if f32 else 1) * bn * FC_ROW_BYTES
    out = 0 if f32 else 64 * bn * 2 if fc1 else 64 * (bn + 8) * 4
    return min((FC_RING_BYTES - 2 * out) // stage, FC_MAX_STAGES)


@functools.lru_cache(maxsize=None)
def convnext_block_plan(B: int, H: int, W: int, C: int, HID: int,
                        dtype: torch.dtype = torch.bfloat16) -> ConvNextPlan:
    """The kernels' plan for a (B, H, W, C) map of `dtype` with HID hidden
    units.

    - prologue: the largest tile (8, 4, 2 or 1 rows of 8 pixels) whose
      float32 dwconv outputs fit its shared memory and that still gives
      >= SMS blocks; where none does, the smallest that fits. Its taps
      (C x 49 of x's dtype) stage beside the tile in one slab where they
      fit SMEM_MAX, else in slabs of the most channels (a multiple of 8)
      that do: float32 from C = 896 at two tile rows, 1024 at one;
    - fc1: 128 hidden units a tile;
    - fc2: the narrowest width >= C (one column tile: h is read once);
      above the widest (192, float32 128) the widest width dividing C
      (any, where none does) whose grid still has >= SMS / 2 tiles, else
      the narrowest: at 64^2 x 384 96 tiles 128 wide (on an H100 fc2
      took 12.9 us against 15.2 with 192 tiles 64 wide), at 32^2 x 768
      96 tiles 64 wide rather than 48 that leave 84 SMs idle, in float32
      at 128^2 x 192 256 tiles 96 wide rather than 128 wide with a third
      of their columns past C. The ring holds 3-7 stages (`fc_stages`)."""
    size = itemsize(dtype)
    if C <= 0 or HID <= 0 or C % 8 or HID % 8:
        raise ValueError(f"the kernels take C, HID multiples of 8, got "
                         f"C={C}, HID={HID}")
    rows = [t for t in PROLOGUE_TILE_ROWS
            if t * PROLOGUE_TILE_W * C <= PROLOGUE_TILE_VALUES]
    if not rows:
        raise ValueError(f"C={C}: the prologue takes C <= "
                         f"{PROLOGUE_TILE_VALUES // PROLOGUE_TILE_W}")
    tile_h = next((t for t in rows if prologue_blocks(B, H, W, t) >= SMS),
                  rows[-1])
    room = SMEM_MAX - prologue_smem(tile_h, C, 0, dtype)
    tap_slab = min(C, room // (49 * size) // 8 * 8)
    widths = fc2_widths(dtype)
    fc2_bn = next((bn for bn in widths if bn >= C), None)
    if fc2_bn is None:
        whole = [bn for bn in widths if C % bn == 0] or list(widths)
        wide = [bn for bn in whole
                if math.prod(fc_grid(B * H * W, C, bn)) >= SMS // 2]
        fc2_bn = max(wide, default=whole[0])
    return ConvNextPlan(tile_h, FC1_WIDTH, fc2_bn, tap_slab)


def scratch_shapes(B: int, H: int, W: int, C: int, HID: int,
                   dtype: torch.dtype = torch.bfloat16
                   ) -> Tuple[Tuple[int, int], ...]:
    """The kernels' scratch, of x's dtype: xn (P, C) and h (P, HID); float32
    adds the weights' TF32 halves, (4, HID * C): w1's big and small, then
    w2's."""
    P = B * H * W
    if itemsize(dtype) == 4:
        return (P, C), (P, HID), (4, HID * C)
    return (P, C), (P, HID)


@flops.counted("convnext_block")
def convnext_block(x: torch.Tensor, dw: torch.Tensor, dw_b: torch.Tensor,
                   ln_g: torch.Tensor, ln_b: torch.Tensor, w1: torch.Tensor,
                   b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                   gamma: torch.Tensor, eps: float = 1e-6,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`out`: where to write the result (x's shape and dtype), else a new
    tensor; not taken by a call that autograd records (there the add
    follows the kernel's delta, through its Function)."""
    params = (dw, dw_b, ln_g, ln_b, w1, b1, w2, b2, gamma)
    if not kernels.use_kernel("convnext_block", x, *params):
        res = convnext_block_plain(x, *params, eps)
        return res if out is None else out.copy_(res)
    if kernels.records_grad(x, *params):
        if out is not None:
            raise ValueError("convnext_block: out= takes no call that "
                             "autograd records")
        return x + ConvNextDeltaFunction.apply(x, *params, eps)
    return convnext_block_cuda(x, *params, eps, out)


@flops.counted("convnext_block")
def convnext_block_delta(x: torch.Tensor, dw: torch.Tensor,
                         dw_b: torch.Tensor, ln_g: torch.Tensor,
                         ln_b: torch.Tensor, w1: torch.Tensor,
                         b1: torch.Tensor, w2: torch.Tensor,
                         b2: torch.Tensor, gamma: torch.Tensor,
                         eps: float = 1e-6) -> torch.Tensor:
    """The block's delta alone, gamma * (fc2(gelu(fc1(LN(dwconv(x))))) +
    b2), without the shortcut: the kernel's delta-only mode."""
    params = (dw, dw_b, ln_g, ln_b, w1, b1, w2, b2, gamma)
    if not kernels.use_kernel("convnext_block", x, *params):
        return convnext_delta_plain(x, *params, eps)
    if kernels.records_grad(x, *params):
        return ConvNextDeltaFunction.apply(x, *params, eps)
    return convnext_delta_kernel(x, *params, eps)


def convnext_delta_kernel(x, dw, dw_b, ln_g, ln_b, w1, b1, w2, b2, gamma,
                          eps: float = 1e-6) -> torch.Tensor:
    """The kernel in its delta-only mode, in the autocast dtype under
    autocast (x and the parameters cast to it), else in x's dtype."""
    tensors = (x, dw, dw_b, ln_g, ln_b, w1, b1, w2, b2, gamma)
    dt = kernels.autocast_dtype(x)
    with torch.autocast(x.device.type, enabled=False):
        if dt is not None:
            tensors = tuple(t.to(dt).contiguous() for t in tensors)
        return convnext_block_cuda(*tensors, eps, residual=False)


class ConvNextDeltaFunction(torch.autograd.Function):
    """K5 under autograd, the counterpart of the JAX package's
    convnext_block.py _make_diff: the kernel's delta forward; backward,
    the autodiff of `convnext_delta_plain` recomputed (the VJP of its
    _reference_delta), into x and every parameter."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, dw, dw_b, ln_g, ln_b, w1, b1, w2, b2, gamma, eps):
        ctx.save_for_backward(x, dw, dw_b, ln_g, ln_b, w1, b1, w2, b2, gamma)
        ctx.eps = eps
        return convnext_delta_kernel(x, dw, dw_b, ln_g, ln_b, w1, b1, w2,
                                     b2, gamma, eps)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, grad):
        return kernels.plain_vjp(convnext_delta_plain, ctx.saved_tensors,
                                 (ctx.eps,), grad,
                                 ctx.needs_input_grad[:10]) + (None,)


def convnext_delta_plain(x, dw, dw_b, ln_g, ln_b, w1, b1, w2, b2, gamma,
                         eps: float = 1e-6) -> torch.Tensor:
    """The reference block's residual branch on a channels-last map:
    depthwise conv, LayerNorm, Linear, exact GELU, Linear, layer scale."""
    C = x.shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2), dw, dw_b, padding=3, groups=C)
    y = F.layer_norm(y.permute(0, 2, 3, 1), (C,), ln_g, ln_b, eps)
    y = F.linear(F.gelu(F.linear(y, w1, b1)), w2, b2)
    return y * gamma.to(y.dtype)


def convnext_block_plain(x, dw, dw_b, ln_g, ln_b, w1, b1, w2, b2, gamma,
                         eps: float = 1e-6) -> torch.Tensor:
    """The reference block: the shortcut plus `convnext_delta_plain`."""
    return x + convnext_delta_plain(x, dw, dw_b, ln_g, ln_b, w1, b1, w2, b2,
                                    gamma, eps)


def convnext_block_cuda(x, dw, dw_b, ln_g, ln_b, w1, b1, w2, b2, gamma,
                        eps: float = 1e-6,
                        out: Optional[torch.Tensor] = None,
                        residual: bool = True) -> torch.Tensor:
    """x (B, H, W, C) contiguous; every parameter of x's dtype and device.
    C and HID multiples of 8, C <= 2048 (`convnext_block_plan`). Returns
    x + block(x), or with residual=False the delta block(x) alone (a null
    shortcut: the epilogue adds nothing)."""
    B, H, W, C = x.shape
    HID = w1.shape[0]
    dt = x.dtype
    kernels.check_operand("x", x, dt)
    kernels.check_operand("dw", dw, dt, (C, 1, 7, 7))
    kernels.check_operand("w1", w1, dt, (HID, C))
    kernels.check_operand("w2", w2, dt, (C, HID))
    kernels.check_operand("b1", b1, dt, (HID,))
    for name, t in (("dw_b", dw_b), ("ln_g", ln_g), ("ln_b", ln_b),
                    ("b2", b2), ("gamma", gamma)):
        kernels.check_operand(name, t, dt, (C,))
    if out is None:
        out = torch.empty_like(x)
    else:
        kernels.check_operand("out", out, dt, x.shape)
    lib = kernels.library()
    plan = convnext_block_plan(B, H, W, C, HID, dt)
    xn, h, *split = (torch.empty(s, dtype=dt, device=x.device)
                     for s in scratch_shapes(B, H, W, C, HID, dt))
    with torch.cuda.device(x.device):
        status = lib.msa_convnext_block(
            x.data_ptr(), dw.data_ptr(), dw_b.data_ptr(), ln_g.data_ptr(),
            ln_b.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), gamma.data_ptr(),
            x.data_ptr() if residual else None, out.data_ptr(),
            xn.data_ptr(), h.data_ptr(),
            split[0].data_ptr() if split else None, B, H, W, C, HID,
            float(eps), *plan, kernels.dtype_code(x),
            kernels.current_stream(x))
    kernels.check_status("convnext_block", status)
    kernels.count_launch("convnext_block")
    return out
