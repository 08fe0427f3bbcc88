"""Kernel-against-plain checks of the PyTorch port at the flagship shapes,
shared by `chip_smoke.py` and the card tests (tests/test_torch_gpu.py).

Each case draws its inputs from a seeded generator on the card and calls a
kernel's public wrapper: as is it launches the kernel, inside
`kernels.plain_kernels()` it runs the plain version on the same inputs.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from multimodal_sam_adapter_torch.models.adapter import reference_points
from multimodal_sam_adapter_torch.ops import kernels
from multimodal_sam_adapter_torch.ops.convnext_block import convnext_block
from multimodal_sam_adapter_torch.ops.flash_attention import flash_attention
from multimodal_sam_adapter_torch.ops.msda_cuda import ms_deform_attn
from multimodal_sam_adapter_torch.ops.pixel_shuffle import pixel_shuffle_up_bn
from multimodal_sam_adapter_torch.ops.window_attention import window_attention

# kernel name -> where it lives and which TPU kernel it replaces
KERNELS: Dict[str, Dict[str, str]] = {
    "window_attention": dict(
        source="multimodal_sam_adapter_torch/csrc/window_attention.cu",
        replaces="multimodal_sam_adapter_tpu/ops/window_attention.py:353"),
    "flash_attention": dict(
        source="multimodal_sam_adapter_torch/csrc/flash_attention.cu",
        replaces="multimodal_sam_adapter_tpu/ops/flash_attention.py:503"),
    "msda_multi_level": dict(
        source="multimodal_sam_adapter_torch/csrc/msda.cu",
        replaces="multimodal_sam_adapter_tpu/ops/msda_pallas.py:623"),
    "msda_single_level": dict(
        source="multimodal_sam_adapter_torch/csrc/msda.cu",
        replaces="multimodal_sam_adapter_tpu/ops/msda_pallas.py:574"),
    "convnext_block": dict(
        source="multimodal_sam_adapter_torch/csrc/convnext_block.cu",
        replaces="multimodal_sam_adapter_tpu/ops/convnext_block.py:115"),
    "pixel_shuffle_up_bn": dict(
        source="multimodal_sam_adapter_torch/csrc/pixel_shuffle.cu",
        replaces="multimodal_sam_adapter_tpu/ops/pixel_shuffle.py:53"),
}

# Kernel vs plain version. float32: both sides run on the same float32
# inputs and differ only in summation order and exp rounding. bfloat16: the
# kernel runs on the bf16 inputs, the plain version on the same values
# upcast to float32 (`plain_reference`), so the bound is the kernel's own
# error: the bf16 rounding of its O(1) output (relative step 2^-8). (The
# plain version in bf16 rounds its attention scores to bf16, which at these
# inputs moves outputs by up to ~0.06 by itself.)
TOLERANCES = {
    torch.float32: dict(atol=1e-4, rtol=1e-4),
    torch.bfloat16: dict(atol=1e-2, rtol=1e-2),
}


def plain_reference(fn: Callable, args: tuple) -> torch.Tensor:
    """The plain version of `fn` on `args` with bf16 tensors upcast to
    float32, cast back to the kernel's output dtype."""
    up = tuple(a.float() if torch.is_tensor(a) and a.dtype == torch.bfloat16
               else a for a in args)
    dtype = next(a.dtype for a in args if torch.is_tensor(a))
    with kernels.plain_kernels():
        return fn(*up).to(dtype)


def time_ms(fn: Callable, args: tuple, iters: int = 10,
            warmup: int = 2) -> float:
    """Mean device milliseconds per call, by CUDA events after warm-up.
    The timed calls are queued behind a spin kernel (~10 ms), so the host's
    time to issue them does not open gaps on the device: what is timed is
    the device work of the wrapper, its torch ops included."""
    for _ in range(warmup):
        fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# flagship geometry: SAM ViT-L at 1024^2 (deliver_rgblidar)
EMBED, HEADS, WINDOW, GRID = 1024, 16, 14, 64
DEF_HEADS, DEF_POINTS, DEF_VALUE = 16, 4, 512
PYRAMID = ((128, 128), (64, 64), (32, 32))
# K5: (H = W, C) of the four ConvNeXt-small stages at 1024^2
CONVNEXT_STAGES = ((256, 96), (128, 192), (64, 384), (32, 768))
# K6: (c2 grid side, embed) at 1024^2
PIXEL_SHUFFLE_FLAGSHIP = (128, EMBED)
# ragged shapes: the FMB (800^2) stage widths that fill no tile, and the
# narrow widths of the test configurations (atto trunk, embed 32)
CONVNEXT_RAGGED = ((25, 768), (50, 384), (16, 40))
PIXEL_SHUFFLE_RAGGED = ((100, EMBED), (8, 32))


def _randn(shape, g, dtype, scale=1.0):
    return (torch.randn(shape, generator=g, device=g.device) * scale).to(dtype)


def convnext_case(hw: int, C: int, dtype: torch.dtype, g: torch.Generator,
                  batch: int = 1) -> Tuple[Callable, tuple]:
    """K5 on a (batch, hw, hw, C) map with weights scaled so that every
    stage of the block is O(1): fc1's inputs are normalised, its weights
    ~1/sqrt(C), fc2's ~1/sqrt(4C)."""
    hid = 4 * C
    return convnext_block, (
        _randn((batch, hw, hw, C), g, dtype),
        _randn((C, 1, 7, 7), g, dtype, 0.1),
        _randn((C,), g, dtype, 0.05),
        (1 + _randn((C,), g, torch.float32, 0.05)).to(dtype),
        _randn((C,), g, dtype, 0.05),
        _randn((hid, C), g, dtype, C ** -0.5),
        _randn((hid,), g, dtype, 0.05),
        _randn((C, hid), g, dtype, hid ** -0.5),
        _randn((C,), g, dtype, 0.05),
        _randn((C,), g, dtype, 0.5))


def pixel_shuffle_case(hw: int, E: int, dtype: torch.dtype,
                       g: torch.Generator, batch: int = 1
                       ) -> Tuple[Callable, tuple]:
    """K6 with the operands in the backbone's layouts: c2 a view of the
    (batch, hw*hw, E) token stream, c1 an NCHW map, x1 channels-last (as
    the bilinear resize of a token-grid view returns it)."""
    c2 = _randn((batch, hw * hw, E), g, dtype).transpose(1, 2).reshape(
        batch, E, hw, hw)
    c1 = _randn((batch, E, 2 * hw, 2 * hw), g, dtype)
    x1 = _randn((batch, 2 * hw, 2 * hw, E), g, dtype).permute(0, 3, 1, 2)
    weight = _randn((E, E, 2, 2), g, dtype, E ** -0.5)
    scale = 1 + _randn((E,), g, torch.float32, 0.05)
    shift = _randn((E,), g, torch.float32, 0.05)
    return pixel_shuffle_up_bn, (c2, weight, c1, x1, scale, shift)


def flagship_shapes(name: str) -> tuple:
    """The shapes at which `flagship_case` checks a kernel: one for each
    kernel but K5, which runs at the four stages of the trunk."""
    return CONVNEXT_STAGES if name == "convnext_block" else (None,)


def flagship_case(name: str, dtype: torch.dtype, g: torch.Generator,
                  shape=None) -> Tuple[Callable, tuple]:
    """(wrapper, args) for one kernel at its flagship shapes (`shape`: one
    of `flagship_shapes(name)`)."""
    dev = g.device
    if name == "convnext_block":
        return convnext_case(*shape, dtype, g)
    if name == "pixel_shuffle_up_bn":
        return pixel_shuffle_case(*PIXEL_SHUFFLE_FLAGSHIP, dtype, g)
    if name == "window_attention":
        windows = (-(-GRID // WINDOW)) ** 2  # 64 padded to 70: 25 windows
        qkv = _randn((windows, WINDOW * WINDOW, 3 * EMBED), g, dtype)
        rph = _randn((2 * WINDOW - 1, EMBED // HEADS), g, dtype, 0.5)
        rpw = _randn((2 * WINDOW - 1, EMBED // HEADS), g, dtype, 0.5)
        return window_attention, (qkv, rph, rpw, WINDOW, HEADS,
                                  (EMBED // HEADS) ** -0.5)
    if name == "flash_attention":
        qkv = _randn((1, GRID * GRID, 3 * EMBED), g, dtype)
        rph = _randn((2 * GRID - 1, EMBED // HEADS), g, dtype, 0.5)
        rpw = _randn((2 * GRID - 1, EMBED // HEADS), g, dtype, 0.5)
        return flash_attention, (qkv, rph, rpw, (GRID, GRID), HEADS,
                                 (EMBED // HEADS) ** -0.5)
    if name == "msda_multi_level":   # injector: ViT tokens <- pyramid
        q_shapes, v_shapes = ((GRID, GRID),), PYRAMID
    elif name == "msda_single_level":  # extractor: pyramid <- ViT tokens
        q_shapes, v_shapes = PYRAMID, ((GRID, GRID),)
    else:
        raise KeyError(name)
    L = len(v_shapes)
    S = sum(h * w for h, w in v_shapes)
    ref = torch.as_tensor(reference_points(q_shapes), device=dev)
    Lq = ref.shape[1]
    ref = ref.expand(1, Lq, L, 2).contiguous()
    value = _randn((1, S, DEF_VALUE), g, dtype)
    # offsets of several level pixels: some samples land outside the grid
    offs = _randn((1, Lq, DEF_HEADS * L * DEF_POINTS * 2), g, dtype, 8.0)
    logits = _randn((1, Lq, DEF_HEADS * L * DEF_POINTS), g, dtype)
    return ms_deform_attn, (value, v_shapes, ref, offs, logits, DEF_HEADS,
                            DEF_POINTS)
