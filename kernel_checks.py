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
from multimodal_sam_adapter_torch.ops.flash_attention import flash_attention
from multimodal_sam_adapter_torch.ops.msda_cuda import ms_deform_attn
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
    """Mean milliseconds per call on the card, by CUDA events after
    warm-up."""
    for _ in range(warmup):
        fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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


def _randn(shape, g, dtype, scale=1.0):
    return (torch.randn(shape, generator=g, device=g.device) * scale).to(dtype)


def flagship_case(name: str, dtype: torch.dtype, g: torch.Generator
                  ) -> Tuple[Callable, tuple]:
    """(wrapper, args) for one kernel at its flagship shapes."""
    dev = g.device
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
