"""Kernel-against-plain checks of the PyTorch port at the flagship shapes,
shared by `chip_smoke.py` and the card tests (tests/test_torch_gpu.py).

Each case draws its inputs from a seeded generator on the card and calls a
kernel's public wrapper: as is it launches the kernel, inside
`kernels.plain_kernels()` it runs the plain version on the same inputs.
Beside each case: the least time the card could take for the same work
(`bound_ms`, from utils/flops.py's `work`, which the package's work
counter sums over a forward) and, for the attention kernels, one PyTorch
call that computes the same function (`library_case`), timed as a
yardstick only. K6 has no such call; cuDNN's `conv_transpose2d` computes
its product alone (`product_case`), timed beside it as `product_ms`.

Training: `function_check` holds a grad-recording call of K1-K5 (through
its autograd Function) against the kernel's output and the plain
version's autodiff; `convnext_delta_case` is K5's delta-only mode.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from multimodal_sam_adapter_torch.models.adapter import reference_points
from multimodal_sam_adapter_torch.ops import kernels
from multimodal_sam_adapter_torch.ops.attention import (rel_pos_bias_terms,
                                                        split_heads)
from multimodal_sam_adapter_torch.ops.convnext_block import (
    convnext_block, convnext_block_delta)
from multimodal_sam_adapter_torch.ops.flash_attention import flash_attention
from multimodal_sam_adapter_torch.ops.msda_cuda import ms_deform_attn
from multimodal_sam_adapter_torch.ops.pixel_shuffle import pixel_shuffle_up_bn
from multimodal_sam_adapter_torch.ops.window_attention import window_attention
from multimodal_sam_adapter_torch.utils.flops import attention_geometry, work

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
# A grad-recording call's gradients (the Function's backward: the plain
# version recomputed, K2's one band of queries at a time) against the plain
# version's autodiff on the same inputs and cotangent: the largest relative
# L2 error over the inputs. Both are the same arithmetic up to summation
# order (K2's bands, atomics in grid_sample's backward); bf16 rounds every
# product's output.
GRAD_TOLERANCES = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


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
# K5: (H = W, C) of the four ConvNeXt-small stages at 1024^2, and the
# blocks of each stage in one forward (3/3/27/3 a branch, two branches)
CONVNEXT_STAGES = ((256, 96), (128, 192), (64, 384), (32, 768))
CONVNEXT_STAGE_CALLS = (6, 6, 54, 6)
# K6: (c2 grid side, embed) at 1024^2
PIXEL_SHUFFLE_FLAGSHIP = (128, EMBED)
# K3 / K4 off the flagship shapes: FMB's 800^2 (a 50x50 grid), slide's
# batch of 3 crops, `whole` mode's 1024x1824 (a 64x114 grid: a non-square
# pyramid with an odd level, 128x228 / 64x114 / 32x57), and deliver_tiny's
# widths (4 heads of D = 4, P = 2; a 4x4 grid, batch 2)
MSDA_RAGGED = (("fmb", dict(grid=(50, 50))),
               ("batch3", dict(batch=3)),
               ("whole_1024x1824", dict(grid=(64, 114))),
               ("tiny", dict(grid=(4, 4), batch=2, heads=4, points=2,
                             value_width=16)),
               # a tensor-parallel rank's share of the 16 heads of D = 32
               # at 4 and at 2 model ranks (parallel/tp.py)
               ("tp4_heads", dict(heads=4, value_width=4 * 32)),
               ("tp2_heads", dict(heads=8, value_width=8 * 32)))
# K3 in the Mask2Former head's pixel decoder (models/mask2former/
# pixel_decoder.py): the encoder's tokens sample their own three levels
# (stride 32, 16, 8), Lq = S, with the (1, S, 3, 2) reference points of the
# tokens' own pixel centres. At 1024^2 with the head at its defaults
# (deliver_rgblidar + model.head_type=mask2former): 32^2 + 64^2 + 128^2 =
# 21504 tokens, 8 heads of D = 64 (feat 512), 4 points; deliver_tiny_m2f's
# 64^2 input: 2^2 + 4^2 + 8^2 tokens, 8 heads of D = 4 (feat 32), batch 2
MSDA_PIXEL_DECODER = (
    ("m2f_pixel_decoder", dict(levels=((32, 32), (64, 64), (128, 128)),
                               heads=8, value_width=512)),
    ("m2f_tiny", dict(levels=((2, 2), (4, 4), (8, 8)), heads=8,
                      value_width=32, batch=2)))
# ragged shapes: the FMB (800^2) stage widths that fill no tile, and the
# narrow widths of the test configurations (atto trunk, embed 32)
CONVNEXT_RAGGED = ((25, 768), (50, 384), (16, 40))
# K6 off the flagship shapes, c1 and x1 NCHW unless named (as the flagship
# and FMB forwards hand them over): FMB's 800^2 (a 100x100 c2 grid: a
# ragged row tile), slide's batch of 3 crops (x1 channels-last, as slide's
# forward has it), `whole` mode's 1024x1824 (a 128x228 grid), the two other
# layout pairs, and the test configurations' embed 32 on an 8x8 grid at
# batch 2 (x1 channels-last, as there)
PIXEL_SHUFFLE_RAGGED = (("fmb", dict(grid=(100, 100))),
                        ("batch3", dict(batch=3, x1_layout="channels_last")),
                        ("whole_128x228", dict(grid=(128, 228))),
                        ("swapped_layouts", dict(c1_layout="channels_last")),
                        ("channels_last", dict(c1_layout="channels_last",
                                               x1_layout="channels_last")),
                        ("tiny", dict(grid=(8, 8), E=32, batch=2,
                                      x1_layout="channels_last")))
# K1 / K2 at the other test modes' shapes: FMB's 800^2 is a 50x50 token
# grid (padded to 56 for the windows: 16 of them; the global grid's
# 127-row pretrained tables resized to 99 rows), slide runs 3 crops a
# forward (75 windows, B = 3); a tensor-parallel rank runs 4 of the 16
# heads of 64 at 4 model ranks, 8 at 2 (parallel/tp.py)
ATTENTION_RAGGED = (("fmb", dict(grid=50, table_rows=2 * GRID - 1)),
                    ("batch3", dict(batch=3)),
                    ("tp4_heads", dict(heads=4)),
                    ("tp2_heads", dict(heads=8)))

# the card's peaks (NVIDIA's H100 SXM data sheet, dense): device memory
# bytes/s, bf16 and TF32 tensor-core FLOP/s, float32 FLOP/s outside the
# tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_TENSOR_BF16 = 989e12
PEAK_TENSOR_TF32 = 494.7e12
PEAK_FP32 = 67e12


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


def convnext_delta_case(hw: int, C: int, dtype: torch.dtype,
                        g: torch.Generator, batch: int = 1
                        ) -> Tuple[Callable, tuple]:
    """K5 in its delta-only mode (training: drop path acts on the delta
    before the add) on `convnext_case`'s inputs."""
    return convnext_block_delta, convnext_case(hw, C, dtype, g, batch)[1]


def _grad_run(fn: Callable, args: tuple, cot: torch.Tensor, plain: bool):
    """fn(*args) with every floating tensor argument requiring grad, its
    backward against `cot`: (output, [gradient of each such argument],
    the name of the output's grad_fn)."""
    leaves = [a.detach().requires_grad_() if torch.is_tensor(a)
              and a.is_floating_point() else a for a in args]
    with kernels.plain_kernels() if plain else contextlib.nullcontext():
        out = fn(*leaves)
        node = type(out.grad_fn).__name__
        out.backward(cot)
    return out.detach(), [a.grad for a in leaves
                          if torch.is_tensor(a) and a.requires_grad], node


def function_check(fn: Callable, args: tuple, g: torch.Generator
                   ) -> Dict[str, object]:
    """A grad-recording call of a kernel's wrapper (through its autograd
    Function) against the same call without autograd and against the
    plain version's autodiff: `same_output` (bit-equal to the kernel's
    output), `grad_rel_err` (the largest relative L2 error of a gradient,
    vs GRAD_TOLERANCES), `function` (the output's grad_fn)."""
    with torch.no_grad():
        want = fn(*args)
    cot = torch.randn(want.shape, generator=g, device=g.device).to(want.dtype)
    out, grads, node = _grad_run(fn, args, cot, plain=False)
    _, plain_grads, _ = _grad_run(fn, args, cot, plain=True)
    err = max(((a.float() - b.float()).norm() / b.float().norm()).item()
              for a, b in zip(grads, plain_grads))
    return dict(same_output=bool(torch.equal(out, want)), grad_rel_err=err,
                function=node)


def convnext_with_guard(x, *params):
    """K5 writing its output into the front of a buffer one image row
    longer whose tail is zeroed first; returns the whole buffer, so that a
    store past the last pixel shows as a nonzero tail (the plain version
    leaves it zero)."""
    B, H, W, C = x.shape
    buf = torch.empty((B * H * W + W, C), dtype=x.dtype, device=x.device)
    buf[B * H * W:].zero_()
    convnext_block(x, *params, out=buf[:B * H * W].view(B, H, W, C))
    return buf


def pixel_shuffle_case(grid, E: int, dtype: torch.dtype,
                       g: torch.Generator, batch: int = 1,
                       c1_layout: str = "nchw", x1_layout: str = "nchw"
                       ) -> Tuple[Callable, tuple]:
    """K6 on an h x w c2 grid (`grid`: (h, w) or a side) of E channels,
    with the operands in the backbone's layouts: c2 a view of the adapter's
    (batch, tokens, E) stream, whose c3 and c4 tokens follow c2's (so the
    batch stride is not h w E); c1 and x1 NCHW or channels-last maps. The
    flagship bf16 forward on the card hands over both NCHW; slide's batch
    of 3 has x1 channels-last (the bilinear resize of a token-grid view)."""
    h, w = (grid, grid) if isinstance(grid, int) else grid
    tokens = h * w + (h // 2) * (w // 2) + (h // 4) * (w // 4)
    c2 = _randn((batch, tokens, E), g, dtype)[:, :h * w].transpose(
        1, 2).reshape(batch, E, h, w)

    def output_map(layout):
        if layout == "nchw":
            return _randn((batch, E, 2 * h, 2 * w), g, dtype)
        if layout == "channels_last":
            return _randn((batch, 2 * h, 2 * w, E), g, dtype).permute(
                0, 3, 1, 2)
        raise ValueError(layout)

    c1 = output_map(c1_layout)
    x1 = output_map(x1_layout)
    weight = _randn((E, E, 2, 2), g, dtype, E ** -0.5)
    scale = 1 + _randn((E,), g, torch.float32, 0.05)
    shift = _randn((E,), g, torch.float32, 0.05)
    return pixel_shuffle_up_bn, (c2, weight, c1, x1, scale, shift)


def product_case(args: tuple) -> Tuple[Callable, tuple]:
    """The part of K6's work that is a GEMM, as one cuDNN call on K6's own
    c2 and weight: the transposed conv (product and depth-to-space),
    without c1, x1 or the affine. Not the same function as K6, so a
    yardstick of the product only, never a `library_ms`."""
    return _conv_transpose_2x2, args[:2]


def _conv_transpose_2x2(c2, weight):
    return F.conv_transpose2d(c2, weight, stride=2)


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
    if name in ("window_attention", "flash_attention"):
        return attention_case(name, dtype, g)
    return msda_case(name, dtype, g)


def msda_case(name: str, dtype: torch.dtype, g: torch.Generator,
              grid: Tuple[int, int] = (GRID, GRID), batch: int = 1,
              heads: int = DEF_HEADS, points: int = DEF_POINTS,
              value_width: int = DEF_VALUE) -> Tuple[Callable, tuple]:
    """K3 (the injector: the ViT's grid tokens sample the pyramid 2x / 1x /
    0.5x the grid) or K4 (the extractor: the pyramid's tokens sample the
    grid) for `batch` images, with the model's (1, Lq, L, 2) reference
    points broadcast over the batch."""
    H, W = grid
    pyramid = ((2 * H, 2 * W), (H, W), (H // 2, W // 2))
    if name == "msda_multi_level":
        q_shapes, v_shapes = (grid,), pyramid
    elif name == "msda_single_level":
        q_shapes, v_shapes = pyramid, (grid,)
    else:
        raise KeyError(name)
    L = len(v_shapes)
    S = sum(h * w for h, w in v_shapes)
    ref = torch.as_tensor(reference_points(q_shapes), device=g.device)
    Lq = ref.shape[1]
    ref = ref.expand(1, Lq, L, 2).contiguous()
    value = _randn((batch, S, value_width), g, dtype)
    # offsets of several level pixels: some samples land outside the grid
    offs = _randn((batch, Lq, heads * L * points * 2), g, dtype, 8.0)
    logits = _randn((batch, Lq, heads * L * points), g, dtype)
    return ms_deform_attn, (value, v_shapes, ref, offs, logits, heads,
                            points)


def msda_encoder_case(dtype: torch.dtype, g: torch.Generator,
                      levels: Tuple[Tuple[int, int], ...], heads: int,
                      value_width: int, batch: int = 1,
                      points: int = DEF_POINTS) -> Tuple[Callable, tuple]:
    """K3 as the pixel decoder's encoder calls it: every token of the
    `levels` queries them all from its own pixel centre (the reference
    points broadcast over the levels and the batch, materialised)."""
    L = len(levels)
    S = sum(h * w for h, w in levels)
    ref = torch.as_tensor(reference_points(levels), device=g.device)
    ref = ref.expand(1, S, L, 2).contiguous()
    value = _randn((batch, S, value_width), g, dtype)
    offs = _randn((batch, S, heads * L * points * 2), g, dtype, 8.0)
    logits = _randn((batch, S, heads * L * points), g, dtype)
    return ms_deform_attn, (value, levels, ref, offs, logits, heads, points)


def _stage_label(shape) -> str:
    return "x".join(str(v) for v in (shape[0], shape[0], shape[1]))


def cases(name: str, dtype: torch.dtype, seed: int = 0):
    """Every case of one kernel: (label, on_main_path, (wrapper, args)).
    The flagship shapes (K5: its four stages) are on the main path; K1 and
    K2 also run at `ATTENTION_RAGGED`, K3 and K4 at `MSDA_RAGGED`, K3 at
    the Mask2Former pixel decoder's `MSDA_PIXEL_DECODER`, K5 at
    `CONVNEXT_RAGGED` and at its first ragged shape with batch 3, writing
    into a guarded buffer (`convnext_with_guard`), K6 at
    `PIXEL_SHUFFLE_RAGGED`. Each case draws from its own generator seeded
    with `seed`."""
    def gen():
        return torch.Generator(device="cuda").manual_seed(seed)

    for shape in flagship_shapes(name):
        label = "flagship" if shape is None else _stage_label(shape)
        yield label, True, flagship_case(name, dtype, gen(), shape)
    if name in ("window_attention", "flash_attention"):
        for label, kw in ATTENTION_RAGGED:
            yield label, False, attention_case(name, dtype, gen(), **kw)
    if name in ("msda_multi_level", "msda_single_level"):
        for label, kw in MSDA_RAGGED:
            yield label, False, msda_case(name, dtype, gen(), **kw)
    if name == "msda_multi_level":
        for label, kw in MSDA_PIXEL_DECODER:
            yield label, False, msda_encoder_case(dtype, gen(), **kw)
    if name == "pixel_shuffle_up_bn":
        for label, kw in PIXEL_SHUFFLE_RAGGED:
            kw = dict(kw)
            yield label, False, pixel_shuffle_case(
                kw.pop("grid", PIXEL_SHUFFLE_FLAGSHIP[0]),
                kw.pop("E", EMBED), dtype, gen(), **kw)
    if name == "convnext_block":
        ragged = [(s, 1) for s in CONVNEXT_RAGGED] + [(CONVNEXT_RAGGED[0], 3)]
        for shape, batch in ragged:
            _, args = convnext_case(*shape, dtype, gen(), batch=batch)
            label = _stage_label(shape) + (f"_batch{batch}" if batch > 1
                                           else "")
            yield label, False, (convnext_with_guard, args)


def attention_case(name: str, dtype: torch.dtype, g: torch.Generator,
                   batch: int = 1, grid: int = GRID,
                   table_rows: Optional[int] = None, heads: int = HEADS
                   ) -> Tuple[Callable, tuple]:
    """K1 or K2 for `batch` images of a grid x grid token map of ViT-L
    (`heads` of its heads of 64): K1 over its 14x14 windows (the map
    zero-padded to whole windows), K2 over the whole grid with rel-pos
    tables of `table_rows` rows (default 2 * grid - 1, the grid's own;
    other lengths are resized)."""
    d = EMBED // HEADS
    width = 3 * heads * d
    if name == "window_attention":
        windows = batch * (-(-grid // WINDOW)) ** 2  # 64 padded to 70: 25
        qkv = _randn((windows, WINDOW * WINDOW, width), g, dtype)
        rows, hw = 2 * WINDOW - 1, WINDOW
        fn = window_attention
    elif name == "flash_attention":
        qkv = _randn((batch, grid * grid, width), g, dtype)
        rows, hw = table_rows or 2 * grid - 1, (grid, grid)
        fn = flash_attention
    else:
        raise KeyError(name)
    rph = _randn((rows, d), g, dtype, 0.5)
    rpw = _randn((rows, d), g, dtype, 0.5)
    return fn, (qkv, rph, rpw, hw, heads, d ** -0.5)


def library_case(name: str, args: tuple) -> Tuple[Callable, tuple]:
    """One `F.scaled_dot_product_attention` call computing what K1 / K2
    compute on `args`: contiguous q, k, v (windows | B, heads, N, d) and
    the decomposed rel-pos bias materialised as the bf16 (or float32)
    `attn_mask` (windows | B, heads, N, N), from the unscaled q as the
    kernels take it. The operands are built here, outside any timed call;
    the 4-D form is the one SDPA's fused backends accept."""
    if name not in ("window_attention", "flash_attention"):
        raise KeyError(f"{name}: no single library call computes it")
    qkv, rph, rpw, _, heads, scale = args
    BM, N, d, (H, W) = attention_geometry(args)
    q, k, v = (t.reshape(-1, heads, N, d).contiguous()
               for t in split_heads(qkv, heads))
    rel_h, rel_w = rel_pos_bias_terms(q.view(BM, N, d).float(), rph.float(),
                                      rpw.float(), (H, W), (H, W))
    bias = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(
        -1, heads, N, N)
    return _sdpa, (q, k, v, bias.to(qkv.dtype), scale)


def _sdpa(q, k, v, bias, scale):
    return F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                          scale=scale)


def time_library(name: str, args: tuple, iters: int = 10
                 ) -> Tuple[float, str, torch.Tensor]:
    """The fastest SDPA backend that accepts `library_case(name, args)`:
    (ms per call, backend name, its output)."""
    import warnings

    from torch.nn.attention import SDPBackend, sdpa_kernel

    fn, largs = library_case(name, args)
    best = None
    for backend in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION",
                    "CUDNN_ATTENTION", "MATH"):
        if not hasattr(SDPBackend, backend):
            continue
        with sdpa_kernel([getattr(SDPBackend, backend)]), \
                warnings.catch_warnings():
            warnings.simplefilter("ignore")  # "...not used because..."
            try:
                out = fn(*largs)
                torch.cuda.synchronize()
            except RuntimeError:
                continue
            ms = time_ms(fn, largs, iters=iters)
        if best is None or ms < best[0]:
            best = (ms, backend.lower(), out)
    if best is None:
        raise RuntimeError(f"{name}: no SDPA backend takes the call")
    return best


def msda_gather_bytes(args: tuple) -> float:
    """The value bytes K3/K4 gather on `args`: four corners of D values a
    sample, each corner a row segment of its own, out-of-grid corners
    included. At the flagship shapes the value tensor fits the 50 MB L2,
    so these are L2 reads, a floor beside `bound_ms`'s unique bytes."""
    value, shapes, _, offs, _, heads, points = args
    B, Lq, _ = offs.shape
    D = value.shape[-1] // heads
    return float(B * Lq * heads * len(shapes) * points * 4 * D
                 * value.element_size())


def bound_ms(name: str, args: tuple, out: torch.Tensor
             ) -> Tuple[float, str]:
    """The least time the card could take for `work(name, args, out)`:
    the larger of its bytes over the memory rate and its operations over
    the peak rates of their type (matrix products on the tensor cores, at
    the bf16 rate or, in float32, at TF32's; everything else at the
    float32 rate; the two kinds of unit run side by side, so the slower
    one counts). A float32 kernel that keeps float32 accuracy on the
    tensor cores (K5's 3xTF32: three TF32 products for each) reaches a
    third of this bound at most. Returns (ms, "bytes" or "operations")."""
    w = work(name, args, out)
    bytes_s = w["bytes"] / PEAK_BYTES_PER_S
    tensor_peak = (PEAK_TENSOR_BF16 if out.dtype == torch.bfloat16
                   else PEAK_TENSOR_TF32)
    ops_s = max(w["tensor_ops"] / tensor_peak, w["other_ops"] / PEAK_FP32)
    if bytes_s >= ops_s:
        return bytes_s * 1e3, "bytes"
    return ops_s * 1e3, "operations"


def kernel_us(fn: Callable, args: tuple, trace: "Path", calls: int = 10
              ) -> Dict[str, float]:
    """Device microseconds per call of each kernel, copy and memset that
    `fn(*args)` launches, by name, from a `torch.profiler` trace (written
    to `trace`)."""
    import json

    fn(*args)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    us: Dict[str, float] = {}
    for e in json.loads(trace.read_text())["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                   "gpu_memset"):
            name = e["name"].split("(")[0]
            us[name] = us.get(name, 0.0) + float(e.get("dur", 0.0)) / calls
    return us


def main(argv=None) -> None:
    """Check kernels against their plain versions on the card, built from
    the package's csrc/ or from another copy of it (`--csrc`, for a
    mutation check: build and check each copy in a process of its own).
    One JSON line per case: the largest error and its largest ratio to the
    tolerance (with `--time`, the kernel's ms per call); exit 1 if a case
    is past it."""
    import argparse
    import hashlib
    import json
    from pathlib import Path

    ap = argparse.ArgumentParser(description=main.__doc__.split("\n")[0])
    ap.add_argument("--csrc", type=Path,
                    help="a copy of csrc/ to build (into kernels/ beside it)")
    ap.add_argument("--names", nargs="+", default=list(KERNELS),
                    choices=list(KERNELS))
    ap.add_argument("--dtypes", nargs="+", default=["bf16"],
                    choices=["f32", "bf16"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shapes", nargs="+",
                    help="only the cases of these labels (e.g. 64x64x384)")
    ap.add_argument("--time", action="store_true",
                    help="also time each case (CUDA events, 20 calls; K6: "
                         "and its product alone in cuDNN, `product_ms`)")
    ap.add_argument("--profile", action="store_true",
                    help="also give each case's device us per kernel name "
                         "(torch.profiler; traces under build/profiles/)")
    ap.add_argument("--library", action="store_true",
                    help="K1 / K2: also time SDPA on the case's inputs "
                         "(`time_library`), as `library_ms`")
    ap.add_argument("--digest", action="store_true",
                    help="also give a sha256 of the kernel's output bytes, "
                         "to hold two builds bit-equal")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the kernel checks need a CUDA card")
    if args.csrc is not None:
        kernels.CSRC = args.csrc.resolve()
        kernels.BUILD_ROOT = args.csrc.resolve().parent / "kernels"
    kernels.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    failed = False
    for name in args.names:
        for tag in args.dtypes:
            tol = TOLERANCES[dtypes[tag]]
            for label, _, (fn, fargs) in cases(name, dtypes[tag], args.seed):
                if args.shapes and label not in args.shapes:
                    continue
                got = fn(*fargs)
                want = plain_reference(fn, fargs).float()
                diff = (got.float() - want).abs()
                ratio = (diff / (tol["atol"] + tol["rtol"] * want.abs()))
                ratio = ratio.nan_to_num(float("inf")).max().item()
                failed |= not ratio <= 1.0
                res = dict(
                    name=name, shape=label, dtype=tag,
                    max_abs_err=diff.nan_to_num(float("inf")).max().item(),
                    worst_err_over_tolerance=ratio)
                if name.startswith("msda"):
                    res["gather_mb"] = msda_gather_bytes(fargs) / 1e6
                if args.time:
                    res["ms"] = time_ms(fn, fargs, iters=20)
                    if name == "pixel_shuffle_up_bn":
                        res["product_ms"] = time_ms(*product_case(fargs),
                                                    iters=20)
                if args.library and name in ("window_attention",
                                             "flash_attention"):
                    ms, backend, _ = time_library(name, fargs, iters=20)
                    res.update(library_ms=ms, library_backend=backend)
                if args.digest:
                    res["sha256"] = hashlib.sha256(
                        got.contiguous().view(torch.uint8).cpu().numpy()
                        .tobytes()).hexdigest()
                if args.profile:
                    res["kernel_us"] = kernel_us(
                        fn, fargs, Path(__file__).resolve().parent / "build"
                        / "profiles" / f"{name}_{label}_{tag}.json")
                print(json.dumps(res), flush=True)
    raise SystemExit(1 if failed else 0)


if __name__ == "__main__":
    main()
