"""The benchmark's frozen arithmetic: the card's peaks, the work each
kernel family must do at a cell's shapes and its least time, a step's
operations counted on the reference, and the reduction of a Chrome trace
to device busy time, launches, time by family and idle gaps.

These are copies kept with the benchmark (the peaks and `bound_ms` of the
repository's kernel checks, the `work` formulas of the program's
`utils/flops.py`, the interval union and families of its
`utils/profiling.py`), so that a change to the program cannot move the
yardstick.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense rates: device memory bytes/s, bf16 and
# TF32 tensor-core FLOP/s, float32 FLOP/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_TENSOR_BF16 = 989e12
PEAK_TENSOR_TF32 = 494.7e12
PEAK_FP32 = 67e12

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

# op family -> pattern on the device event's name; the first match wins
FAMILIES: Tuple[Tuple[str, str], ...] = (
    ("attention", r"rel_pos_attention"),
    ("msda", r"msda_\w*kernel"),
    ("convnext", r"convnext_block"),
    ("f1_assembly", r"pixel_shuffle"),
    ("grid_sample", r"grid_sampler"),
    ("conv_cudnn", r"conv|tensorTransformGeneric|cudnn|fprop"),
    ("gemm_cublas", r"gemm|nvjet|cutlass|xmma"),
    ("norms", r"norm|welford"),
    ("resize", r"upsample"),
    ("softmax", r"softmax|SoftMax"),
    ("copies", r"copy|Copy|memcpy|memset|Memcpy|Memset"),
    ("elementwise", r"elementwise|reduce_kernel"),
)


def family(name: str) -> str:
    for fam, pattern in FAMILIES:
        if re.search(pattern, name):
            return fam
    return "other"


# --------------------------------------------------------------- work

def attention_work(batch: int, tokens: int, width: int, heads: int,
                   hw: Tuple[int, int], table_rows: Tuple[int, int],
                   itemsize: int) -> Dict[str, float]:
    """One call of windowed (batch = images x windows) or global attention
    with the decomposed rel-pos bias, on the raw qkv projection: read qkv
    and both tables once, write the heads-packed output once."""
    d = width // heads
    H, W = hw
    nbytes = itemsize * (batch * tokens * 4 * width
                         + (table_rows[0] + table_rows[1]) * d)
    BM, N = batch * heads, tokens
    return dict(bytes=float(nbytes),
                tensor_ops=BM * (4.0 * N * N * d + 2.0 * N * (H + W) * d),
                other_ops=BM * 6.0 * N * N)


def convnext_work(batch: int, H: int, W: int, C: int,
                  itemsize: int) -> Dict[str, float]:
    """One ConvNeXt block: read x and the block's parameters once, write
    its output once; fc1 and fc2 on the tensor cores; the 7x7 depthwise
    conv, LayerNorm, GELU, layer scale and shortcut elsewhere."""
    P = batch * H * W
    params = 49 * C + C + 2 * C + 4 * C * C + 4 * C + 4 * C * C + C + C
    return dict(bytes=float(itemsize * (2 * P * C + params)),
                tensor_ops=2.0 * P * C * 4 * C * 2,
                other_ops=P * C * (2.0 * 49 + 10 + 4 * 8))


def pixel_shuffle_work(batch: int, H: int, W: int, C: int, O: int,
                       itemsize: int) -> Dict[str, float]:
    """The f1 assembly: the 2x2 stride-2 transposed conv of c2 (B, C, H,
    W) to O channels, plus c1 and x1, through the eval BatchNorm's affine
    (float32 scale and shift)."""
    out = batch * O * 4 * H * W
    nbytes = itemsize * (batch * C * H * W + C * O * 4 + 3 * out) + 8 * O
    return dict(bytes=float(nbytes),
                tensor_ops=2.0 * batch * H * W * C * 4 * O,
                other_ops=4.0 * batch * H * W * 4 * O)


def bound_ms(w: Dict[str, float], tensor_peak: float = PEAK_TENSOR_BF16
             ) -> float:
    """The least time for work `w`: the larger of its bytes over the
    memory rate and its operations over the peak of their unit (products
    on the tensor cores, the rest on the float32 units, side by side)."""
    ops_s = max(w["tensor_ops"] / tensor_peak, w["other_ops"] / PEAK_FP32)
    return max(w["bytes"] / PEAK_BYTES_PER_S, ops_s) * 1e3


# ---------------------------------------------------- a step's kernel calls

CONVNEXT_ARCHS = {
    "atto": ((2, 2, 6, 2), (40, 80, 160, 320)),
    "small": ((3, 3, 27, 3), (96, 192, 384, 768)),
}


def family_bounds_ms(model_cfg: dict, images: int, hw: Tuple[int, int],
                     forwards: int = 1, itemsize: int = 2
                     ) -> Dict[str, float]:
    """The least time a step's calls of each kernel family take: `images`
    images of `hw` through `forwards` forwards (a training micro-step
    under activation checkpointing runs each forward twice), bf16."""
    bb = model_cfg["backbone"]
    H, W = hw
    depths, chans = CONVNEXT_ARCHS[bb["arch"]]
    conv = 0.0
    for i, (d, c) in enumerate(zip(depths, chans)):
        s = 2 ** (i + 2)
        conv += 2 * d * bound_ms(convnext_work(images, H // s, W // s, c,
                                               itemsize))
    E, heads, ws = bb["embed_dim"], bb["num_heads"], bb["window_size"]
    gh, gw = H // bb["patch_size"], W // bb["patch_size"]
    grid = bb["pretrained_size"] // bb["patch_size"]
    n_global = len(bb["global_attn_indexes"])
    windows = math.ceil(gh / ws) * math.ceil(gw / ws)
    attn = (bb["depth"] - n_global) * bound_ms(attention_work(
        images * windows, ws * ws, E, heads, (ws, ws),
        (2 * ws - 1, 2 * ws - 1), itemsize))
    attn += n_global * bound_ms(attention_work(
        images, gh * gw, E, heads, (gh, gw), (2 * grid - 1, 2 * grid - 1),
        itemsize))
    return dict(convnext=forwards * conv, attention=forwards * attn)


# ----------------------------------------------------------- trace reduction

def busy_intervals(intervals: Iterable[Tuple[float, float]]
                   ) -> List[Tuple[float, float]]:
    """The union of intervals as disjoint sorted intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def device_summary(events: Sequence[dict], top: int = 10) -> Dict:
    """Device figures from Chrome-trace events (`ts`, `dur` in us): busy
    seconds (the union of kernel, copy and memset intervals), kernel
    launches, seconds by family, the
    `top` device ops by seconds, and the `top` idle gaps between device
    intervals by what the host was doing at the gap's start (the innermost
    host op then running), in seconds."""
    spans, by_family, by_name, launches = [], {}, {}, 0
    host = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if cat in DEVICE_CATEGORIES:
            spans.append((a, b))
            name = e.get("name", "")
            fam = family(name)
            by_family[fam] = by_family.get(fam, 0.0) + (b - a) / 1e6
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
            launches += cat == "kernel"
        elif cat in ("cpu_op", "user_annotation"):
            host.append((a, b, e.get("name", "")))
    if not spans:
        raise RuntimeError("the trace holds no device events")
    busy = busy_intervals(spans)
    gaps: Dict[str, float] = {}
    host.sort()
    stack: List[Tuple[float, float, str]] = []   # open host ops, nested
    i = 0
    for (_, end), (start, _) in zip(busy, busy[1:]):
        while i < len(host) and host[i][0] <= end:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < end:
            stack.pop()
        doing = stack[-1][2] if stack else "idle host"
        gaps[doing] = gaps.get(doing, 0.0) + (start - end) / 1e6
    ranked = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
    return dict(busy_s=sum(b - a for a, b in busy) / 1e6,
                launches=launches, family_s=by_family,
                device_ops=[list(kv) for kv in ranked(by_name)],
                idle_gaps=[list(kv) for kv in ranked(gaps)])


# -------------------------------------------------------------- operations

def _conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride,
                         _padding, _dilation, transposed, _output_padding,
                         _groups, output_mask, out_shape=None, **_kw) -> int:
    """A convolution's backward: the forward's operations once for the
    input's gradient and once for the weight's, each where asked for.
    (FlopCounterMode's own formula ignores `groups` here and counts a
    depthwise convolution's backward as a dense one's.) w_shape holds
    the input channels a group, so 2 x the output (input, when
    transposed) elements x the weight's other sizes is the forward's."""
    fwd = 2 * math.prod(x_shape if transposed else grad_out_shape) * \
        math.prod(w_shape[1:])
    return fwd * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def count_flops(model_cfg: dict, batch: int, hw: Tuple[int, int],
                train: bool) -> float:
    """Operations of one step on the reference, counted on `meta` by
    torch's FlopCounterMode (2 a multiply-add of every product and
    convolution): the forward of `batch` images of `hw`, or, with `train`,
    the loss's forward and backward (no recompute)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from .reference.model import build

    model = build(model_cfg, "meta").eval()
    chans = sum(model_cfg["backbone"]["modalities_ch"])
    img = torch.empty((batch, hw[0], hw[1], chans), device="meta")
    custom = {torch.ops.aten.convolution_backward: _conv_backward_flops}
    with FlopCounterMode(display=False, custom_mapping=custom) as fc:
        if train:
            gt = torch.zeros((batch,) + tuple(hw), dtype=torch.long,
                             device="meta")
            model.loss(img, gt).backward()
        else:
            with torch.no_grad():
                model(img)
    return float(fc.get_total_flops())


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The nearest-rank q-th percentile (q in (0, 100])."""
    if not values:
        return None
    s = sorted(values)
    return s[max(math.ceil(q / 100.0 * len(s)) - 1, 0)]


# ------------------------------------------------- per-layer metric arithmetic

def mfu_percent(ctx: Dict) -> float:
    """The step's operations over the untraced window's time per step,
    against the bf16 tensor-core peak."""
    return (ctx["flops_per_step"] * ctx["steps"] / ctx["window_s"]
            / PEAK_TENSOR_BF16 * 100.0)


def idle_percent(ctx: Dict) -> float:
    """1 - device busy per step (traced) / time per step (untraced)."""
    t = ctx["trace"]
    return (1.0 - (t["busy_s"] / t["steps"])
            / (ctx["window_s"] / ctx["steps"])) * 100.0


def launches_per_step(ctx: Dict) -> float:
    t = ctx["trace"]
    return t["launches"] / t["steps"]


def roofline_percent(ctx: Dict, fam: str) -> Optional[float]:
    """A family's least time at the step's shapes over its device time in
    the trace; None where the trace holds none of its kernels."""
    t = ctx["trace"]
    spent = t["family_s"].get(fam, 0.0)
    if spent <= 0.0:
        return None
    return ctx["bounds_ms"][fam] / 1e3 * t["steps"] / spent * 100.0
