"""Where the forward's time goes on the card: device busy time, device idle
share and device time by op family, from a `torch.profiler` trace, next to
the same calls timed without the profiler.

The profiler itself slows the host (it records every op and launch), so
its trace window overstates the idle share of a host-bound forward. The
figures that stand for the forward as served are therefore:

- `busy_ms`: the union of the device intervals (kernels, copies, memsets)
  in the profiled run, per call. Kernel durations do not depend on the
  host, so this is the device's work with or without the profiler;
- `unprofiled_ms`: the same calls without the profiler, between two CUDA
  events (the device's clock, from the first call's submission to the last
  call's end), per call: the median of `repeats` timings, all of which are
  kept in `unprofiled_ms_all` (the host's speed varies from run to run);
- `idle_share` = 1 - busy_ms / unprofiled_ms, and `idle_share_range` over
  the repeats.

`profiled_ms` and `profiled_idle_share` come from the trace window alone;
`profiled_ms - unprofiled_ms` is the profiler's own cost.

Beside them, `annotate(name)`: the port's one span API. Under a running
`torch.profiler` it opens a `torch.profiler.record_function`, so the span
lands in the same trace, on the same clock, as the kernels and copies it
launched; with no profiler running it returns one shared no-op context
and constructs nothing. The program's spans are named `msa.<phase>`:

- `msa.predict` (a call of `InferenceEngine.predict` or `aug_test`) and
  its phases `.stage` (slide's host crop stack), `.h2d` (the input to the
  model's device and dtype), `.forward`, `.post` (valid-band crop,
  resizes, slide's scatter-add, softmax, flip, argmax) and `.d2h`;
- `msa.train_step` (a micro-step of `make_train_step`) and its
  `.forward` (autocast and the loss), `.backward` and `.update`
  (`optimizer.step()`, which updates on every `grad_accum_steps`-th);
- `msa.data`, `msa.checkpoint` and `msa.eval`, the epoch runner's phases.

A `torch.profiler.profile` around any call shows them.

Run on the card, from the root of a checkout:

    python3 -m multimodal_sam_adapter_torch.utils.profiling \
        [--calls 3] [--repeats 5]

It builds the deliver_rgblidar EncoderDecoder at full width with weights
drawn from a seeded generator, casts it to bfloat16, and profiles
`InferenceEngine.logits` at B=1, 1024x1024, through the kernels and
through the plain versions. It prints one JSON line per path and writes the
traces under build/profiles/.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import re
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Tuple

import torch

# device event categories of the exported trace
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

# op family -> pattern on the kernel name; the first match wins
FAMILIES: Tuple[Tuple[str, str], ...] = (
    ("K1/K2 attention", r"rel_pos_attention"),
    ("K3/K4 msda", r"msda_\w*kernel"),
    ("K5 convnext block", r"convnext_block"),
    ("K6 f1 assembly", r"pixel_shuffle"),
    ("plain grid_sample", r"grid_sampler"),
    ("conv (cuDNN)", r"conv|tensorTransformGeneric|cudnn|fprop"),
    ("GEMM (cuBLAS)", r"gemm|nvjet|cutlass|xmma"),
    ("norms", r"norm|welford"),
    ("resize", r"upsample"),
    ("softmax", r"softmax|SoftMax"),
    ("copies", r"copy|Copy|memcpy|memset|Memcpy|Memset"),
    ("elementwise", r"elementwise|reduce_kernel"),
)


_OFF = contextlib.nullcontext()


def annotate(name: str):
    """A named span around host code in a running `torch.profiler` trace;
    with no profiler running, a shared no-op context."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


def family(name: str) -> str:
    for fam, pattern in FAMILIES:
        if re.search(pattern, name):
            return fam
    return "other"


def _union_length(intervals: List[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def device_summary(events: Iterable[dict], calls: int) -> Dict:
    """Per-call device figures from the events of a Chrome trace (`ts` and
    `dur` in microseconds): busy and window milliseconds, the idle share
    of the window, kernel launches, and device milliseconds by family."""
    spans, by_family, kernels = [], {}, 0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        spans.append((a, b))
        fam = family(e.get("name", ""))
        by_family[fam] = by_family.get(fam, 0.0) + (b - a)
        kernels += e["cat"] == "kernel"
    if not spans:
        raise RuntimeError("the trace holds no device events")
    busy = _union_length(spans) / 1e3
    window = (max(b for _, b in spans) - min(a for a, _ in spans)) / 1e3
    return dict(
        busy_ms=busy / calls, profiled_ms=window / calls,
        profiled_idle_share=1.0 - busy / window,
        kernel_launches=kernels / calls,
        family_ms={k: v / 1e3 / calls for k, v in
                   sorted(by_family.items(), key=lambda kv: -kv[1])})


def time_calls(fn: Callable[[], object], calls: int) -> Tuple[float, float]:
    """(device ms, host ms) per call of `calls` back-to-back calls: CUDA
    events around them, and the host clock up to the final sync."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3
    return start.elapsed_time(end) / calls, host / calls


def profile_calls(fn: Callable[[], object], calls: int, trace_path: Path,
                  repeats: int = 5) -> Dict:
    """Time `calls` calls of `fn` without the profiler `repeats` times, then
    trace `calls` calls under `torch.profiler` (trace written to
    `trace_path`), and return the figures described at the top of this
    module."""
    timings = sorted(time_calls(fn, calls) for _ in range(repeats))
    unprofiled, host = timings[len(timings) // 2]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_path))
    events = json.loads(trace_path.read_text())["traceEvents"]
    out = device_summary(events, calls)
    out.update(unprofiled_ms=unprofiled, unprofiled_host_ms=host,
               unprofiled_ms_all=[t for t, _ in timings],
               idle_share=1.0 - out["busy_ms"] / unprofiled,
               idle_share_range=[1.0 - out["busy_ms"] / t for t, _ in
                                 (timings[0], timings[-1])],
               profiler_cost_ms=out["profiled_ms"] - unprofiled)
    return out


def main(argv=None) -> None:
    from ..configs.registry import get_config
    from ..engine.inference import InferenceEngine
    from ..models.segmentor import build_segmentor
    from ..ops import kernels

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-dir", type=Path, default=Path(
        __file__).resolve().parents[2] / "build" / "profiles")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA card")

    cfg = get_config("deliver_rgblidar")
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    model = build_segmentor(cfg["model"], "cuda", generator=g)
    engine = InferenceEngine(model.to(torch.bfloat16), cfg["test_cfg"])
    img = torch.randn((1, 1024, 1024, 6), generator=g,
                      device="cuda").to(torch.bfloat16)
    for path in ("kernel", "plain"):
        ctx = (kernels.plain_kernels() if path == "plain"
               else contextlib.nullcontext())
        with ctx:
            for _ in range(2):           # warm-up: build, autotune, caches
                engine.logits(img)
            res = profile_calls(lambda: engine.logits(img), args.calls,
                                args.trace_dir / f"forward_{path}.json",
                                args.repeats)
        print(json.dumps(dict(path=path, calls=args.calls,
                              device=torch.cuda.get_device_name(0), **res)),
              flush=True)


if __name__ == "__main__":
    main()
