"""Device idle time, kernel launches and bytes copied by the program's
phase, from the Chrome trace that `harness.trace_window` has just written
(the newest build/port_bench/<cell>.trace.json written since this process
started). The phases are the program's `msa.*` spans
(multimodal_sam_adapter_torch/utils/profiling.py:annotate), which land in
that trace on the device timeline's clock:

- idle: the gaps between the union of the device intervals (as
  yardstick.device_summary builds them), each split at span boundaries;
  each part goes to the innermost `msa.*` span covering that instant (the
  one started last), or to `outside`, so that the phases sum to the gaps;
- kernels: each `kernel` event goes to the span open when its launch call
  (the `cuda_runtime` or `cuda_driver` event of the same `correlation`:
  cuBLAS launches through the driver API) started, or to `outside`;
- bytes: each `gpu_memcpy` event's `args.bytes`, as kernels go.

A trace of a program without the spans has every phase `outside`; the
readers then return None. To print a trace's reduction:

    python3 -m port_bench.phases build/port_bench/<cell>.trace.json
"""
from __future__ import annotations

import bisect
import functools
import json
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from . import harness, yardstick

PREFIX = "msa."
OUTSIDE = "outside"
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
TRACES = harness.REPO / "build" / "port_bench"

Span = Tuple[float, float, str]


def phase_map(spans: Iterable[Span]) -> Tuple[List[float], List[str]]:
    """(times, names): from times[i] until times[i + 1] (the last: on
    without end) the innermost span is names[i]; before times[0], and
    where no span is open, `outside`."""
    spans = sorted(s for s in spans if s[1] > s[0])
    cuts = sorted({t for a, b, _ in spans for t in (a, b)})
    times, names, active, j = [], [], [], 0
    for t in cuts:
        active = [s for s in active if s[1] > t]
        while j < len(spans) and spans[j][0] <= t:
            if spans[j][1] > t:
                active.append(spans[j])
            j += 1
        inner = max(active, key=lambda s: (s[0], -s[1]), default=None)
        times.append(t)
        names.append(inner[2] if inner else OUTSIDE)
    return times, names


def phase_at(times: Sequence[float], names: Sequence[str], t: float) -> str:
    i = bisect.bisect_right(times, t) - 1
    return names[i] if i >= 0 else OUTSIDE


def split_gap(times: Sequence[float], names: Sequence[str], a: float,
              b: float, into: Dict[str, float]) -> None:
    """Add the parts of [a, b) to `into` by the phase over each, in us."""
    i = bisect.bisect_right(times, a) - 1
    while a < b:
        end = min(b, times[i + 1]) if i + 1 < len(times) else b
        name = names[i] if i >= 0 else OUTSIDE
        into[name] = into.get(name, 0.0) + (end - a)
        a = end
        i += 1


def reduce(events: Iterable[dict]) -> Optional[Dict]:
    """`idle_s`, `kernels` and `bytes` by phase, their totals (`gap_s`,
    `launches`) and the number of spans of each name (`spans`); None where
    the trace holds no device events."""
    device, spans, launch_ts = [], [], {}
    kernels, copies = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        args = e.get("args") or {}
        if cat in yardstick.DEVICE_CATEGORIES:
            device.append((a, b))
            if cat == "kernel":
                kernels.append(args.get("correlation"))
            elif cat == "gpu_memcpy":
                copies.append((args.get("correlation"),
                               int(args.get("bytes", 0))))
        elif cat in LAUNCH_CATEGORIES and "correlation" in args:
            launch_ts[args["correlation"]] = a
        elif cat == "user_annotation" and e.get("name", "").startswith(
                PREFIX):
            spans.append((a, b, e["name"]))
    if not device:
        return None
    times, names = phase_map(spans)

    def launched_in(corr) -> str:
        t = launch_ts.get(corr)
        return OUTSIDE if t is None else phase_at(times, names, t)

    idle: Dict[str, float] = {}
    busy = yardstick.busy_intervals(device)
    for (_, end), (start, _) in zip(busy, busy[1:]):
        split_gap(times, names, end, start, idle)
    by_kernel: Dict[str, int] = {}
    for corr in kernels:
        p = launched_in(corr)
        by_kernel[p] = by_kernel.get(p, 0) + 1
    by_bytes: Dict[str, int] = {}
    for corr, nbytes in copies:
        p = launched_in(corr)
        by_bytes[p] = by_bytes.get(p, 0) + nbytes
    counts: Dict[str, int] = {}
    for _, _, name in spans:
        counts[name] = counts.get(name, 0) + 1
    return dict(idle_s={k: v / 1e6 for k, v in idle.items()},
                gap_s=sum(idle.values()) / 1e6, kernels=by_kernel,
                launches=len(kernels), bytes=by_bytes, spans=counts)


@functools.lru_cache(maxsize=1)
def _reduce_file(path: str, mtime_ns: int) -> Optional[Dict]:
    """The file's reduction, parsed once for the readers of one run (the
    modification time in the key: a rewritten trace is parsed anew)."""
    return reduce(json.loads(Path(path).read_text())["traceEvents"])


def latest() -> Optional[Tuple[str, Dict]]:
    """(cell, reduction) of the newest trace written since this process
    started, parsed once; None where there is none or it holds no device
    events."""
    since = harness.process_start()
    found = [(p.stat().st_mtime, p) for p in TRACES.glob("*.trace.json")
             if p.stat().st_mtime >= since]
    if not found:
        return None
    _, path = max(found)
    r = _reduce_file(str(path), path.stat().st_mtime_ns)
    return None if r is None else (path.name[:-len(".trace.json")], r)


def per_step(ctx: Dict, key: str, root: str, phases: Sequence[str]
             ) -> Optional[float]:
    """The sum of the reduction's `key` over `phases`, a traced step; None
    where the trace holds no `root` span."""
    found = latest()
    if found is None or root not in found[1]["spans"]:
        return None
    r = found[1]
    return sum(r[key].get(p, 0) for p in phases) / ctx["trace"]["steps"]


def idle_ms(ctx: Dict, root: str, phases: Sequence[str]) -> Optional[float]:
    v = per_step(ctx, "idle_s", root, phases)
    return None if v is None else v * 1e3


def io_mb_per_image(ctx: Dict) -> Optional[float]:
    """MB (1e6 bytes) copied under `msa.predict.h2d` and `.d2h` a served
    frame (the mix's `batch` frames a step)."""
    v = per_step(ctx, "bytes", "msa.predict",
                 ("msa.predict.h2d", "msa.predict.d2h"))
    if v is None:
        return None
    batch = harness.load_cell(latest()[0])["mix"]["batch"]
    return v / batch / 1e6


def main(argv=None) -> int:
    """The reduction of each trace named, beside device_summary's busy
    time, gaps and launches of the same trace."""
    for path in (argv if argv is not None else sys.argv[1:]):
        events = json.loads(Path(path).read_text())["traceEvents"]
        r = reduce(events)
        s = yardstick.device_summary(events)
        dev = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
               for e in events if e.get("ph") == "X"
               and e.get("cat") in yardstick.DEVICE_CATEGORIES]
        extent = (max(b for _, b in dev) - min(a for a, _ in dev)) / 1e6
        print(json.dumps(dict(trace=str(path), **r,
                              summary=dict(launches=s["launches"],
                                           gap_s=extent - s["busy_s"]))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
