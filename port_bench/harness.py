"""One run of one cell: set-up, the measured window, the traced
sub-window, the check of what the window produced, the result line.

A cell (an entry of BENCHMARK.json's `workloads`) names a configuration
file and a traffic mix; everything else is read from them:

- the configuration (port_bench/configs/<name>.json): the model as the
  program's `build_segmentor` takes it, the test mode, the input
  geometry, the served dtype, the optimizer and its accumulation, and the
  stored operation counts;
- the traffic mix (port_bench/traffic/<name>.json, see traffic.py);
- the limits of the numbers compared (port_bench/limits/<cell>.json);
- each per-layer metric's reader (port_bench/metrics/<metric>.py);
- the kind of traffic that the mix names (port_bench/kinds/<kind>.py),
  which builds the program, drives it and judges what it produced.

The program is `multimodal_sam_adapter_torch`, driven through
`InferenceEngine.predict` (kind "predict") or `make_train_step` (kind
"train"). The reference is port_bench/reference, which imports nothing of
it. A new kind, configuration, mix or metric is a new file.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import os
import statistics
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

from . import traffic, yardstick
from .reference import model as ref_model

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "multimodal_sam_adapter_tpu")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
WARM_UP_REQUESTS = 2      # the first builds cuDNN's plans and the caches
CHECKED_UPDATES = 3       # a train cell's cycles that the reference follows


class Failed(RuntimeError):
    """The run cannot report a result."""


# ------------------------------------------------------------------ inputs

def load_cell(name: str, bench: Optional[dict] = None) -> Dict:
    """The cell's entry, its configuration, its mix and its limits."""
    bench = bench or json.loads((REPO / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Failed(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((REPO / entry["file"]).read_text())
    return dict(cell=cell, config=config,
                mix=traffic.load_mix(ROOT, cell["traffic"]),
                limits=json.loads((ROOT / "limits" / f"{name}.json")
                                  .read_text()),
                bench=bench)


def geometry(config: dict) -> dict:
    return dict(frame_hw=tuple(config["frame_hw"]),
                channels=sum(config["model"]["backbone"]["modalities_ch"]))


def kind_of(mix: dict):
    """The module of the mix's kind, port_bench/kinds/<kind>.py: its `Cell`
    is built as Cell(config, mix, seed, device) and offers warm_up(),
    sampler(), window(seconds, sample), steps(n), e2e(window), release()
    and judge(sample, control), with FLOPS_KEY, FORWARDS and
    net_inputs(config, mix)."""
    return importlib.import_module(f"{__package__}.kinds.{mix['kind']}")


def flops_per_step(config: dict, mix: dict) -> float:
    cell = kind_of(mix).Cell
    images, hw = cell.net_inputs(config, mix)
    return images * config["flops"][cell.FLOPS_KEY][f"{hw[0]}x{hw[1]}"]


def process_start() -> float:
    """This process's start, seconds since the epoch (Linux /proc)."""
    fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
    ticks = int(fields[19])
    btime = next(int(line.split()[1]) for line in
                 Path("/proc/stat").read_text().splitlines()
                 if line.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def reference_precision(fp8: bool = False):
    """float32 products without TF32 (or float8 e4m3 operands) for the
    block; the previous settings are put back after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, ref_model.Products.fp8)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref_model.Products.fp8 = fp8
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, ref_model.Products.fp8) = saved


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


# --------------------------------------------------------------- tracing

def trace_window(cell, steps: int, device, trace_path: Path) -> Dict:
    """`steps` whole steps under torch.profiler (host and device), the
    trace written to `trace_path` and reduced."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    # the profiler's first session starts its device tracing (seconds):
    # one step under a session of its own keeps that out of the window
    with torch.profiler.profile(activities=acts):
        cell.steps(1)
        sync(device)
    with torch.profiler.profile(activities=acts) as prof:
        sync(device)
        t0 = time.perf_counter()
        cell.steps(steps)
        sync(device)
        window = time.perf_counter() - t0
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_path))
    events = json.loads(trace_path.read_text())["traceEvents"]
    out = yardstick.device_summary(events)
    out.update(window_s=window, steps=steps)
    return out


def load_reader(name: str) -> Callable[[Dict], Optional[float]]:
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"port_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reports(metric: dict, cell_name: str) -> bool:
    return cell_name in metric.get("workloads", [cell_name])


# ------------------------------------------------------------------- a run

def run(name: str, seed: int, seconds: float, trace: bool, device="cuda",
        loaded: Optional[Dict] = None, control: bool = False) -> Dict:
    """One run of cell `name`: the result line's object, under `log` what
    is printed on the lines before it, and under `readings` every number
    the check read. With `control`, the control is judged beside the
    program by the same limits (`control_correct`)."""
    t_proc = process_start()
    loaded = loaded or load_cell(name)
    cell, config, mix, limits, bench = (loaded[k] for k in (
        "cell", "config", "mix", "limits", "bench"))
    kind = kind_of(mix).Cell
    prog = kind(config, mix, seed, device)
    prog.warm_up()
    sample = prog.sampler()
    setup_s = time.time() - t_proc
    w = prog.window(seconds, sample)
    e2e = dict(prog.e2e(w), setup_s=setup_s)
    reported = [m for m in bench["end_to_end"] if reports(m, name)]
    metrics: Dict[str, Dict] = {}
    dev = device_info(device, cell["chips"])
    breakdown = None
    if trace:
        t = trace_window(prog, mix["profile_steps"], device,
                         REPO / "build" / "port_bench" / f"{name}.trace.json")
        images, hw = kind.net_inputs(config, mix)
        ctx = dict(kind=mix["kind"], steps=w["steps"], window_s=w["elapsed"],
                   flops_per_step=flops_per_step(config, mix), trace=t,
                   bounds_ms=yardstick.family_bounds_ms(
                       config["model"], images, hw, forwards=kind.FORWARDS))
        for m in bench["per_layer"]:
            if reports(m, name):
                value = load_reader(m["name"])(ctx)
                if value is not None:
                    metrics[m["name"]] = dict(value=value, unit=m["unit"])
        dev.update(busy_s=t["busy_s"], window_s=t["window_s"])
        breakdown = dict(device_ops=t["device_ops"],
                         idle_gaps=t["idle_gaps"])
    else:
        for m in reported:
            metrics[m["name"]] = dict(value=e2e[m["name"]], unit=m["unit"])
    if torch.device(device).type == "cuda":
        dev["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    attempted, failed = w["steps"] + prog.failed, prog.failed
    prog.release()
    free(device)
    readings = prog.judge(sample, control)
    loaded_jax = sorted({k.split(".")[0] for k in sys.modules}
                        & set(FORBIDDEN))
    if loaded_jax:
        raise Failed(f"the process holds {', '.join(loaded_jax)}")

    def checks(side):
        # the limits file names the numbers compared
        return {k: dict(value=readings[side][k], limit=v)
                for k, v in limits.items()}

    def passes(cs):
        return all(c["value"] <= c["limit"] for c in cs.values())

    out = dict(correct=failed == 0 and passes(checks("program")),
               attempted=attempted, failed=failed, metrics=metrics,
               device=dev)
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks("program")
    log = dict(steps=w["steps"], window_s=w["elapsed"],
               memory_peak_gib=dev["memory_peak_bytes"] / 2 ** 30, **e2e)
    if "latencies" in w:
        log["median_ms"] = 1e3 * statistics.median(w["latencies"])
    if control:
        log["control_correct"] = passes(checks("control"))
    return dict(result=out, log=log, readings=readings)


def device_info(device, chips: int) -> Dict:
    if torch.device(device).type != "cuda":
        return dict(platform="cpu", kind="cpu", count=1,
                    memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                count=chips, memory_peak_bytes=0)
