"""Run one cell of the port's benchmark once, on the card of this machine:

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cells, configurations, traffic mixes and
metrics are in BENCHMARK.json and under port_bench/ (see harness.py). The
last line of standard output is the result, one JSON object; the numbers
compared with the reference, each beside its limit, are the last lines of
standard error. Without a CUDA card, or with fewer cards than the cell
asks for, it prints no result and exits with 2.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def card_limits() -> str:
    """The cards' names and power limits, as nvidia-smi reads them."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi: {exc}"
    return res.stdout.strip().replace("\n", "; ")


HOST_CORES = 4


def pin_host() -> list:
    """Run on the last HOST_CORES cores this process may use, with as many
    torch threads (set once torch is imported): a fixed place for the
    host's dispatch, and threads enough for the host's own tensor work
    (on an 8-core H100 machine a slide request's median read 196-206 ms on
    one core and thread, 154-181 ms on four)."""
    cores = sorted(os.sched_getaffinity(0))[-HOST_CORES:]
    os.sched_setaffinity(0, set(cores))
    return cores


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cores = pin_host()

    import torch

    from port_bench import harness

    torch.set_num_threads(len(cores))

    loaded = harness.load_cell(args.workload)
    chips = loaded["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        out = harness.run(args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda", loaded)
    except harness.Failed as exc:
        print(f"no result: {exc}", file=sys.stderr)
        return 1
    log = dict(workload=args.workload, seed=args.seed, card=card_limits(),
               cores=cores, **out["log"])
    print(json.dumps(log), flush=True)
    checks = out["result"]["checks"]
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
