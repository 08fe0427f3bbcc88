"""The readings that the limits of a cell's check are set from, on the
card, at the cell's own sizes: runs of the cell (harness.run, a short
window at the cell's load) on each seed, judged by the cell's limits, and
on the first `--control-seeds` seeds the control judged beside the
program by the same limits: the reference computed on float8 e4m3
operands in the program's place.

    python3 port_bench/control.py --workload <name> --seeds 1 2 3 ... \\
        [--seconds 4] [--control-seeds 3]

One JSON line a seed: every number the check read, for each side, and
whether each side passed.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    from port_bench import harness

    if not torch.cuda.is_available():
        print("the readings need a CUDA card", file=sys.stderr)
        return 2
    loaded = harness.load_cell(args.workload)
    for i, seed in enumerate(args.seeds):
        out = harness.run(args.workload, seed, args.seconds, False, "cuda",
                          loaded, control=i < args.control_seeds)
        print(json.dumps(dict(
            seed=seed, correct=out["result"]["correct"],
            control_correct=out["log"].get("control_correct"),
            **out["readings"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
