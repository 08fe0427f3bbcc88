"""On the card, at each cell's own sizes: the control (the reference
computed on float8 e4m3 operands in the program's place) fails the cell's
limits, and the program on the same seed passes them. Run on the card:

    python -m pytest -q -p no:cacheprovider -m gpu port_bench/tests/test_bench_control.py
"""
from __future__ import annotations

import json

import pytest

from port_bench.harness import REPO

CELLS = [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_where_the_program_passes(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from port_bench import harness

    out = harness.run(workload, 2 ** 31 + 101, 3.0, False, "cuda",
                      control=True)
    assert out["result"]["correct"], out["readings"]
    assert not out["log"]["control_correct"], out["readings"]
