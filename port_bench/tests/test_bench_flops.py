"""Each configuration file's stored operation counts equal a fresh count
on the reference, on `meta`."""
from __future__ import annotations

import json

import pytest

from port_bench import yardstick
from port_bench.harness import ROOT

CONFIGS = sorted((ROOT / "configs").glob("*.json"))


@pytest.mark.parametrize("path", CONFIGS, ids=[p.stem for p in CONFIGS])
def test_stored_counts_are_fresh(path):
    cfg = json.loads(path.read_text())
    for kind, by_hw in cfg["flops"].items():
        for hw, stored in by_hw.items():
            h, w = (int(v) for v in hw.split("x"))
            assert stored == yardstick.count_flops(
                cfg["model"], 1, (h, w), kind == "train"), (kind, hw)
