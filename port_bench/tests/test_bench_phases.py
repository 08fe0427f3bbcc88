"""The reduction of a trace by the program's phases on hand-made
Chrome-trace events: gaps split at span boundaries, the phases summing to
device_summary's gaps, kernels and copies attributed through their launch
calls, and nothing to read giving None."""
from __future__ import annotations

import json
import os
import time

import pytest

from port_bench import phases, yardstick as y


def ev(name, ts, dur, cat="kernel", **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if args:
        e["args"] = args
    return e


def span(name, ts, dur):
    return ev(name, ts, dur, cat="user_annotation")


# device busy 0-10, 20-30, 50-60 (us); gaps 10-20 and 30-50
EVENTS = [
    span("msa.predict", 0, 100),
    span("msa.predict.h2d", 2, 13),             # 2-15
    span("msa.predict.forward", 15, 25),        # 15-40
    span("msa.predict.d2h", 45, 10),            # 45-55
    span("Optimizer.step#X.step", 30, 5),       # not the program's
    ev("cudaMemcpyAsync", 3, 1, cat="cuda_runtime", correlation=1),
    ev("Memcpy HtoD (Pageable -> Device)", 0, 10, cat="gpu_memcpy",
       correlation=1, bytes=1000),
    ev("cudaLaunchKernel", 16, 1, cat="cuda_runtime", correlation=2),
    ev("gemm", 20, 5, correlation=2),
    ev("cuLaunchKernel", 18, 1, cat="cuda_driver", correlation=3),
    ev("nvjet", 25, 5, correlation=3),
    ev("cudaMemcpyAsync", 46, 1, cat="cuda_runtime", correlation=4),
    ev("Memcpy DtoH (Device -> Pageable)", 50, 10, cat="gpu_memcpy",
       correlation=4, bytes=500),
    ev("orphan_kernel", 22, 1, correlation=99),  # no launch call seen
    ev("aten::copy_", 2, 13, cat="cpu_op"),
]


def test_a_gap_is_split_at_span_boundaries():
    r = phases.reduce(EVENTS)
    # 10-15 under h2d, 15-20 under forward; 30-40 forward, 40-45 the
    # root's own time, 45-50 d2h
    assert r["idle_s"] == pytest.approx({
        "msa.predict.h2d": 5e-6, "msa.predict.forward": 15e-6,
        "msa.predict": 5e-6, "msa.predict.d2h": 5e-6})
    assert r["spans"] == {"msa.predict": 1, "msa.predict.h2d": 1,
                          "msa.predict.forward": 1, "msa.predict.d2h": 1}


def test_phases_sum_to_the_gaps_between_device_intervals():
    events = EVENTS + [span("msa.predict", 200, 10),
                       ev("late_kernel", 300, 4, correlation=5)]
    r = phases.reduce(events)
    s = y.device_summary(events)
    assert sum(r["idle_s"].values()) == pytest.approx(r["gap_s"])
    assert r["gap_s"] == pytest.approx(sum(v for _, v in s["idle_gaps"]))
    assert r["gap_s"] == pytest.approx((304 - 0) * 1e-6 - s["busy_s"])
    # 100-200 and 210-300 lie under no span; 40-45, 60-100 and 200-210
    # under a root alone
    assert r["idle_s"][phases.OUTSIDE] == pytest.approx(190e-6)
    assert r["idle_s"]["msa.predict"] == pytest.approx(55e-6)


def test_kernels_follow_their_runtime_or_driver_launch():
    r = phases.reduce(EVENTS)
    assert r["kernels"] == {"msa.predict.forward": 2, phases.OUTSIDE: 1}
    assert sum(r["kernels"].values()) == r["launches"] \
        == y.device_summary(EVENTS)["launches"] == 3


def test_copied_bytes_follow_their_launch():
    r = phases.reduce(EVENTS)
    assert r["bytes"] == {"msa.predict.h2d": 1000, "msa.predict.d2h": 500}


def test_innermost_is_the_span_started_last():
    times, names = phases.phase_map([(0, 10, "a"), (0, 4, "b"),
                                     (2, 3, "c"), (6, 8, "d")])
    got = [phases.phase_at(times, names, t) for t in
           (-1, 1, 2.5, 3.5, 5, 7, 9, 10, 11)]
    assert got == ["outside", "b", "c", "b", "a", "d", "a", "outside",
                   "outside"]


def test_nothing_to_read_gives_none(tmp_path, monkeypatch):
    assert phases.reduce([span("msa.predict", 0, 5),
                          ev("aten::mm", 0, 1, cat="cpu_op")]) is None
    monkeypatch.setattr(phases, "TRACES", tmp_path)
    ctx = dict(trace=dict(steps=1))
    assert phases.latest() is None
    assert phases.idle_ms(ctx, "msa.predict", ("msa.predict",)) is None
    # a trace older than the process is not this run's
    old = tmp_path / "deliver_serve.trace.json"
    old.write_text(json.dumps({"traceEvents": EVENTS}))
    os.utime(old, (time.time() - 1e6, time.time() - 1e6))
    assert phases.latest() is None
    # this run's trace of a program without the spans
    new = tmp_path / "deliver_train.trace.json"
    new.write_text(json.dumps({"traceEvents": [ev("k", 0, 1),
                                               ev("k", 5, 1)]}))
    assert phases.latest()[0] == "deliver_train"
    assert phases.idle_ms(ctx, "msa.train_step",
                          ("msa.train_step.update",)) is None


def test_readers_on_this_runs_trace(tmp_path, monkeypatch):
    from port_bench.harness import load_reader

    monkeypatch.setattr(phases, "TRACES", tmp_path)
    (tmp_path / "deliver_eval_b4.trace.json").write_text(
        json.dumps({"traceEvents": EVENTS}))
    ctx = dict(trace=dict(steps=1))
    assert load_reader("idle_forward_ms.infer")(ctx) == pytest.approx(0.015)
    assert load_reader("idle_engine_ms.infer")(ctx) == pytest.approx(0.015)
    # 1500 bytes a step of 4 frames (predict_b4)
    assert load_reader("io_mb.infer")(ctx) == pytest.approx(1500 / 4 / 1e6)
    assert load_reader("launches_update.train")(ctx) is None
