"""The frozen metric arithmetic on hand-made Chrome-trace events and at
the flagship shapes, and the run's refusal without a card."""
from __future__ import annotations

import json

import pytest

from port_bench import yardstick as y


def ev(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_union_of_intervals():
    assert y.busy_intervals([(5, 7), (0, 2), (1, 3), (6, 6.5), (10, 11)]) \
        == [(0, 3), (5, 7), (10, 11)]
    assert y.busy_intervals([]) == []


@pytest.mark.parametrize("name,fam", [
    ("void msa::rel_pos_attention_wgmma_kernel<64>(...)", "attention"),
    ("rel_pos_attention_f32_kernel", "attention"),
    ("void msa::convnext_block_fc_kernel<__nv_bfloat16, 0, 128>", "convnext"),
    ("convnext_block_prologue_kernel", "convnext"),
    ("msda_gather_kernel<bf16, 3, 4, 8>", "msda"),
    ("pixel_shuffle_wgmma_kernel<0, 1>", "f1_assembly"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_bias_TNT", "gemm_cublas"),
    ("void implicit_convolve_sgemm<__nv_bfloat16>", "conv_cudnn"),
    ("Memcpy HtoD (Pageable -> Device)", "copies"),
    ("upsample_bilinear2d_out_frame", "resize"),
    ("something_else", "other"),
])
def test_family_matching(name, fam):
    assert y.family(name) == fam


def test_summary_busy_launches_and_gaps():
    events = [
        ev("convnext_block_fc_kernel", 0, 10),
        ev("nvjet_gemm", 5, 10),                     # overlaps: busy 0-15
        ev("Memcpy DtoH", 30, 5, cat="gpu_memcpy"),   # not a launch
        ev("rel_pos_attention_wgmma_kernel", 40, 20),
        ev("aten::addmm", 14, 20, cat="cpu_op"),     # host during 15-30
        ev("aten::copy_", 34.5, 2, cat="cpu_op"),    # host at 35
        ev("a python frame", 0, 100, cat="python_function"),
    ]
    s = y.device_summary(events)
    assert s["busy_s"] == pytest.approx(40e-6)
    assert s["launches"] == 3
    assert s["family_s"]["convnext"] == pytest.approx(10e-6)
    assert s["family_s"]["attention"] == pytest.approx(20e-6)
    assert dict(s["idle_gaps"]) == pytest.approx(
        {"aten::addmm": 15e-6, "aten::copy_": 5e-6})
    assert s["device_ops"][0][0] == "rel_pos_attention_wgmma_kernel"


def test_summary_without_device_events_fails():
    with pytest.raises(RuntimeError):
        y.device_summary([ev("aten::mm", 0, 1, cat="cpu_op")])


def test_flagship_bounds_equal_the_kernel_table():
    """PERF.md's bf16 bounds at the flagship shapes (1024^2, B = 1)."""
    k1 = y.bound_ms(y.attention_work(25, 196, 1024, 16, (14, 14), (27, 27),
                                     2))
    k2 = y.bound_ms(y.attention_work(1, 4096, 1024, 16, (64, 64),
                                     (127, 127), 2))
    k5 = sum(y.bound_ms(y.convnext_work(1, 1024 // s, 1024 // s, c, 2))
             for s, c in zip((4, 8, 16, 32), (96, 192, 384, 768)))
    k6 = y.bound_ms(y.pixel_shuffle_work(1, 128, 128, 1024, 1024, 2))
    assert [round(v, 4) for v in (k1, k2, k5, k6)] == [
        0.0120, 0.0706, 0.0425, 0.1390]


def test_step_bounds_count_every_call():
    cfg = json.loads((y.__file__ and __import__("pathlib").Path(
        y.__file__).parent / "configs" / "deliver_rgblidar.json").read_text())
    one = y.family_bounds_ms(cfg["model"], 1, (1024, 1024))
    k1 = y.bound_ms(y.attention_work(25, 196, 1024, 16, (14, 14), (27, 27),
                                     2))
    k2 = y.bound_ms(y.attention_work(1, 4096, 1024, 16, (64, 64),
                                     (127, 127), 2))
    assert one["attention"] == pytest.approx(20 * k1 + 4 * k2)
    stage = [y.bound_ms(y.convnext_work(1, 1024 // s, 1024 // s, c, 2))
             for s, c in zip((4, 8, 16, 32), (96, 192, 384, 768))]
    assert one["convnext"] == pytest.approx(
        2 * sum(d * b for d, b in zip((3, 3, 27, 3), stage)))
    two = y.family_bounds_ms(cfg["model"], 1, (1024, 1024), forwards=2)
    assert two["convnext"] == pytest.approx(2 * one["convnext"])


def test_per_layer_arithmetic():
    trace = dict(busy_s=0.2, steps=5, launches=8905,
                 family_s={"convnext": 0.025, "attention": 0.0})
    ctx = dict(steps=150, window_s=10.0, flops_per_step=4.75e12,
               trace=trace, bounds_ms={"convnext": 0.72, "attention": 0.52})
    assert y.mfu_percent(ctx) == pytest.approx(
        4.75e12 * 15 / 989e12 * 100)
    assert y.idle_percent(ctx) == pytest.approx((1 - 0.04 / (10 / 150))
                                                * 100)
    assert y.launches_per_step(ctx) == 1781
    assert y.roofline_percent(ctx, "convnext") == pytest.approx(
        0.72e-3 * 5 / 0.025 * 100)
    assert y.roofline_percent(ctx, "attention") is None


def test_percentile_nearest_rank():
    vals = list(range(1, 101))
    assert y.percentile(vals, 95) == 95
    assert y.percentile([3.0], 95) == 3.0
    assert y.percentile([], 95) is None


def test_run_without_a_card_prints_no_result(monkeypatch, capsys):
    import os

    import torch

    from port_bench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cores, threads = os.sched_getaffinity(0), torch.get_num_threads()
    try:
        assert run.main(["--workload", "deliver_serve", "--seed", "1",
                         "--seconds", "1", "--trace", "0"]) == 2
    finally:
        os.sched_setaffinity(0, cores)
        torch.set_num_threads(threads)
    out = capsys.readouterr()
    assert out.out == ""
    assert "CUDA" in out.err
