"""The port's profiler summary (multimodal_sam_adapter_torch/utils/
profiling.py) on a synthetic Chrome trace: device busy time is the union of
the device intervals, the window runs from the first device event to the
last, and host-side events are ignored."""
import pytest

from multimodal_sam_adapter_torch.utils.profiling import (device_summary,
                                                          family)


def _ev(cat, ts, dur, name="k"):
    return dict(ph="X", cat=cat, ts=ts, dur=dur, name=name)


def test_busy_time_is_the_union_of_device_intervals():
    events = [
        _ev("kernel", 0, 10, "void msa::rel_pos_attention_mma_kernel<64>"),
        _ev("kernel", 5, 10, "nvjet_tst_256x128_64x4_1x2_h_bz_coopA"),
        _ev("gpu_memcpy", 30, 10, "Memcpy DtoH (Device -> Pageable)"),
        _ev("cpu_op", 0, 100, "aten::add"),
        _ev("cuda_runtime", 0, 50, "cudaLaunchKernel"),
        dict(ph="i", cat="kernel", ts=60, name="marker"),
    ]
    s = device_summary(events, calls=2)
    # union [0, 15] + [30, 40] = 25 us over a 40 us window, per 2 calls
    assert s["busy_ms"] == pytest.approx(25e-3 / 2)
    assert s["profiled_ms"] == pytest.approx(40e-3 / 2)
    assert s["profiled_idle_share"] == pytest.approx(1 - 25 / 40)
    assert s["kernel_launches"] == 1.0
    assert s["family_ms"] == pytest.approx({
        "K1/K2 attention": 5e-3, "GEMM (cuBLAS)": 5e-3, "copies": 5e-3})


@pytest.mark.parametrize("name, fam", [
    ("void msa::msda_kernel<__nv_bfloat16>(...)", "K3/K4 msda"),
    ("void msa::msda_gather_kernel<__nv_bfloat16, 3, 4, 8>(...)",
     "K3/K4 msda"),
    ("void msa::convnext_block_mma_kernel<4, 4>(msa::CbArgs)",
     "K5 convnext block"),
    ("void msa::pixel_shuffle_mma_kernel(msa::PsArgs)", "K6 f1 assembly"),
    ("void implicit_convolve_sgemm<__nv_bfloat16, 1024>", "conv (cuDNN)"),
    ("void cutlass::Kernel2<cutlass_80_wmma_tensorop_bf16_gemm>", "GEMM (cuBLAS)"),
    ("void at::native::vectorized_layer_norm_kernel<c10::BFloat16>", "norms"),
    ("void at::native::upsample_bilinear2d_out_frame<float>", "resize"),
    ("void at::native::vectorized_elementwise_kernel<8, GeluCUDAKernelImpl>",
     "elementwise"),
    ("some_unknown_kernel", "other"),
])
def test_kernel_families(name, fam):
    assert family(name) == fam


def test_a_trace_without_device_events_is_refused():
    with pytest.raises(RuntimeError):
        device_summary([_ev("cpu_op", 0, 5)], calls=1)
