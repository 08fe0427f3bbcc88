"""Smoke run of the PyTorch port on one NVIDIA card (Hopper, sm_90a).

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero before the last line:

1. device: the card's name and count, and `nvidia-smi`'s name and power
   limit. No CUDA card: exit 2 at once.
2. build: compile multimodal_sam_adapter_torch/csrc/*.cu with nvcc.
3. kernels: K1-K4 at the flagship shapes, each against its plain PyTorch
   version in float32 and bfloat16 (tolerances in kernel_checks.py),
   with CUDA-event times of kernel and plain.
4. forward: the full-width deliver_rgblidar EncoderDecoder (weights drawn
   from a seeded generator) on one 1024x1024x6 input in float32, kernel
   path against plain path, and the launch counts of that one forward.
5. serve: the model in bfloat16 answers 3 requests through
   InferenceEngine.predict ('whole_dim'); the launch counts of those
   requests, ms per image of the kernel and the plain path, peak memory.

Then one JSON line with the per-kernel results, and as the last line
{"ok": true, "device": {...}}.
"""
import json
import os
import subprocess
import sys
import time

SEED = 0
# launches of one flagship forward: 20 windowed / 4 global ViT blocks,
# 4 injectors (3-level MSDA), 4 + 2 extractors (1-level MSDA)
PER_FORWARD = {"window_attention": 20, "flash_attention": 4,
               "msda_multi_level": 4, "msda_single_level": 6}
REQUESTS = 3
# phase 4: float32 logits of the kernel path against the plain path; the two
# differ in summation order only, amplified through 24 blocks. A kernel with
# the rel_w term dropped (K1, K2), or with out-of-grid corners clamped or
# samples shifted half a pixel (K3, K4), moves the logits 18x to 230x past
# this limit (PERF.md, section 6)
FORWARD_RTOL_OF_MAX = 1e-3


class PhaseError(RuntimeError):
    pass


def line(phase, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def phase_device(torch):
    if not torch.cuda.is_available():
        print("no CUDA device: the port's kernels need an NVIDIA card",
              file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    line("device", name=repr(kind), count=torch.cuda.device_count())
    print(smi.splitlines()[0], flush=True)
    return kind


def phase_build(kernels):
    t0 = time.perf_counter()
    lib = kernels.build()
    kernels.library()
    line("build", seconds=f"{time.perf_counter() - t0:.1f}",
         nvcc_seconds=kernels.build_seconds(), lib=lib.name)


def phase_kernels(torch, kc):
    rows = []
    for name, meta in kc.KERNELS.items():
        row = dict(name=name, route="cuda", source=meta["source"],
                   replaces=meta["replaces"])
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            g = torch.Generator(device="cuda").manual_seed(SEED)
            fn, args = kc.flagship_case(name, dtype, g)
            got = fn(*args)
            want = kc.plain_reference(fn, args)
            torch.cuda.synchronize()
            check(torch.isfinite(got).all().item(), f"{name} {tag}: non-finite")
            tol = kc.TOLERANCES[dtype]
            diff = (got.float() - want.float()).abs()
            bound = tol["atol"] + tol["rtol"] * want.float().abs()
            abs_err = diff.max().item()
            rel_err = abs_err / want.float().abs().max().item()
            # plain, kernel, kernel, plain: the two versions in turns
            with kc.kernels.plain_kernels():
                p1 = kc.time_ms(fn, args)
            k1 = kc.time_ms(fn, args)
            k2 = kc.time_ms(fn, args)
            with kc.kernels.plain_kernels():
                p2 = kc.time_ms(fn, args)
            ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
            line("kernels", name=name, dtype=tag, max_abs_err=f"{abs_err:.3e}",
                 err_over_max=f"{rel_err:.3e}", atol=tol["atol"],
                 rtol=tol["rtol"], ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}")
            check(bool((diff <= bound).all()),
                  f"{name} {tag}: kernel and plain disagree beyond {tol}")
            row[tag] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms)
            del got, want, args
        rows.append(row)
    return rows


def phase_forward(torch, kernels, model, x):
    kernels.reset_launches()
    with torch.no_grad():
        got = model(x)
        torch.cuda.synchronize()
        counts = dict(kernels.LAUNCHES)
        with kernels.plain_kernels():
            want = model(x)
    check(got.shape == (1, 1024, 1024, 25), f"logits shape {got.shape}")
    check(torch.isfinite(got).all().item(), "non-finite float32 logits")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    line("forward", dtype="f32", logits_max_abs=f"{scale:.4e}",
         max_abs_err=f"{err:.3e}", tol=f"{FORWARD_RTOL_OF_MAX}*max|logits|",
         launches=json.dumps(counts).replace(" ", ""))
    check(err <= FORWARD_RTOL_OF_MAX * scale,
          "kernel path and plain path logits disagree")
    check(counts == PER_FORWARD, f"launch counts {counts} != {PER_FORWARD}")


def phase_serve(torch, kernels, engine, imgs):
    def serve(plain):
        times, preds = [], []
        for img in imgs:
            t0 = time.perf_counter()
            if plain:
                with kernels.plain_kernels():
                    preds.append(engine.predict(img))
            else:
                preds.append(engine.predict(img))
            times.append((time.perf_counter() - t0) * 1e3)
        return times, preds

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    k_times, preds = serve(plain=False)      # the main path
    counts = dict(kernels.LAUNCHES)
    peak_kernel = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    p_times, p_preds = serve(plain=True)
    peak_plain = torch.cuda.max_memory_allocated()
    k_times2, _ = serve(plain=False)
    p_times2, _ = serve(plain=True)
    for p in preds:
        check(tuple(p.shape) == (1, 1024, 1024), f"class map {p.shape}")
    logits = engine.logits(imgs[0])
    check(torch.isfinite(logits).all().item(), "non-finite bf16 logits")
    agree = sum((a == b).float().mean().item()
                for a, b in zip(preds, p_preds)) / len(preds)
    expect = {k: REQUESTS * v for k, v in PER_FORWARD.items()}
    # steady state: the requests after the first of each path
    ms = sorted(k_times[1:] + k_times2)
    pms = sorted(p_times[1:] + p_times2)
    line("serve", dtype="bf16", requests=REQUESTS,
         kernel_ms_per_img=f"{sum(ms) / len(ms):.2f}",
         plain_ms_per_img=f"{sum(pms) / len(pms):.2f}",
         first_request_ms=f"{k_times[0]:.1f}",
         peak_mem_gib_kernel=f"{peak_kernel / 2**30:.3f}",
         peak_mem_gib_plain=f"{peak_plain / 2**30:.3f}",
         class_agreement_with_plain=f"{agree:.4f}",
         launches=json.dumps(counts).replace(" ", ""))
    check(counts == expect, f"launch counts {counts} != {expect}")
    return counts


def main():
    import torch

    kind = phase_device(torch)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import kernel_checks as kc
    from multimodal_sam_adapter_torch.engine.inference import InferenceEngine
    from multimodal_sam_adapter_torch.models.segmentor import build_segmentor
    from multimodal_sam_adapter_torch.ops import kernels
    from multimodal_sam_adapter_tpu.configs.registry import get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build(kernels)
    rows = phase_kernels(torch, kc)

    cfg = get_config("deliver_rgblidar")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    model = build_segmentor(cfg["model"], "cuda", generator=g)
    imgs = [torch.randn((1, 1024, 1024, 6), generator=g, device="cuda")
            for _ in range(REQUESTS)]
    phase_forward(torch, kernels, model, imgs[0])

    model = model.to(torch.bfloat16)
    engine = InferenceEngine(model, cfg["test_cfg"])
    counts = phase_serve(torch, kernels, engine,
                         [x.to(torch.bfloat16) for x in imgs])

    out = []
    for row in rows:
        f32, bf = row.pop("f32"), row.pop("bf16")
        out.append(dict(row, launches=counts[row["name"]],
                        max_abs_err=bf["max_abs_err"], ms=bf["ms"],
                        plain_ms=bf["plain_ms"], dtype="bfloat16", f32=f32))
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except PhaseError as e:
        print(f"FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
