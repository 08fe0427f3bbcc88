"""Smoke run of the PyTorch port on one NVIDIA card (Hopper, sm_90a).

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero before the last line:

1. device: the card's name and count, and `nvidia-smi`'s name and power
   limit. No CUDA card: exit 2 at once.
2. build: compile multimodal_sam_adapter_torch/csrc/*.cu with nvcc.
3. kernels: K1-K6 at the flagship shapes (K5 at each of the four ConvNeXt
   stages; K1 and K2 also at FMB's 800^2 and slide's batch-3 shapes, K3
   and K4 at FMB's, batch 3, `whole` mode's non-square 1024x1824 and
   deliver_tiny's narrow widths, K5 at the ragged FMB and test widths and
   at batch 3), each against its plain PyTorch version in float32 and
   bfloat16 (tolerances in kernel_checks.py), with CUDA-event times of
   kernel and plain and the card's bound for the same work; for K1 and K2 the time of one SDPA call
   on the same inputs (bf16), the yardstick; for K5 its ms per forward
   (each stage's ms times its blocks). Each wrapper refuses a call that
   autograd would record (an input that requires grad), launching nothing.
4. forward: the full-width deliver_rgblidar EncoderDecoder (weights drawn
   from a seeded generator) on one 1024x1024x6 input in float32, kernel
   path against plain path, and the launch counts of that one forward.
5. serve: the model in bfloat16 answers 3 requests through
   InferenceEngine.predict ('whole_dim'); the launch counts of those
   requests, ms per image of the kernel and the plain path, peak memory.
6. eval: the bf16 model through the Evaluator over 4 in-memory DELIVER
   samples (labels with ignored pixels, two cases): mIoU on the kernel and
   the plain path, ms per image, launch counts, the condition x case report.
7. slide: muses_rgblidar (19 classes) in bf16 on one 1024x1820 input
   ('slide', 1024^2 crops at stride 640): one forward at batch 3, the class
   map against the plain path's.
8. cut: fmb_rgbtherm (800^2, 14 classes) in bf16 on one 800x800 input
   ('whole_dim_cut'): the (600, 800) class map against the plain path's,
   and K5 at the 25x25 stage.

Then one JSON line with the per-kernel results, and as the last line
{"ok": true, "device": {...}}.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 0
# launches of one flagship forward: 20 windowed / 4 global ViT blocks,
# 4 injectors (3-level MSDA), 4 + 2 extractors (1-level MSDA), 2 x 36
# ConvNeXt blocks of the twin trunk, the f1 assembly
PER_FORWARD = {"window_attention": 20, "flash_attention": 4,
               "msda_multi_level": 4, "msda_single_level": 6,
               "convnext_block": 72, "pixel_shuffle_up_bn": 1}
REQUESTS = 3
EVAL_SAMPLES = 4
# phase 4: float32 logits of the kernel path against the plain path; the two
# differ in summation order only, amplified through 24 blocks. A kernel with
# the rel_w term dropped (K1, K2), or with out-of-grid corners clamped or
# samples shifted half a pixel (K3, K4), moves the logits 18x to 230x past
# this limit (PERF.md, section 6)
FORWARD_RTOL_OF_MAX = 1e-3
# phases 5-8: bf16 class maps of the kernel path against the plain path
AGREE_MIN = 0.98

class PhaseError(RuntimeError):
    pass


def line(phase, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def compact(d):
    return json.dumps(d).replace(" ", "")


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


def check_case(torch, kc, name, label, case, dtype, tag):
    """One kernel on one case (wrapper, args) against its plain version,
    with the CUDA-event times of both and the card's bound for the work."""
    fn, args = case
    got = fn(*args)
    want = kc.plain_reference(fn, args)
    torch.cuda.synchronize()
    check(torch.isfinite(got).all().item(), f"{name} {label} {tag}: "
                                            "non-finite")
    tol = kc.TOLERANCES[dtype]
    diff = (got.float() - want.float()).abs()
    bound = tol["atol"] + tol["rtol"] * want.float().abs()
    abs_err = diff.max().item()
    rel_err = abs_err / want.float().abs().max().item()
    bound_ms, bound_by = kc.bound_ms(name, args, got)
    # plain, kernel, kernel, plain: the two versions in turns
    with kc.kernels.plain_kernels():
        p1 = kc.time_ms(fn, args)
    k1 = kc.time_ms(fn, args)
    k2 = kc.time_ms(fn, args)
    with kc.kernels.plain_kernels():
        p2 = kc.time_ms(fn, args)
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    line("kernels", name=name, shape=label, dtype=tag,
         max_abs_err=f"{abs_err:.3e}", err_over_max=f"{rel_err:.3e}",
         atol=tol["atol"], rtol=tol["rtol"], ms=f"{ms:.4f}",
         plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
         bound_by=bound_by)
    check(bool((diff <= bound).all()),
          f"{name} {label} {tag}: kernel and plain disagree beyond {tol}")
    return dict(shape=label, max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def check_guard(torch, kc, name):
    """The wrapper raises, and launches nothing, on a call that autograd
    would record: no kernel has a backward yet."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    fn, args = kc.flagship_case(name, torch.bfloat16, g,
                                kc.flagship_shapes(name)[0])
    args = list(args)
    i = next(i for i, a in enumerate(args) if torch.is_tensor(a))
    args[i] = args[i].detach().requires_grad_()
    before = dict(kc.kernels.LAUNCHES)
    try:
        fn(*args)
        raised = False
    except RuntimeError as e:
        raised = "no backward" in str(e)
    torch.cuda.synchronize()
    check(raised and kc.kernels.LAUNCHES == before,
          f"{name}: a grad-recording call did not raise before launching")
    line("kernels", name=name, grad_recording_call="refused")


def check_library(torch, kc, name, case):
    """The yardstick: the fastest SDPA backend on the same inputs as the
    kernel's flagship case (its operands built outside the timed calls),
    and how far its output lies from the plain version's."""
    fn, args = case
    ms, backend, out = kc.time_library(name, args)
    want = kc.plain_reference(fn, args)
    # SDPA returns (batch, heads, N, d): heads-pack it as the kernels do
    B, N, C = want.shape
    got = out.transpose(1, 2).reshape(B, N, C)
    err = (got.float() - want.float()).abs().max().item()
    line("kernels", name=name, library="scaled_dot_product_attention",
         backend=backend, library_ms=f"{ms:.4f}",
         library_max_abs_err=f"{err:.3e}")
    return dict(library_ms=ms, library_backend=backend,
                library_max_abs_err=err)


def phase_kernels(torch, kc):
    """One row per kernel; K5's row sums its four stage shapes (one block
    at each stage), keeps them under `shapes` and weighs them by the
    stage's blocks in `per_forward_ms`. K1, K2 and K5 are checked too at
    their off-path shapes (`ragged`, not summed); K1 and K2 are timed
    beside one SDPA call (bf16, flagship shapes)."""
    rows = []
    for name, meta in kc.KERNELS.items():
        row = dict(name=name, route="cuda", source=meta["source"],
                   replaces=meta["replaces"], library_ms=None,
                   library_backend=None)
        attention = name in ("window_attention", "flash_attention")
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            checked = [(on_path, check_case(torch, kc, name, label, case,
                                            dtype, tag))
                       for label, on_path, case in kc.cases(name, dtype,
                                                            SEED)]
            cases = [c for on_path, c in checked if on_path]
            ragged = [c for on_path, c in checked if not on_path]
            biggest = max(cases, key=lambda c: c["bound_ms"])
            row[tag] = dict(
                max_abs_err=max(c["max_abs_err"] for c in cases),
                ms=sum(c["ms"] for c in cases),
                plain_ms=sum(c["plain_ms"] for c in cases),
                bound_ms=sum(c["bound_ms"] for c in cases),
                bound_by=biggest["bound_by"],
                shapes=cases if len(cases) > 1 else None,
                ragged=ragged or None)
            if name == "convnext_block":
                for key in ("ms", "plain_ms"):
                    row[tag]["per_forward_" + key] = sum(
                        n * c[key] for n, c in zip(kc.CONVNEXT_STAGE_CALLS,
                                                   cases))
                line("kernels", name=name, dtype=tag, per_forward_ms=(
                    f"{row[tag]['per_forward_ms']:.4f}"),
                     plain_per_forward_ms=(
                         f"{row[tag]['per_forward_plain_ms']:.4f}"))
        check_guard(torch, kc, name)
        if attention:
            g = torch.Generator(device="cuda").manual_seed(SEED)
            row.update(check_library(
                torch, kc, name, kc.flagship_case(name, torch.bfloat16, g)))
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
         launches=compact(counts))
    check(err <= FORWARD_RTOL_OF_MAX * scale,
          "kernel path and plain path logits disagree")
    check(counts == PER_FORWARD, f"launch counts {counts} != {PER_FORWARD}")


def agreement(a, b):
    return (a == b).float().mean().item()


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
    agree = sum(agreement(a, b) for a, b in zip(preds, p_preds)) / len(preds)
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
         launches=compact(counts))
    check(counts == expect, f"launch counts {counts} != {expect}")
    check(agree >= AGREE_MIN, f"class maps agree on {agree:.4f} < "
                              f"{AGREE_MIN} of pixels")
    return counts


class DeliverSamples:
    """In-memory DELIVER-like samples: normalised (1024, 1024, 6) inputs,
    labels with ~5% ignored (255) pixels, conditions and cases in the meta
    (every other sample has no case: 'ordinary'), with the DELIVER class,
    condition and case tables of the port's `data/datasets.py`."""

    def __init__(self, n, seed):
        from multimodal_sam_adapter_torch.data.datasets import DELIVER

        self.CLASSES = DELIVER.CLASSES
        self.CONDITIONS = DELIVER.CONDITIONS
        self.CASES = DELIVER.CASES
        rng = np.random.default_rng(seed)
        cases = (None, "motionblur", None, "overexposure")
        self.samples = []
        for i in range(n):
            gt = rng.integers(0, len(self.CLASSES), (1024, 1024),
                              dtype=np.uint8)
            gt[rng.random((1024, 1024)) < 0.05] = 255
            self.samples.append(dict(
                img=rng.standard_normal((1024, 1024, 6), dtype=np.float32),
                gt=gt,
                meta=dict(condition=self.CONDITIONS[i % 2],
                          case=cases[i % len(cases)], stem=f"s{i}")))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def phase_eval(torch, kernels, engine, evaluator_cls):
    ds = DeliverSamples(EVAL_SAMPLES, SEED)
    ev = evaluator_cls(engine, ds, len(ds.CLASSES), case_aware=True)

    def run(plain):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if plain:
            with kernels.plain_kernels():
                res = ev.run(progress_every=0)
        else:
            res = ev.run(progress_every=0)
        return res, (time.perf_counter() - t0) * 1e3 / len(ds)

    kernels.reset_launches()
    res, ms = run(plain=False)               # the main path
    counts = dict(kernels.LAUNCHES)
    p_res, p_ms = run(plain=True)
    expect = {k: EVAL_SAMPLES * v for k, v in PER_FORWARD.items()}
    miou, p_miou = res["summary"]["mIoU"], p_res["summary"]["mIoU"]
    # flat histograms (4, K): intersect, union, pred, label areas
    labelled = float(res["payload"]["flat"][3].sum())
    correct = float(res["payload"]["flat"][0].sum())
    p_correct = float(p_res["payload"]["flat"][0].sum())
    report = res.get("nested_report", "")
    line("eval", dtype="bf16", samples=len(ds), mIoU=f"{miou:.4f}",
         plain_mIoU=f"{p_miou:.4f}", aAcc=f"{res['summary']['aAcc']:.4f}",
         plain_aAcc=f"{p_res['summary']['aAcc']:.4f}",
         kernel_ms_per_img=f"{ms:.2f}", plain_ms_per_img=f"{p_ms:.2f}",
         nested_cells=compact({
             cond: sorted(k for k in cases if k != "micro_IoU")
             for cond, cases in res["eval_results"].items()
             if cond != "global"}),
         launches=compact(counts))
    check(counts == expect, f"launch counts {counts} != {expect}")
    check(labelled == EVAL_SAMPLES * 1024 * 1024 - float(
        sum((s["gt"] == 255).sum() for s in ds.samples)),
        "the histograms do not count every labelled pixel")
    for v in (miou, p_miou):
        check(0.0 <= v <= 100.0, f"mIoU {v} out of range")
    # the correct-pixel counts of the two paths differ by at most the
    # pixels on which their class maps may disagree
    check(abs(correct - p_correct) <= (1 - AGREE_MIN) * labelled,
          f"correct pixels {correct} (kernel) vs {p_correct} (plain)")
    for case in ("motionblur", "overexposure", "ordinary"):
        check(f"_{case} results" in report,
              f"the condition x case report has no {case!r} table")


def _build_bf16(torch, build_segmentor, model_cfg, g):
    return build_segmentor(model_cfg, "cuda", generator=g).to(torch.bfloat16)


def predict_paths(kernels, predict):
    """The main path once (its launch counts), the plain path once, then
    each again for its warm time. Returns (class map, plain class map,
    launch counts, first ms, ms, plain ms)."""
    def timed(plain):
        t0 = time.perf_counter()
        if plain:
            with kernels.plain_kernels():
                out = predict()
        else:
            out = predict()
        return out, (time.perf_counter() - t0) * 1e3   # out is on the host

    kernels.reset_launches()
    pred, first_ms = timed(plain=False)       # the main path
    counts = dict(kernels.LAUNCHES)
    p_pred, _ = timed(plain=True)
    _, ms = timed(plain=False)
    _, p_ms = timed(plain=True)
    return pred, p_pred, counts, first_ms, ms, p_ms


def phase_slide(torch, kernels, engine, pad_for_model, rng):
    """MUSES's 1920x1080 frame after the test pipeline's keep-ratio resize
    to (2048, 1024) is 1024x1820; the evaluator pads it to 1824, which
    makes three 1024^2 crops at stride 640."""
    img, valid = pad_for_model(
        rng.standard_normal((1024, 1820, 6), dtype=np.float32))
    x = torch.from_numpy(img)[None]
    batches = []
    hook = engine.model.register_forward_pre_hook(
        lambda m, a: batches.append(tuple(a[0].shape)))
    try:
        pred, p_pred, counts, first_ms, ms, p_ms = predict_paths(
            kernels, lambda: engine.predict(x, valid_hw=valid))
    finally:
        hook.remove()
    agree = agreement(pred, p_pred)
    line("slide", dtype="bf16", input=f"{x.shape[1]}x{x.shape[2]}",
         valid=f"{valid[0]}x{valid[1]}", forward_of_each_call=compact(
             sorted(set(batches))),
         class_map=compact(list(pred.shape)), first_ms=f"{first_ms:.2f}",
         kernel_ms=f"{ms:.2f}", plain_ms=f"{p_ms:.2f}",
         class_agreement_with_plain=f"{agree:.4f}", launches=compact(counts))
    check(batches == [(3, 1024, 1024, 6)] * 4,
          f"slide forwards {batches}: expected one batch of 3 crops a call")
    check(counts == PER_FORWARD, f"launch counts {counts} != {PER_FORWARD}")
    check(tuple(pred.shape) == (1, 1024, 1820), f"class map {pred.shape}")
    check(agree >= AGREE_MIN, f"class maps agree on {agree:.4f} < "
                              f"{AGREE_MIN} of pixels")


def phase_cut(torch, kernels, engine, block_cls, rng):
    x = torch.from_numpy(rng.standard_normal((1, 800, 800, 6),
                                             dtype=np.float32))
    stages = set()
    hooks = [m.register_forward_pre_hook(
        lambda m, a: stages.add(tuple(a[0].shape[1:])))
        for m in engine.model.modules() if isinstance(m, block_cls)]
    try:
        pred, p_pred, counts, first_ms, ms, p_ms = predict_paths(
            kernels, lambda: engine.predict(x))
    finally:
        for h in hooks:
            h.remove()
    agree = agreement(pred, p_pred)
    line("cut", dtype="bf16", input="800x800",
         class_map=compact(list(pred.shape)),
         convnext_stages=compact(sorted(stages)), first_ms=f"{first_ms:.2f}",
         kernel_ms=f"{ms:.2f}", plain_ms=f"{p_ms:.2f}",
         class_agreement_with_plain=f"{agree:.4f}", launches=compact(counts))
    check(counts == PER_FORWARD, f"launch counts {counts} != {PER_FORWARD}")
    check(tuple(pred.shape) == (1, 600, 800), f"class map {pred.shape}")
    check((25, 25, 768) in stages, f"no K5 block at 25x25x768: {stages}")
    check(agree >= AGREE_MIN, f"class maps agree on {agree:.4f} < "
                              f"{AGREE_MIN} of pixels")


def main():
    import torch

    kind = phase_device(torch)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import kernel_checks as kc
    from multimodal_sam_adapter_torch.configs.registry import get_config
    from multimodal_sam_adapter_torch.engine.evaluator import (
        Evaluator, _pad_for_model)
    from multimodal_sam_adapter_torch.engine.inference import InferenceEngine
    from multimodal_sam_adapter_torch.models.segmentor import build_segmentor
    from multimodal_sam_adapter_torch.models.twin_convnext import (
        ConvNeXtBlock)
    from multimodal_sam_adapter_torch.ops import kernels

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
    phase_eval(torch, kernels, engine, Evaluator)
    del model, engine, imgs
    torch.cuda.empty_cache()

    rng = np.random.default_rng(SEED)
    cfg = get_config("muses_rgblidar")
    engine = InferenceEngine(_build_bf16(torch, build_segmentor,
                                         cfg["model"], g), cfg["test_cfg"])
    phase_slide(torch, kernels, engine, _pad_for_model, rng)
    del engine
    torch.cuda.empty_cache()

    cfg = get_config("fmb_rgbtherm")
    engine = InferenceEngine(_build_bf16(torch, build_segmentor,
                                         cfg["model"], g), cfg["test_cfg"])
    phase_cut(torch, kernels, engine, ConvNeXtBlock, rng)

    out = []
    for row in rows:
        f32, bf = row.pop("f32"), row.pop("bf16")
        extra = {k: bf[k] for k in ("per_forward_ms", "per_forward_plain_ms")
                 if k in bf}
        out.append(dict(row, launches=counts[row["name"]],
                        max_abs_err=bf["max_abs_err"], ms=bf["ms"],
                        plain_ms=bf["plain_ms"], bound_ms=bf["bound_ms"],
                        bound_by=bf["bound_by"], dtype="bfloat16",
                        shapes=bf["shapes"], ragged=bf["ragged"], f32=f32,
                        **extra))
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
