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
   at batch 3, K6 at FMB's 100x100 grid, batch 3, `whole` mode's 128x228
   grid, the other c1 / x1 layout pairs and the test widths), each against
   its plain PyTorch version in float32 and bfloat16 (tolerances in
   kernel_checks.py), with CUDA-event times of kernel and plain and the
   card's bound for the same work; for K1 and K2 the time of one SDPA call
   on the same inputs (bf16), the yardstick; for K5 its ms per forward
   (each stage's ms times its blocks); for K6 the time of cuDNN's
   conv_transpose2d on its c2 and weight (`product_ms`: the product alone,
   a yardstick, not the same function). K5's delta-only mode (training's:
   no shortcut added) at the four stage shapes, batch 3, against the plain
   delta, its ms beside the eval mode's. A grad-recording call of K1-K5 goes through the kernel's
   autograd Function: it returns the kernel's own output, and its
   gradients equal the plain version's autodiff (K2: the banded backward
   against the unbanded one at N = 4096; K5 in its delta-only mode), in
   float32 and bf16; K6 refuses such a call, launching nothing.
4. forward: the full-width deliver_rgblidar EncoderDecoder (weights drawn
   from a seeded generator) on one 1024x1024x6 input in float32, kernel
   path against plain path, and the launch counts of that one forward.
5. serve: the model in bfloat16 answers 3 requests through
   InferenceEngine.predict ('whole_dim'); the launch counts of those
   requests, ms per image of the kernel and the plain path, peak memory.
   Phases 4, 5, 7 and 8 also print the shapes, strides and dtypes of K6's
   operands (c2, c1, x1) as the backbone hands them over.
6. eval: the bf16 model through the Evaluator over 4 in-memory DELIVER
   samples (labels with ignored pixels, two cases): mIoU on the kernel and
   the plain path, ms per image, launch counts, the condition x case report.
7. slide: muses_rgblidar (19 classes) in bf16 on one 1024x1820 input
   ('slide', 1024^2 crops at stride 640): one forward at batch 3, the class
   map against the plain path's.
8. cut: fmb_rgbtherm (800^2, 14 classes) in bf16 on one 800x800 input
   ('whole_dim_cut'): the (600, 800) class map against the plain path's,
   and K5 at the 25x25 stage.
9. train: the full-width deliver_rgblidar train step (engine/train.py:
   init_train_state, make_train_step; weights from the seed, with_cp on,
   drop path 0.3 / 0.4 and dropout 0.1 on, 1024^2, B=1, OHEM loss). One
   micro-step through the kernels against one through the plain versions
   on the same weights, batch and masks: in float32 the loss within 1e-3
   relative and all gradients within 1e-2 relative L2; in bf16 autocast
   the loss within 1e-2 and the gradients' cosine similarity >= 0.98 over
   all and >= 0.95 for each watched tensor. Then two optimizer updates of
   grad_accum 4 micro-batches each in bf16: finite losses, every
   parameter changed, the BatchNorm running statistics moved, K1-K5
   launched twice their forward counts a micro-step (the forward and the
   recompute of its checkpointed region) and K6 never; the micro-step's
   ms (CUDA events) and peak memory beside the card's name and power
   limit, and one micro-step's device busy ms and idle share
   (utils/profiling.py; trace under build/profiles/).

Then one JSON line with the per-kernel results, and as the last line
{"ok": true, "device": {...}}.
"""
import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

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
# phase 9: launches of one train micro-step with with_cp: each kernel of the
# forward once more in its checkpointed region's recompute; K6 serves eval
# only (f1 is the plain composition with batch statistics in training)
PER_MICRO_STEP = dict({k: 2 * v for k, v in PER_FORWARD.items()},
                      pixel_shuffle_up_bn=0)
TRAIN_MICRO_STEPS = 8          # two updates of grad_accum 4
# kernel path against plain path on one micro-step: float32 differs in
# summation order only; bf16 in where each path rounds to bf16
TRAIN_LOSS_RTOL = {"f32": 1e-3, "bf16": 1e-2}
TRAIN_GRAD_REL_F32 = 1e-2
TRAIN_COS_ALL, TRAIN_COS_EACH = 0.98, 0.95
# where bf16 autocast itself takes a watched gradient below TRAIN_COS_EACH
# of the float32 one (the plain path too), the kernel path's cosine to the
# float32 gradient may trail the plain path's by at most this
TRAIN_COS_SLACK = 0.02
# bf16: the gradients held one by one, where each kernel's backward lands
TRAIN_WATCHED = (
    "backbone.blocks.0.attn.qkv.weight",          # K1's block
    "backbone.blocks.0.attn.rel_pos_h",
    "backbone.blocks.5.attn.qkv.weight",          # K2's block
    "backbone.blocks.5.attn.rel_pos_h",
    "backbone.interactions.0.injector.attn.sampling_offsets.weight",  # K3
    "backbone.interactions.0.injector.attn.attention_weights.weight",
    "backbone.interactions.0.extractor.attn.sampling_offsets.weight",  # K4
    "backbone.interactions.0.extractor.attn.attention_weights.weight",
    "backbone.spm.twin_conv.stages_x.2.0.pointwise_conv1.weight",      # K5
)

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
    smi = smi.splitlines()[0]
    print(smi, flush=True)
    return kind, smi


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


def check_autograd(torch, kc, name):
    """A call that autograd would record. K6 (eval only, no backward)
    raises and launches nothing. K1-K5 go through their Function: the
    kernel's own output, and gradients equal to the plain version's
    autodiff (K2: banded against unbanded at N = 4096; K5 in its
    delta-only mode), float32 and bf16, at the first flagship shape."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    if name == "pixel_shuffle_up_bn":
        fn, args = kc.flagship_case(name, torch.bfloat16, g)
        args = list(args)
        args[0] = args[0].detach().requires_grad_()
        before = dict(kc.kernels.LAUNCHES)
        try:
            fn(*args)
            raised = False
        except RuntimeError as e:
            raised = "no backward" in str(e)
        torch.cuda.synchronize()
        check(raised and kc.kernels.LAUNCHES == before,
              f"{name}: a grad-recording call did not raise before "
              "launching")
        line("kernels", name=name, grad_recording_call="refused")
        return
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        if name == "convnext_block":
            fn, args = kc.convnext_delta_case(*kc.CONVNEXT_STAGES[0], dtype,
                                              g)
        else:
            fn, args = kc.flagship_case(name, dtype, g,
                                        kc.flagship_shapes(name)[0])
        res = kc.function_check(fn, args, g)
        torch.cuda.synchronize()
        tol = kc.GRAD_TOLERANCES[dtype]
        line("kernels", name=name, dtype=tag, grad_recording_call=res[
            "function"], same_output=res["same_output"],
             grad_rel_err=f"{res['grad_rel_err']:.3e}", tol=tol)
        check(res["same_output"] and str(res["function"]).endswith(
            "FunctionBackward"), f"{name} {tag}: a grad-recording call did "
            f"not return the kernel's output through its Function: {res}")
        check(res["grad_rel_err"] <= tol, f"{name} {tag}: gradients "
              f"{res['grad_rel_err']:.3e} from the plain autodiff > {tol}")


def check_delta(torch, kc):
    """K5's delta-only mode (a null shortcut) against the plain delta at
    the four stage shapes, batch 3, bf16 and float32, timed beside the
    eval mode (the shortcut added) on the same inputs."""
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        tol = kc.TOLERANCES[dtype]
        for hw, C in kc.CONVNEXT_STAGES:
            g = torch.Generator(device="cuda").manual_seed(SEED)
            fn, args = kc.convnext_delta_case(hw, C, dtype, g, batch=3)
            got = fn(*args)
            want = kc.plain_reference(fn, args)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            ok = bool((diff <= tol["atol"] + tol["rtol"]
                       * want.float().abs()).all())
            ms = kc.time_ms(fn, args)
            fused_ms = kc.time_ms(kc.convnext_block, args)
            line("kernels", name="convnext_block", mode="delta_only",
                 shape=f"3x{hw}x{hw}x{C}", dtype=tag,
                 max_abs_err=f"{diff.max().item():.3e}",
                 delta_max_abs=f"{want.float().abs().max().item():.3e}",
                 ms=f"{ms:.4f}", with_shortcut_ms=f"{fused_ms:.4f}")
            check(ok and torch.isfinite(got).all().item(),
                  f"K5 delta-only {tag} 3x{hw}x{hw}x{C}: kernel and plain "
                  f"disagree beyond {tol}")


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


def check_product(kc, case):
    """K6's yardstick: cuDNN's conv_transpose2d on K6's flagship c2 and
    weight (bf16), the product and depth-to-space alone."""
    fn, args = kc.product_case(case[1])
    ms = kc.time_ms(fn, args)
    line("kernels", name="pixel_shuffle_up_bn", product="conv_transpose2d",
         product_ms=f"{ms:.4f}")
    return dict(product_ms=ms)


class K6Operands:
    """Records the layouts of K6's operands (c2, c1, x1) as the backbone
    hands them over, by wrapping the backbone's reference to the wrapper
    (which still counts its launches)."""

    def __init__(self):
        import multimodal_sam_adapter_torch.models.backbone as backbone
        self.module, self.seen = backbone, []

    def __enter__(self):
        real = self.real = self.module.pixel_shuffle_up_bn

        def record(c2, weight, c1, x1, scale, shift):
            self.seen.append({name: dict(
                shape=list(t.shape), strides=list(t.stride()),
                dtype=str(t.dtype).replace("torch.", ""))
                for name, t in (("c2", c2), ("c1", c1), ("x1", x1))})
            return real(c2, weight, c1, x1, scale, shift)

        self.module.pixel_shuffle_up_bn = record
        return self

    def __exit__(self, *exc):
        self.module.pixel_shuffle_up_bn = self.real

    def report(self, phase):
        first = self.seen[0] if self.seen else None
        line("kernels", name="pixel_shuffle_up_bn", in_phase=phase,
             calls=len(self.seen), operands=compact(first))
        check(all(s == first for s in self.seen),
              f"{phase}: K6's operand layouts vary between calls")


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
        check_autograd(torch, kc, name)
        if name == "convnext_block":
            check_delta(torch, kc)
        g = torch.Generator(device="cuda").manual_seed(SEED)
        if attention:
            row.update(check_library(
                torch, kc, name, kc.flagship_case(name, torch.bfloat16, g)))
        if name == "pixel_shuffle_up_bn":
            row.update(check_product(
                kc, kc.flagship_case(name, torch.bfloat16, g)))
        rows.append(row)
    return rows


def phase_forward(torch, kernels, model, x):
    with torch.no_grad(), K6Operands() as k6:
        kernels.reset_launches()
        got = model(x)
        torch.cuda.synchronize()
        counts = dict(kernels.LAUNCHES)
        with kernels.plain_kernels():
            want = model(x)
    k6.report("forward")
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
    with K6Operands() as k6:
        kernels.reset_launches()
        k_times, preds = serve(plain=False)      # the main path
        counts = dict(kernels.LAUNCHES)
    k6.report("serve")
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


def predict_paths(kernels, predict, phase):
    """The main path once (its launch counts, K6's operands), the plain
    path once, then each again for its warm time. Returns (class map, plain class map,
    launch counts, first ms, ms, plain ms)."""
    def timed(plain):
        t0 = time.perf_counter()
        if plain:
            with kernels.plain_kernels():
                out = predict()
        else:
            out = predict()
        return out, (time.perf_counter() - t0) * 1e3   # out is on the host

    with K6Operands() as k6:
        kernels.reset_launches()
        pred, first_ms = timed(plain=False)       # the main path
        counts = dict(kernels.LAUNCHES)
    k6.report(phase)
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
            kernels, lambda: engine.predict(x, valid_hw=valid), "slide")
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
            kernels, lambda: engine.predict(x), "cut")
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


def train_batch(torch, g, classes):
    """One 1024^2 micro-batch on the card: a normalised-scale input and
    labels with ~5% ignored (255) pixels."""
    img = torch.randn((1, 1024, 1024, 6), generator=g, device="cuda")
    gt = torch.randint(0, classes, (1, 1024, 1024), generator=g,
                       device="cuda")
    gt[torch.rand((1, 1024, 1024), generator=g, device="cuda") < 0.05] = 255
    return img, gt


def micro_step(torch, kernels, model, img, gt, key, dtype, plain):
    """One micro-batch's loss and backward, no optimizer: through the
    kernels or the plain versions, the backward too (its checkpoint
    recomputes run the wrappers again). Returns the loss."""
    from multimodal_sam_adapter_torch.nn.layers import set_dropout_key

    model.zero_grad(set_to_none=True)
    set_dropout_key(model, key)
    with kernels.plain_kernels() if plain else contextlib.nullcontext():
        with torch.autocast("cuda", dtype=dtype or torch.bfloat16,
                            enabled=dtype is not None):
            loss, _ = model.loss(img, gt)
        loss.backward()
    return loss.detach()


def grads_of(model):
    return {n: p.grad.detach().float().clone()
            for n, p in model.named_parameters()}


def cosine(a, b, names):
    """Cosine similarity of two gradient sets over the tensors `names`."""
    dot = sum((a[n] * b[n]).sum().item() for n in names)
    na = sum(a[n].square().sum().item() for n in names)
    nb = sum(b[n].square().sum().item() for n in names)
    return dot / (na * nb) ** 0.5


def compare_paths(torch, kernels, model, img, gt, tag, dtype, ref=None):
    """One micro-step through the kernels and one through the plain
    versions on the same weights, batch and dropout key. bf16 takes `ref`,
    the float32 plain path's gradients, for the watched tensors on which
    bf16 autocast itself moves the gradient further than TRAIN_COS_EACH:
    there the kernel path must be as close to the float32 gradient as the
    plain bf16 path is (within TRAIN_COS_SLACK). Returns (launches, the
    plain path's gradients)."""
    kernels.reset_launches()
    loss_k = micro_step(torch, kernels, model, img, gt, 1, dtype, False)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    g_k = grads_of(model)
    loss_p = micro_step(torch, kernels, model, img, gt, 1, dtype, True)
    g_p = grads_of(model)
    model.zero_grad(set_to_none=True)
    lk, lp = loss_k.item(), loss_p.item()
    loss_rel = abs(lk - lp) / abs(lp)
    names = list(g_p)
    rel = (sum((g_k[n] - g_p[n]).square().sum().item() for n in names)
           / sum(g_p[n].square().sum().item() for n in names)) ** 0.5
    cos = cosine(g_k, g_p, names)
    each = {n: cosine(g_k, g_p, [n]) for n in TRAIN_WATCHED}
    to_f32 = {}
    if ref is not None:
        to_f32 = {n: (cosine(g_k, ref, [n]), cosine(g_p, ref, [n]))
                  for n in TRAIN_WATCHED}
    short = {n: n.replace("backbone.", "") for n in TRAIN_WATCHED}
    line("train", dtype=tag, loss_kernel=f"{lk:.6f}", loss_plain=f"{lp:.6f}",
         loss_rel_err=f"{loss_rel:.3e}", grad_rel_l2=f"{rel:.3e}",
         grad_cosine=f"{cos:.6f}", watched_cosine=compact(
             {short[n]: round(v, 5) for n, v in each.items()}),
         finite=all(torch.isfinite(t).all().item() for t in g_k.values()),
         launches=compact(counts))
    if to_f32:
        line("train", dtype=tag, watched_cosine_to_f32_kernel_plain=compact(
            {short[n]: [round(k, 5), round(p, 5)]
             for n, (k, p) in to_f32.items()}),
             all_cosine_to_f32_kernel_plain=compact(
                 [round(cosine(g_k, ref, names), 5),
                  round(cosine(g_p, ref, names), 5)]))
    check(counts == PER_MICRO_STEP,
          f"train {tag}: launches {counts} != {PER_MICRO_STEP}")
    check(loss_rel <= TRAIN_LOSS_RTOL[tag],
          f"train {tag}: losses {lk} (kernel) vs {lp} (plain)")
    check(all(torch.isfinite(t).all().item() for t in g_k.values()),
          f"train {tag}: non-finite gradients")
    if dtype is None:
        check(rel <= TRAIN_GRAD_REL_F32,
              f"train f32: gradients {rel:.3e} from plain > "
              f"{TRAIN_GRAD_REL_F32}")
    else:
        check(cos >= TRAIN_COS_ALL, f"train bf16: cosine {cos:.4f} < "
                                    f"{TRAIN_COS_ALL}")
        for n, v in each.items():
            k32, p32 = to_f32[n]
            check(v >= TRAIN_COS_EACH or (p32 < TRAIN_COS_EACH and
                                          k32 >= p32 - TRAIN_COS_SLACK),
                  f"train bf16: {short[n]}: cosine {v:.4f} to the plain "
                  f"path; to the float32 gradient {k32:.4f} (kernel), "
                  f"{p32:.4f} (plain)")
    return counts, g_p


def unchanged_by_rounding(torch, opt, p):
    """True when the optimizer's last step of `p` is, element by element,
    at most half an ulp of p's float32 value (with 1% for the first
    moment's bf16 rounding): p - step rounds back to p. Adam's step is
    lr * scale * m / (sqrt(v) + eps), so a gradient far below eps gives a
    step far below lr."""
    group = next(gr for gr in opt.param_groups if any(q is p for q in
                                                      gr["params"]))
    st, t = opt.state[p], opt.updates
    b1, b2 = opt.betas
    m = st["mu"].float() / (1 - b1 ** t)
    v = st["nu"] / (1 - b2 ** t)
    step = opt.schedule(t - 1) * group["lr_scale"] * (
        m / (v.sqrt() + opt.eps) + group["weight_decay"] * p)
    a = p.detach().abs()
    ulp = torch.nextafter(a, torch.full_like(a, float("inf"))) - a
    return bool((step.abs() <= 0.505 * ulp).all())


def phase_train(torch, kernels, smi, g):
    """The full-width train step: kernel vs plain on one micro-step (f32,
    bf16), then two grad_accum-4 updates in bf16 through the kernels.
    Returns the launches of one micro-step."""
    from multimodal_sam_adapter_torch.configs.registry import get_config
    from multimodal_sam_adapter_torch.engine.train import init_train_state
    from multimodal_sam_adapter_torch.nn.layers import KeyedDropout

    cfg = get_config("deliver_rgblidar")
    accum = cfg["data"]["grad_accum"]
    state = init_train_state(
        cfg["model"], "cuda", seed=SEED,
        optimizer_kwargs=dict(cfg["optimizer"], grad_accum_steps=accum))
    model = state.model
    rates = sorted({m.rate for m in model.modules()
                    if isinstance(m, KeyedDropout) and m.rate > 0})
    classes = cfg["model"]["num_classes"]
    img, gt = train_batch(torch, g, classes)
    line("train", config="deliver_rgblidar", input="1x1024x1024x6",
         with_cp=model.backbone.with_cp, grad_accum=accum,
         drop_rates=compact([min(rates), max(rates)]),
         params=sum(p.numel() for p in model.parameters()))
    check(model.training and model.backbone.with_cp and accum == 4
          and len(rates) > 2, "train: not the config's train mode")

    _, ref = compare_paths(torch, kernels, model, img, gt, "f32", None)
    counts, _ = compare_paths(torch, kernels, model, img, gt, "bf16",
                              torch.bfloat16, ref)
    del ref
    train_updates(torch, kernels, state, smi, g)
    return counts


def train_updates(torch, kernels, state, smi, g):
    """Two grad_accum-4 updates in bf16 through the kernels, then one
    micro-step profiled."""
    from multimodal_sam_adapter_torch.engine.train import make_train_step
    from multimodal_sam_adapter_torch.utils.profiling import profile_calls

    model = state.model
    classes = model.decode_head.conv_seg.out_channels
    accum = state.optimizer.grad_accum_steps
    step = make_train_step(model, state.optimizer,
                           compute_dtype=torch.bfloat16)
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = {n: b.clone() for n, b in model.named_buffers()
              if n.endswith(("running_mean", "running_var"))}
    torch.cuda.reset_peak_memory_stats()
    losses, times, updated = [], [], []
    for i in range(TRAIN_MICRO_STEPS):
        img, gt = train_batch(torch, g, classes)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        kernels.reset_launches()
        start.record()
        out = step(state, dict(img=img, gt=gt))
        end.record()
        torch.cuda.synchronize()
        check(dict(kernels.LAUNCHES) == PER_MICRO_STEP,
              f"train micro-step {i}: launches {dict(kernels.LAUNCHES)}")
        times.append(start.elapsed_time(end))
        losses.append(out["loss"].item())
        updated.append(out["updated"])
    peak = torch.cuda.max_memory_allocated()
    unchanged = [n for n, p in model.named_parameters()
                 if torch.equal(p, params0[n])]
    rounded = [n for n in unchanged if unchanged_by_rounding(
        torch, state.optimizer, model.get_parameter(n))]
    still = [n for n, b in stats0.items()
             if torch.equal(model.get_buffer(n), b)]
    accum_ms = sorted(t for t, u in zip(times[1:], updated[1:]) if not u)
    update_ms = [t for t, u in zip(times, updated) if u]
    line("train", dtype="bf16", micro_steps=TRAIN_MICRO_STEPS,
         updates=state.optimizer.updates,
         losses=compact([round(v, 5) for v in losses]),
         first_micro_step_ms=f"{times[0]:.1f}",
         micro_step_ms=f"{accum_ms[len(accum_ms) // 2]:.1f}",
         micro_step_ms_all=compact([round(t, 1) for t in times]),
         update_micro_step_ms=compact([round(t, 1) for t in update_ms]),
         peak_mem_gib=f"{peak / 2**30:.3f}", card=repr(smi),
         unchanged_params=compact(unchanged),
         unchanged_by_rounding=len(rounded), unmoved_bn_stats=len(still))
    check(all(np.isfinite(v) for v in losses), f"train: losses {losses}")
    check(updated == [(i + 1) % accum == 0
                      for i in range(TRAIN_MICRO_STEPS)]
          and state.optimizer.updates == 2,
          f"train: updates at {updated}")
    check(unchanged == rounded, "train: parameters unchanged whose step "
          f"exceeds half an ulp: {sorted(set(unchanged) - set(rounded))}")
    check(not still, f"train: BatchNorm statistics unmoved: {still[:5]}")

    img, gt = train_batch(torch, g, classes)
    trace = Path(__file__).resolve().parent / "build" / "profiles" / (
        "train_micro_step.json")
    res = profile_calls(lambda: micro_step(
        torch, kernels, model, img, gt, 2, torch.bfloat16, False), 1, trace,
        repeats=3)
    model.zero_grad(set_to_none=True)
    fams = list(res["family_ms"].items())[:6]
    line("train", dtype="bf16", profiled="one micro-step (no update)",
         busy_ms=f"{res['busy_ms']:.2f}",
         unprofiled_ms=f"{res['unprofiled_ms']:.2f}",
         idle_share=f"{res['idle_share']:.3f}",
         kernel_launches=int(res["kernel_launches"]),
         top_families_ms=compact({k: round(v, 2) for k, v in fams}),
         card=repr(smi))


def main():
    import torch

    kind, smi = phase_device(torch)
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
    del engine
    torch.cuda.empty_cache()

    train_counts = phase_train(torch, kernels, smi, g)

    out = []
    for row in rows:
        f32, bf = row.pop("f32"), row.pop("bf16")
        extra = {k: bf[k] for k in ("per_forward_ms", "per_forward_plain_ms")
                 if k in bf}
        if "product_ms" in row:   # K6's yardstick: a key of its own
            extra["product_ms"] = row.pop("product_ms")
        out.append(dict(row, launches=counts[row["name"]],
                        train_launches=train_counts[row["name"]],
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
