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
10. train_entry: the train entry's loop (tools/train.py:build_runner) on
   deliver_rgblidar at full width, weights as the JAX package initialises
   them (models/init.py; no pretrained files), the config's own train
   pipeline (blur, 0.5-2.0 rescale of 1042^2, 1024^2 crop at cat_max_ratio
   0.75, flip, photometric distortion, native normalize + pad) through the
   threaded loader, grad_accum 4, bf16 autocast: 8 in-memory raw train
   samples (1042^2 BGR + LiDAR, 25-class label blocks, 5% ignored) and 2
   pre-normalised val samples, 2 epochs with a checkpoint and an eval each
   (the bf16 eval model, K6 on it), into a temporary directory removed at
   the end. Launches of every micro-step (K1-K5 at 40 / 8 / 8 / 12 / 144,
   K6 0) and of each eval forward (K6 1); finite losses; 4 updates. Then a
   new model and optimizer resume from the epoch-0 checkpoint: the
   restored weights, BatchNorm statistics and optimizer state bit-equal to
   the state saved, and the next micro-step's loss within 1e-3 relative of
   the straight run's. Prints micro-step ms through the loader and on
   pre-made device batches (the same step, the same call), the host's
   wait for the next batch between steps, loader host ms a sample
   (threaded and one pipeline call alone), one micro-step's
   device busy ms and idle share, peak GiB, checkpoint GB and save / load
   seconds, eval seconds a sample, with the card's name and power limit.

11. ddp: data parallelism, on max(2, cards) ranks: one a card over NCCL
   where the machine has two or more cards, else two sharing card 0 over
   gloo. A 1-rank NCCL process group all-reduces once. The float32 step
   of phase 9's setup (JAX init from the seed, with_cp, drop path and
   dropout on, OHEM) in this process on a global batch of one 1024^2
   sample a rank (grad_accum 1; then grad_accum 2, one update, on twice
   that), then the rank processes of this script (`--ddp-rank`), one
   sample a rank: (a) the step through DistributedDataParallel: gradients
   and, after the grad_accum-2 update (no_sync on its first micro-step),
   parameters bit-equal across the ranks; the ranks' mean loss within
   1e-3 relative of the one process's, gradients and parameters within
   1e-2 relative L2, BatchNorm running statistics within 1e-3 relative;
   K1-K5 at 40 / 8 / 8 / 12 / 144 and K6 at 0 every micro-step, one
   micro-step more after the update (the optimizer's state in memory);
   (b) the train entry's runner in bf16 on each rank (4 raw 1042^2
   samples a rank through the config's train pipeline and the loader's
   shard, grad_accum 2, one epoch, a checkpoint written by rank 0, an eval
   of one val sample a rank with the histograms summed over the ranks):
   equal summaries, the summed histograms equal to the sum of the ranks'
   own, parameters and BatchNorm statistics bit-equal across ranks, and a
   resume on every rank restoring the state saved; (c) part (a)'s step
   with the optimizer's state sharded over the ranks by ZeRO
   (parallel/zero.py): the update bit-equal to the unsharded optimizer's
   from the same gradients, equal across ranks, within 1e-2 relative L2
   of the one process's; the state gathered on rank 0 equal to the
   unsharded optimizer's; each state tensor on one rank; the gathered
   state, saved and loaded into ZeRO and into the unsharded optimizer,
   restored bit for bit; (d) the full-width float32 forward with tensor
   parallelism over the ranks (parallel/tp.py; data 1, model = the ranks)
   against the unsharded kernel-path forward on the same weights, logits
   within 1e-3 x max|logits|, and in bf16 through InferenceEngine.predict
   the class maps agreeing on >= 98%; the launches of one forward
   (K1 20, K2 4, K3 4, K4 6, K5 72, K6 1), K1 and K2 called with 16 /
   ranks heads and K3 and K4 with 16 / ranks heads. Prints each rank's
   micro-step ms with and without no_sync, three all-reduces' ms of the
   gradient volume, peak GiB (the step's beside ZeRO's), ZeRO's state
   GiB, TP's ms a forward and all-reduces, beside the card's name and
   power limit. Two ranks sharing one card over gloo are a correctness
   run, not a speed figure.
12. files: the entries on image files, at full width, in a temporary
   directory removed at the end. (a) The port's PNG writer
   (data/image_io.py; the row filters None, Sub, Up, Average and Paeth in
   turn) writes a DeLiVER tree (two 1024^2 samples in each split: BGR,
   3-channel LiDAR, 25-class labels with 5% ignored) and a MUSES tree
   (one 1920x1080 clear/day frame, its LiDAR .npz, 19-class labels).
   (b) Every file decodes through the host core to the array written, and
   the numpy twin unfilters the first 64 scanlines of each as the core
   does. (c) tools/test.py on the DeLiVER tree (deliver_rgblidar, bf16,
   seed weights saved as a torch checkpoint, --show-dir): K1-K6 at
   20 / 4 / 4 / 6 / 72 / 1 a forward; the histograms bit-equal to
   `Evaluator.run` over the same decoded samples held in memory, with the
   same engine; every blend decodes to `show_result`'s array. (d)
   tools/infer_test.py on the MUSES tree (muses_rgblidar, 'slide', seed
   weights): the labelTrainIds PNG decodes to the class map
   `InferenceEngine.predict` gives on the test pipeline's output. (e)
   tools/train.py on the DeLiVER tree, one epoch of two micro-steps,
   grad_accum 2: one update, finite losses, K1-K5 at 40 / 8 / 8 / 12 / 144
   and K6 at 0 each micro-step. (f) apis.inference_segmentor on one
   DeLiVER file gives (c)'s class map. Prints ms to decode and to encode a
   1024^2 PNG, the test pipeline's ms a sample from files, eval ms/img of
   the entry's run (its model's first forwards and the blends included)
   and of the same engine again from the files and from memory, the
   micro-step's ms through the file loader, and how far the API's class
   map moves when its batch axis has numpy's stride 0 (the agreement),
   beside the card's name and power limit.
   Phase 10 also times the train loader and pipeline with the rescale
   through F.interpolate (the train side's earlier resize), beside
   data/resize.py's.

`python3 chip_smoke.py --phase ddp` runs phases 1, 2 and 11 alone (the
four-card run); `--phase files` runs phases 1, 2 and 12.

Then one JSON line with the per-kernel results, and as the last line
{"ok": true, "device": {...}}.
"""
import contextlib
import gc
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
# phase 10: the train entry's samples, epochs and resume tolerance
ENTRY_TRAIN_SAMPLES, ENTRY_VAL_SAMPLES, ENTRY_EPOCHS = 8, 2, 2
ENTRY_RESUME_RTOL = 1e-3
ENTRY_TIMED_STEPS = 14         # micro-steps on pre-made device batches
# phase 11: data parallelism on max(2, cards) ranks (`ddp_ranks`). The
# float32 step (parts a and c) holds one 1024^2 sample a rank, grad_accum
# 2 for its update, then one micro-step more with the optimizer's state in
# memory; the bf16 runner (part b) 4 raw samples and 1 val sample a rank;
# the tensor-parallel forward (part d) one 1024^2 input
DDP_MICRO_STEPS = 2
DDP_RUNNER_SAMPLES, DDP_VAL_SAMPLES = 4, 1
DDP_LOSS_RTOL = DDP_STATS_RTOL = 1e-3
DDP_STATS_ATOL = 1e-6
DDP_TIMEOUT = 720              # seconds for the ranks together
TP_REQUESTS = 3                # timed bf16 TP forwards after a first
# phase 12: the DeLiVER samples on file (their conditions and cases route
# the report), the MUSES record, the PNG row filters taken in turn, the
# scanlines the numpy twin unfilters beside the host core
FILES_DELIVER_STEMS = ("sun_test_0", "motionblur_rain_test_1")
FILES_MUSES_RECORD = "REC0001"
FILES_FILTERS = (0, 1, 2, 3, 4)
FILES_SLAB_ROWS = 64
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
    print(smi, flush=True)             # one line a card
    return kind, smi.splitlines()[0]


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
        optimizer_kwargs=dict(cfg["optimizer"], grad_accum_steps=accum),
        init="random")
    model = state.model
    drops = [m for m in model.modules()
             if isinstance(m, KeyedDropout) and m.rate > 0]
    rates = sorted({m.rate for m in drops})
    classes = cfg["model"]["num_classes"]
    img, gt = train_batch(torch, g, classes)
    line("train", config="deliver_rgblidar", input="1x1024x1024x6",
         with_cp=model.backbone.with_cp, grad_accum=accum,
         drop_rates=compact([min(rates), max(rates)]),
         dropout_modules=len(drops),   # one mask draw a module and sample
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


class RawTrainSamples:
    """In-memory raw DELIVER-like train samples, as a dataset's __getitem__
    returns them: (1042, 1042, 6) float32 BGR + LiDAR levels in 0-255 and
    25-class labels in 64-pixel blocks with ~5% ignored (255) pixels."""

    def __init__(self, n, seed):
        from multimodal_sam_adapter_torch.data.datasets import DELIVER

        self.CLASSES, self.PALETTE = DELIVER.CLASSES, DELIVER.PALETTE
        rng = np.random.default_rng(seed)
        self.samples = []
        for i in range(n):
            blocks = rng.integers(0, len(self.CLASSES), (17, 17),
                                  dtype=np.uint8)
            gt = np.repeat(np.repeat(blocks, 64, 0), 64, 1)[:1042, :1042]
            gt = np.ascontiguousarray(gt)
            gt[rng.random((1042, 1042)) < 0.05] = 255
            img = rng.integers(0, 256, (1042, 1042, 6)).astype(np.float32)
            self.samples.append(dict(img=img, gt=gt, meta={"stem": f"t{i}"}))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def _host_copy(torch, obj):
    """A copy of a (nested) state_dict with every tensor on the host."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(torch, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(torch, v) for v in obj)
    return obj


def _bit_equal(torch, a, b, where=""):
    """Nested state_dicts equal, tensors bit for bit and dtype for dtype."""
    if torch.is_tensor(a):
        return (torch.is_tensor(b) and a.dtype == b.dtype
                and torch.equal(a.cpu(), b.cpu())) or where
    if isinstance(a, dict):
        if not isinstance(b, dict) or a.keys() != b.keys():
            return where or "keys"
        for k in a:
            bad = _bit_equal(torch, a[k], b[k], f"{where}/{k}")
            if bad is not True:
                return bad
        return True
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return where
        for i, (x, y) in enumerate(zip(a, b)):
            bad = _bit_equal(torch, x, y, f"{where}/{i}")
            if bad is not True:
                return bad
        return True
    return a == b or where


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


@contextlib.contextmanager
def _interpolate_rescale(torch):
    """TrainPipeline's image rescale through F.interpolate (bilinear, half-
    pixel centres: within a few hundredths of OpenCV's) while entered, for
    a timing beside data/resize.py's."""
    from multimodal_sam_adapter_torch.data import pipelines

    def interpolate(img, size_wh, native=True):
        t = torch.from_numpy(np.ascontiguousarray(img, np.float32))
        out = torch.nn.functional.interpolate(
            t.permute(2, 0, 1)[None], size=(size_wh[1], size_wh[0]),
            mode="bilinear", align_corners=False)
        return out[0].permute(1, 2, 0).contiguous().numpy()

    real = pipelines.resize_bilinear_hwc
    pipelines.resize_bilinear_hwc = interpolate
    try:
        yield
    finally:
        pipelines.resize_bilinear_hwc = real


def phase_train_entry(torch, kernels, smi):
    """The train entry's loop at full width (phase 10). Returns the
    launches of its run: every micro-step and every eval forward."""
    import shutil
    import tempfile

    from multimodal_sam_adapter_torch.configs.registry import get_config
    from multimodal_sam_adapter_torch.data.pipelines import TrainPipeline
    from multimodal_sam_adapter_torch.engine.runner import to_device
    from multimodal_sam_adapter_torch.tools.train import (build_runner,
                                                          ckpt_meta)
    from multimodal_sam_adapter_torch.utils.profiling import profile_calls

    cfg = get_config("deliver_rgblidar")
    cfg["runner"]["max_epochs"] = cfg["optimizer"]["max_epochs"] = (
        ENTRY_EPOCHS)
    cfg["checkpoint"]["max_keep_ckpts"] = ENTRY_EPOCHS   # keep epoch 0's
    tp = cfg["train_pipeline"]
    check(cfg["data"] == dict(samples_per_gpu=1, grad_accum=4)
          and tp["resize"] == dict(img_scale=(1042, 1042),
                                   ratio_range=(0.5, 2.0))
          and tp["crop"] == dict(crop_size=(1024, 1024), cat_max_ratio=0.75)
          and tp["gaussian_blur"] and tp["photometric"],
          "train_entry: not the config's own train setup")
    train_ds = RawTrainSamples(ENTRY_TRAIN_SAMPLES, SEED)
    val_ds = DeliverSamples(ENTRY_VAL_SAMPLES, SEED + 1)
    meta = ckpt_meta(cfg, "deliver_rgblidar", train_ds, SEED, False)
    work = tempfile.mkdtemp(prefix="msa_train_entry_")
    try:
        def runner_of():
            return build_runner(cfg, train_ds, work, device="cuda", seed=SEED,
                                bf16=True, val_ds=val_ds, val_pipeline=None,
                                meta=meta)

        t0 = time.perf_counter()
        runner = runner_of()
        build_s = time.perf_counter() - t0
        steps, evals, saves, saved = [], [], [], {}
        step, eval_fn, save = runner.train_step, runner.eval_fn, runner._save

        def timed_step(state, batch):
            before = dict(kernels.LAUNCHES)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(state, batch)
            torch.cuda.synchronize()
            steps.append(dict(start=t, end=time.perf_counter(),
                              loss=out["loss"].item(), launches={
                                  k: kernels.LAUNCHES[k] - before[k]
                                  for k in before}))
            return out

        def timed_eval(state):
            before = dict(kernels.LAUNCHES)
            t = time.perf_counter()
            summary = eval_fn(state)
            torch.cuda.synchronize()
            evals.append(dict(seconds=time.perf_counter() - t,
                              summary=summary, launches={
                                  k: kernels.LAUNCHES[k] - before[k]
                                  for k in before}))
            return summary

        def timed_save(epoch, tag=None):
            if not saved:      # the state as saved after epoch 0
                saved["model"] = _host_copy(torch,
                                            runner.state.model.state_dict())
                saved["optimizer"] = _host_copy(
                    torch, runner.state.optimizer.state_dict())
            t = time.perf_counter()
            path = save(epoch, tag)
            saves.append((path, time.perf_counter() - t))
            return path

        runner.train_step, runner.eval_fn, runner._save = (
            timed_step, timed_eval, timed_save)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        runner.run()                                   # the main path
        counts = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        per_epoch = len(runner.train_loader)
        n_steps = ENTRY_EPOCHS * per_epoch
        losses = [s["loss"] for s in steps]
        bad = [i for i, s in enumerate(steps)
               if s["launches"] != PER_MICRO_STEP]
        eval_expect = {k: ENTRY_VAL_SAMPLES * v
                       for k, v in PER_FORWARD.items()}
        with_loader = [steps[i]["end"] - steps[i - 1]["end"]
                       for i in range(1, len(steps)) if i % per_epoch]
        step_only = [s["end"] - s["start"] for s in steps[1:]]
        # host time between one step's end and the next one's start: the
        # loader's batch, its pinned copy, and the loop
        waits = [steps[i]["start"] - steps[i - 1]["end"]
                 for i in range(1, len(steps)) if i % per_epoch]
        ckpt = os.path.join(work, "ckpts", f"step_{per_epoch}.pth")
        ckpt_gb = os.path.getsize(ckpt) / 1e9
        line("train_entry", config="deliver_rgblidar", init="jax",
             samples=f"{ENTRY_TRAIN_SAMPLES}x1042x1042x6",
             micro_steps=len(steps), updates=runner.state.optimizer.updates,
             losses=compact([round(v, 5) for v in losses]),
             launches=compact(counts),
             eval_launches=compact([e["launches"] for e in evals]),
             eval_mIoU=compact([round(e["summary"]["mIoU"], 4)
                                for e in evals]),
             peak_mem_gib=f"{peak / 2**30:.3f}", build_s=f"{build_s:.1f}",
             card=repr(smi))
        check(len(steps) == n_steps and not bad,
              f"train_entry: micro-steps {len(steps)} (want {n_steps}), "
              f"launches off at {bad[:3]}: "
              f"{[steps[i]['launches'] for i in bad[:1]]}")
        check(all(e["launches"] == eval_expect for e in evals)
              and len(evals) == ENTRY_EPOCHS,
              f"train_entry: eval launches {[e['launches'] for e in evals]}"
              f" != {eval_expect} each")
        check(all(np.isfinite(v) for v in losses)
              and runner.state.optimizer.updates == n_steps // 4,
              f"train_entry: losses {losses}, "
              f"{runner.state.optimizer.updates} updates")
        names = sorted(os.listdir(os.path.join(work, "ckpts")))
        check(f"step_{per_epoch}.pth" in names and
              f"step_{n_steps}.pth" in names and "best.pth" in names,
              f"train_entry: checkpoints {names}")
        straight_loss = steps[per_epoch]["loss"]       # epoch 1's first
        del runner, eval_fn, save
        step = None
        torch.cuda.empty_cache()

        # a new model and optimizer resume from the epoch-0 checkpoint
        resumed = runner_of()
        step = resumed.train_step          # timed_step's from here on
        t = time.perf_counter()
        resumed.resume(ckpt)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        same_model = _bit_equal(torch, saved["model"],
                                resumed.state.model.state_dict())
        same_opt = _bit_equal(torch, saved["optimizer"],
                              resumed.state.optimizer.state_dict())
        check(same_model is True and same_opt is True
              and resumed.start_epoch == 1
              and resumed.state.step == per_epoch,
              f"train_entry: restored state differs from the saved one "
              f"(model {same_model}, optimizer {same_opt}, epoch "
              f"{resumed.start_epoch}, step {resumed.state.step})")
        del saved
        loader = resumed.train_loader
        loader.set_epoch(1)
        batches = []
        for b in loader:
            batches.append(to_device(b, torch.device("cuda")))
            if len(batches) == 4:
                break
        loss = step(resumed.state, batches[0])["loss"].item()
        rel = abs(loss - straight_loss) / abs(straight_loss)
        check(rel <= ENTRY_RESUME_RTOL,
              f"train_entry: resumed loss {loss} vs straight "
              f"{straight_loss} (rel {rel:.3e})")

        # the same step on pre-made device batches
        steps.clear()
        for i in range(ENTRY_TIMED_STEPS + 1):
            timed_step(resumed.state, batches[i % len(batches)])
        device_batches = [steps[i]["end"] - steps[i - 1]["end"]
                          for i in range(2, len(steps))]
        # the loader alone: threaded over an epoch, and one pipeline call
        loader.set_epoch(7)
        t = time.perf_counter()
        n = sum(len(b["img"]) for b in loader)
        loader_ms = (time.perf_counter() - t) * 1e3 / n
        pipe = TrainPipeline(cfg["train_pipeline"],
                             cfg["dataset"]["modalities_ch"])
        t = time.perf_counter()
        for i in range(2):
            pipe(train_ds[i], np.random.default_rng(i))
        pipe_ms = (time.perf_counter() - t) * 1e3 / 2
        # the same with the train side's earlier rescale (F.interpolate,
        # not OpenCV's arithmetic), in this call: the loader before and
        # after the resize that equals the JAX package's
        with _interpolate_rescale(torch):
            loader.set_epoch(7)
            t = time.perf_counter()
            n = sum(len(b["img"]) for b in loader)
            loader_ms_before = (time.perf_counter() - t) * 1e3 / n
            t = time.perf_counter()
            for i in range(2):
                pipe(train_ds[i], np.random.default_rng(i))
            pipe_ms_before = (time.perf_counter() - t) * 1e3 / 2
        trace = Path(__file__).resolve().parent / "build" / "profiles" / (
            "train_entry_micro_step.json")
        res = profile_calls(lambda: step(resumed.state, batches[1]), 1,
                            trace, repeats=3)
        line("train_entry", resumed_from=f"epoch 0 (step {per_epoch})",
             restored_bit_equal=True, loss_resumed=f"{loss:.6f}",
             loss_straight=f"{straight_loss:.6f}", loss_rel_err=f"{rel:.3e}",
             micro_step_ms_with_loader=f"{_median(with_loader) * 1e3:.1f}",
             micro_step_ms_with_loader_all=compact(
                 [round(x * 1e3, 1) for x in with_loader]),
             micro_step_ms_step_only=f"{_median(step_only) * 1e3:.1f}",
             data_wait_ms=f"{_median(waits) * 1e3:.1f}",
             data_wait_ms_max=f"{max(waits) * 1e3:.1f}",
             micro_step_ms_device_batches=(
                 f"{_median(device_batches) * 1e3:.1f}"),
             micro_step_ms_device_batches_all=compact(
                 [round(x * 1e3, 1) for x in device_batches]),
             loader_ms_per_sample=f"{loader_ms:.1f}",
             loader_ms_per_sample_interpolate=f"{loader_ms_before:.1f}",
             loader_threads=loader.num_threads,
             pipeline_ms_per_sample=f"{pipe_ms:.1f}",
             pipeline_ms_per_sample_interpolate=f"{pipe_ms_before:.1f}",
             busy_ms=f"{res['busy_ms']:.2f}",
             unprofiled_ms=f"{res['unprofiled_ms']:.2f}",
             idle_share=f"{res['idle_share']:.3f}",
             ckpt_gb=f"{ckpt_gb:.3f}",
             save_s=compact([round(s, 2) for _, s in saves]),
             load_s=f"{load_s:.2f}",
             eval_s_per_sample=compact([round(e["seconds"] /
                                              ENTRY_VAL_SAMPLES, 3)
                                        for e in evals]),
             card=repr(smi))
        return counts
    finally:
        shutil.rmtree(work, ignore_errors=True)


# --------------------------------------------------------------- phase 11

def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_env(rank, world, port):
    return dict(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                MASTER_PORT=str(port))


def ddp_ranks(torch):
    """Phase 11's ranks: one a card where there are two or more, else two
    sharing card 0."""
    return max(2, torch.cuda.device_count())


def ddp_samples(torch, world):
    """DDP_MICRO_STEPS x world 1024^2 samples on the current card from one
    seeded generator: every process draws the same ones. Micro-step i of
    the global batch holds samples i * world ... in rank order."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    return [train_batch(torch, g, 25)
            for _ in range(DDP_MICRO_STEPS * world)]


def train_state(torch, accum):
    """phase 11's float32 deliver_rgblidar train state: the JAX init from
    SEED, with_cp, drop path and dropout at the config's rates, the
    config's optimizer with grad_accum `accum`."""
    from multimodal_sam_adapter_torch.configs.registry import get_config
    from multimodal_sam_adapter_torch.engine.train import init_train_state

    cfg = get_config("deliver_rgblidar")
    state = init_train_state(cfg["model"], "cuda", seed=SEED, init="jax",
                             optimizer_kwargs=dict(cfg["optimizer"],
                                                   grad_accum_steps=accum))
    state.seed = SEED + 1
    return state


def step_run(torch, kernels, samples, accum, wrap, grads_on="cuda",
             zero=False, keep_state=False):
    """The float32 train step of `train_state` (OHEM) through
    `make_train_step` on `samples` (a list of (img, gt)), the model
    wrapped by `wrap`, the optimizer's state sharded over the ranks with
    `zero` (parallel/zero.py). Returns the losses, the gradients the
    optimizer saw at the update (copied to `grads_on`; None: not kept),
    the parameters after it, the BatchNorm statistics, each micro-step's
    launches and CUDA-event ms, and with `keep_state` the state itself."""
    from multimodal_sam_adapter_torch.engine.train import make_train_step
    from multimodal_sam_adapter_torch.parallel.zero import shard_optimizer

    state = train_state(torch, accum)
    if zero:
        state.optimizer = shard_optimizer(state.optimizer)
    named = dict(state.model.named_parameters())
    out = dict(losses=[], grads=None, launches=[], ms=[])

    def before_update(optimizer, args, kwargs):
        if grads_on and optimizer.mini_step + 1 == accum:
            out["grads"] = {n: p.grad.detach().to(grads_on, copy=True)
                            for n, p in named.items()}

    state.optimizer.register_step_pre_hook(before_update)
    step = make_train_step(wrap(state.model), state.optimizer)
    for img, gt in samples:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        kernels.reset_launches()
        start.record()
        res = step(state, dict(img=img, gt=gt))
        end.record()
        torch.cuda.synchronize()
        out["launches"].append(dict(kernels.LAUNCHES))
        out["ms"].append(start.elapsed_time(end))
        out["losses"].append(res["loss"].item())
    out["params"] = {n: p.detach().clone() for n, p in named.items()}
    out["stats"] = {n: b.clone() for n, b in state.model.named_buffers()
                    if n.endswith(("running_mean", "running_var"))}
    if keep_state:
        out["state"] = state
    del state, step, named
    gc.collect()
    return out


def phase_ddp_reference(torch, kernels, work):
    """Phase 11's single process: a 1-rank NCCL group all-reduces once;
    then the float32 step on the global batches (grad_accum 1 on the
    first; grad_accum 2, one update, on both), saved to the host for the
    ranks."""
    from multimodal_sam_adapter_torch.parallel import ddp

    env = _rank_env(0, 1, _free_port())
    before = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        ddp.init_distributed("nccl")
        t = torch.arange(1 << 20, dtype=torch.float32, device="cuda")
        got = ddp.all_reduce_sum(t)
        torch.cuda.synchronize()
        backend = torch.distributed.get_backend()
        line("ddp", nccl_world=ddp.rank_world()[1], backend=backend,
             all_reduce_equal=torch.equal(got, t))
        check(backend == "nccl" and torch.equal(got, t),
              "the 1-rank NCCL group did not all-reduce")
    finally:
        ddp.close_distributed()
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    world = ddp_ranks(torch)
    samples = ddp_samples(torch, world)
    glob = [(torch.cat([img for img, _ in pair]),
             torch.cat([gt for _, gt in pair]))
            for pair in (samples[i:i + world]
                         for i in range(0, len(samples), world))]
    torch.cuda.reset_peak_memory_stats()
    one = step_run(torch, kernels, glob[:1], 1, lambda m: m)
    ref = dict(loss=one["losses"][0],
               grads=_host_copy(torch, one["grads"]),
               stats=_host_copy(torch, one["stats"]))
    del one
    torch.cuda.empty_cache()
    accum = step_run(torch, kernels, glob, DDP_MICRO_STEPS, lambda m: m,
                     grads_on=None)
    ref["params"] = _host_copy(torch, accum["params"])
    ref["accum_losses"] = accum["losses"]
    peak = torch.cuda.max_memory_allocated()
    line("ddp", reference="1 process, float32, global batch "
         f"{world}x1024x1024x6", loss=f"{ref['loss']:.6f}",
         accum_losses=compact([round(v, 6) for v in accum["losses"]]),
         micro_step_ms=compact([round(v, 1) for v in accum["ms"]]),
         peak_mem_gib=f"{peak / 2**30:.3f}")
    del accum, samples, glob
    torch.save(ref, work / "reference.pt")
    del ref
    torch.cuda.empty_cache()


def phase_ddp(torch, kernels, smi):
    """Phase 11: the reference in this process, then `ddp_ranks` rank
    processes of this script (gloo sharing card 0 on a one-card machine,
    NCCL with a card each otherwise) run the step, the runner, the step
    with ZeRO and the tensor-parallel forward. Returns rank 0's launches
    of one micro-step of the step through DistributedDataParallel
    (`ddp`), of one with ZeRO (`zero`) and of one TP forward (`tp`)."""
    import shutil
    import tempfile

    work = Path(tempfile.mkdtemp(prefix="msa_ddp_"))
    try:
        phase_ddp_reference(torch, kernels, work)
        cards = torch.cuda.device_count()
        world = ddp_ranks(torch)
        backend = "nccl" if cards >= world else "gloo"
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--ddp-rank",
             str(work), backend],
            env=dict(os.environ, **_rank_env(r, world, port)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        logs, timed_out = [], False
        t0 = time.perf_counter()
        for p in procs:
            try:
                out, _ = p.communicate(
                    timeout=max(1.0, DDP_TIMEOUT - (time.perf_counter()
                                                    - t0)))
            except subprocess.TimeoutExpired:
                timed_out = True
                for q in procs:
                    q.kill()
                out, _ = p.communicate()
            logs.append(out)
        for r, (p, log) in enumerate(zip(procs, logs)):
            text = log if p.returncode == 0 else log[-6000:]
            for ln in text.splitlines():
                if ln.startswith(("[ddp", "FAILED")) or p.returncode:
                    print(ln, flush=True)
        check(not timed_out, f"ddp: the ranks ran past {DDP_TIMEOUT} s")
        check(all(p.returncode == 0 for p in procs),
              f"ddp: rank exit codes {[p.returncode for p in procs]}")
        results = [json.loads((work / f"rank{r}.json").read_text())
                   for r in range(world)]
        shared = cards < world
        line("ddp", ranks=world, backend=backend, cards=cards,
             shared_card=shared,
             step_micro_step_ms=compact([r["step_ms"] for r in results]),
             all_reduce_ms=compact([r["all_reduce_ms"] for r in results]),
             all_reduce_gb=results[0]["all_reduce_gb"],
             runner_micro_step_ms=compact([r["runner_ms"] for r in results]),
             peak_mem_gib=compact([r["peak_gib"] for r in results]),
             step_peak_gib=compact([r["step_peak_gib"] for r in results]),
             zero_peak_gib=compact([r["zero_peak_gib"] for r in results]),
             zero_state_gib=compact([r["zero_state_gib"] for r in results]),
             zero_micro_step_ms=compact([r["zero_ms"] for r in results]),
             tp_ms_per_forward=compact([r["tp_ms"] for r in results]),
             unsharded_ms_per_forward=compact([r["tp_whole_ms"]
                                               for r in results]),
             tp_all_reduces=results[0]["tp_all_reduces"],
             card=repr(smi), note=(
                 "not a speed claim: ranks sharing one card over gloo say "
                 "nothing of NCCL across cards" if shared else
                 "one card a rank over NCCL"))
        return {part: results[0][f"{part}_launches"]
                for part in ("ddp", "zero", "tp")}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _agree(torch, cond, msg):
    """A check every rank takes together: it fails on all ranks if it
    fails on one (so no rank waits in a collective for one that quit)."""
    import torch.distributed as dist

    flag = torch.tensor([1 if cond else 0], device="cuda")
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    check(bool(flag.item()), f"{msg} (this rank: {bool(cond)})")


def _same_on_ranks(torch, tensors):
    """True on every rank when `tensors` (a name -> tensor dict, the same
    names on every rank) are bit-equal to rank 0's."""
    import torch.distributed as dist

    flat = torch.cat([t.detach().reshape(-1).float()
                      for t in tensors.values()])
    theirs = flat.clone()
    dist.broadcast(theirs, src=0)
    same = torch.equal(flat, theirs)
    del flat, theirs
    flag = torch.tensor([1 if same else 0], device="cuda")
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item())


def _rel_l2(torch, got, want):
    num = den = 0.0
    for n, w in want.items():
        w = w.to(got[n].device).float()
        num += (got[n].float() - w).square().sum().item()
        den += w.square().sum().item()
    return (num / den) ** 0.5


def _fresh_peak(torch):
    """Free what nothing references any more and start a new peak count;
    returns the GiB still allocated, the base under the coming peak."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() / 2**30


def ddp_rank_step(torch, kernels, rank, world, work):
    """Part (a) on one rank: the float32 step on its sample of the global
    batch through DistributedDataParallel, against the reference."""
    import torch.distributed as dist

    from multimodal_sam_adapter_torch.parallel import all_reduce_sum
    from multimodal_sam_adapter_torch.parallel import wrap_model

    ref = torch.load(work / "reference.pt", mmap=True, weights_only=True)
    mine = ddp_samples(torch, world)[rank::world]
    torch.cuda.reset_peak_memory_stats()
    one = step_run(torch, kernels, mine[:1], 1, wrap_model)
    loss = (all_reduce_sum(torch.tensor(one["losses"][0], device="cuda"))
            / world).item()
    loss_rel = abs(loss - ref["loss"]) / abs(ref["loss"])
    grad_rel = _rel_l2(torch, one["grads"], ref["grads"])
    # each buffer's max error over its max |value|, + DDP_STATS_ATOL: the
    # JAX init's zero convs leave some norms' batch means at round-off
    stats_rel, worst = max(
        ((one["stats"][n] - w.to("cuda")).abs().max().item()
         / (w.abs().max().item() + DDP_STATS_ATOL / DDP_STATS_RTOL), n)
        for n, w in ref["stats"].items())
    same_grads = _same_on_ranks(torch, one["grads"])
    line(f"ddp rank {rank}", part="a", dtype="f32", loss_mean=f"{loss:.6f}",
         loss_ref=f"{ref['loss']:.6f}", loss_rel_err=f"{loss_rel:.3e}",
         grad_rel_l2=f"{grad_rel:.3e}", bn_stats_rel_err=f"{stats_rel:.3e}",
         bn_stats_worst=worst.replace("backbone.", ""),
         grads_equal_across_ranks=same_grads,
         launches=compact(one["launches"][0]))
    _agree(torch, same_grads, "ddp: gradients differ across ranks")
    _agree(torch, loss_rel <= DDP_LOSS_RTOL
           and grad_rel <= TRAIN_GRAD_REL_F32
           and stats_rel <= DDP_STATS_RTOL,
           f"ddp: rank {rank} vs one process: loss {loss_rel:.3e}, "
           f"gradients {grad_rel:.3e}, statistics {stats_rel:.3e}")
    del one
    torch.cuda.empty_cache()

    # the update, then one micro-step more (no_sync, the optimizer's
    # state in memory): the peak part (c) is held against
    peak = torch.cuda.max_memory_allocated()
    base = _fresh_peak(torch)
    accum = step_run(torch, kernels, mine + mine[:1], DDP_MICRO_STEPS,
                     wrap_model, grads_on=None)
    step_peak = torch.cuda.max_memory_allocated() / 2**30
    param_rel = _rel_l2(torch, accum["params"], ref["params"])
    same_params = _same_on_ranks(torch, accum["params"])
    launches_ok = all(c == PER_MICRO_STEP for c in accum["launches"])
    numel = sum(p.numel() for p in accum["params"].values())
    del accum["params"], ref
    torch.cuda.empty_cache()
    # all-reduces of the gradients' volume (float32), host clock
    buf = torch.ones(numel, device="cuda")
    all_reduce_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        dist.barrier()
        t = time.perf_counter()
        dist.all_reduce(buf)
        torch.cuda.synchronize()
        all_reduce_ms.append(round((time.perf_counter() - t) * 1e3, 1))
    ok_sum = buf[0].item() == world ** 3
    del buf
    peak = max(peak, torch.cuda.max_memory_allocated()) / 2**30
    line(f"ddp rank {rank}", part="a", grad_accum=DDP_MICRO_STEPS,
         updates=1, losses=compact([round(v, 6) for v in accum["losses"]]),
         param_rel_l2=f"{param_rel:.3e}",
         params_equal_across_ranks=same_params,
         micro_step_ms_no_sync_sync_after_update=compact(
             [round(v, 1) for v in accum["ms"]]),
         all_reduce_ms=compact(all_reduce_ms),
         all_reduce_gb=f"{numel * 4 / 1e9:.3f}", peak_mem_gib=f"{peak:.3f}",
         step_peak_mem_gib=f"{step_peak:.3f}", step_base_gib=f"{base:.3f}",
         launches_each_micro_step=launches_ok)
    _agree(torch, same_params and launches_ok and ok_sum
           and param_rel <= TRAIN_GRAD_REL_F32,
           f"ddp: rank {rank} after the update: parameters equal across "
           f"ranks {same_params}, {param_rel:.3e} from one process, "
           f"launches {accum['launches']}")
    return dict(ddp_launches=accum["launches"][0],
                step_ms=[round(v, 1) for v in accum["ms"]],
                all_reduce_ms=all_reduce_ms,
                all_reduce_gb=round(numel * 4 / 1e9, 3),
                peak_gib=round(peak, 3), step_peak_gib=round(step_peak, 3))


def ddp_rank_runner(torch, kernels, rank, world, work, device):
    """Part (b) on one rank: the train entry's runner in bf16, its loader
    shard, grad_accum 2, one epoch with a checkpoint (rank 0 writes) and
    an eval of its val shard with the histograms summed over the ranks;
    then a new runner resumes from the checkpoint."""
    import torch.distributed as dist

    from multimodal_sam_adapter_torch.configs.registry import get_config
    from multimodal_sam_adapter_torch.engine.evaluator import Evaluator
    from multimodal_sam_adapter_torch.parallel import all_reduce_sum
    from multimodal_sam_adapter_torch.tools.train import (build_runner,
                                                          ckpt_meta)

    cfg = get_config("deliver_rgblidar")
    cfg["data"]["grad_accum"] = 2
    cfg["runner"]["max_epochs"] = cfg["optimizer"]["max_epochs"] = 1
    train_ds = RawTrainSamples(DDP_RUNNER_SAMPLES * world, SEED)
    val_ds = DeliverSamples(DDP_VAL_SAMPLES * world, SEED + 1)
    meta = ckpt_meta(cfg, "deliver_rgblidar", train_ds, SEED, False)
    out_dir = work / "runner"
    evals, saved, steps = [], {}, []
    real_run = Evaluator.run

    def recorded_run(self, *args, **kwargs):
        before = dict(kernels.LAUNCHES)
        res = real_run(self, *args, **kwargs)
        evals.append((res, {k: kernels.LAUNCHES[k] - before[k]
                            for k in before}))
        return res

    Evaluator.run = recorded_run

    def runner_of():
        return build_runner(cfg, train_ds, str(out_dir), device=device,
                            seed=SEED, bf16=True, val_ds=val_ds,
                            val_pipeline=None, meta=meta)

    runner = runner_of()
    step, save = runner.train_step, runner._save

    def timed_step(state, batch):
        before = dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = step(state, batch)
        torch.cuda.synchronize()
        steps.append(dict(ms=(time.perf_counter() - t) * 1e3,
                          loss=res["loss"].item(), launches={
                              k: kernels.LAUNCHES[k] - before[k]
                              for k in before}))
        return res

    def timed_save(epoch, tag=None):
        if not saved:
            saved["model"] = _host_copy(torch,
                                        runner.state.model.state_dict())
            saved["optimizer"] = _host_copy(
                torch, runner.state.optimizer.state_dict())
        return save(epoch, tag)

    runner.train_step, runner._save = timed_step, timed_save
    torch.cuda.reset_peak_memory_stats()
    runner.run()
    peak = torch.cuda.max_memory_allocated() / 2**30
    res, eval_launches = evals[0]
    summaries = [None] * world
    dist.all_gather_object(summaries, res["summary"])
    summed = {k: all_reduce_sum(v) for k, v in res["rank_payload"].items()}
    gathered_ok = all(np.array_equal(summed[k], res["payload"][k])
                      for k in summed)
    state = dict(runner.state.model.state_dict())
    same_state = _same_on_ranks(torch, {
        k: v for k, v in state.items() if v.is_floating_point()})
    names = sorted(os.listdir(out_dir / "ckpts"))
    want_names = ["best.pth", f"step_{len(steps)}.pth"]
    launches_ok = all(s["launches"] == PER_MICRO_STEP for s in steps)
    eval_expect = {k: DDP_VAL_SAMPLES * v
                   for k, v in PER_FORWARD.items()}
    line(f"ddp rank {rank}", part="b", dtype="bf16",
         samples=f"{len(steps)} of {len(train_ds)}",
         updates=runner.state.optimizer.updates,
         losses=compact([round(s["loss"], 5) for s in steps]),
         micro_step_ms=compact([round(s["ms"], 1) for s in steps]),
         eval_mIoU=f"{res['summary']['mIoU']:.4f}",
         summaries_equal=all(s == summaries[0] for s in summaries),
         gathered_equals_sum=gathered_ok, state_equal_across_ranks=same_state,
         ckpts=compact(names), eval_launches=compact(eval_launches),
         peak_mem_gib=f"{peak:.3f}")
    _agree(torch, all(s == summaries[0] for s in summaries) and gathered_ok
           and same_state and names == want_names and launches_ok
           and eval_launches == eval_expect
           and len(steps) == DDP_RUNNER_SAMPLES
           and runner.state.optimizer.updates == DDP_RUNNER_SAMPLES // 2
           and all(np.isfinite(s["loss"]) for s in steps),
           f"ddp runner: summaries {summaries}, gathered {gathered_ok}, "
           f"state equal {same_state}, checkpoints {names}, launches "
           f"{[s['launches'] for s in steps]}, eval {eval_launches}")
    runner_ms = [round(s["ms"], 1) for s in steps]
    del runner, step, save, state
    torch.cuda.empty_cache()

    resumed = runner_of()
    resumed.resume(str(out_dir / "ckpts" / want_names[1]))
    same_model = _bit_equal(torch, saved["model"],
                            resumed.state.model.state_dict())
    same_opt = _bit_equal(torch, saved["optimizer"],
                          resumed.state.optimizer.state_dict())
    line(f"ddp rank {rank}", part="b", resumed_from=want_names[1],
         restored_bit_equal=same_model is True and same_opt is True)
    _agree(torch, same_model is True and same_opt is True,
           f"ddp resume: model {same_model}, optimizer {same_opt}")
    Evaluator.run = real_run
    return dict(runner_ms=runner_ms, runner_peak_gib=round(peak, 3))


def ddp_rank_zero(torch, kernels, rank, world, work):
    """Part (c) on one rank: part (a)'s float32 step with the optimizer's
    state sharded over the ranks (parallel/zero.py), against the unsharded
    optimizer's update from the same gradients and against the one
    process; the state gathered on rank 0, saved, and restored."""
    import torch.distributed as dist

    from multimodal_sam_adapter_torch.parallel import wrap_model
    from multimodal_sam_adapter_torch.parallel.zero import shard_optimizer

    ref = torch.load(work / "reference.pt", mmap=True, weights_only=True)
    mine = ddp_samples(torch, world)[rank::world]
    base = _fresh_peak(torch)
    # the gradients of the update on the host: the peak is the step's
    run = step_run(torch, kernels, mine + mine[:1], DDP_MICRO_STEPS,
                   wrap_model, zero=True, keep_state=True, grads_on="cpu")
    peak = torch.cuda.max_memory_allocated() / 2**30
    state = run.pop("state")
    zero = state.optimizer
    state_gib = zero.state_bytes() / 2**30
    param_rel = _rel_l2(torch, run["params"], ref["params"])
    del ref, mine
    same_params = _same_on_ranks(torch, run["params"])
    launches_ok = all(c == PER_MICRO_STEP for c in run["launches"])
    zero_ms = [round(v, 1) for v in run["ms"]]
    zero_launches = run["launches"][0]
    # the unsharded optimizer's update from the gradients ZeRO was handed
    # (the backward's atomics make two runs' gradients differ in the last
    # bits, so the update is held on the same gradients)
    plain = train_state(torch, DDP_MICRO_STEPS)
    for n, p in plain.model.named_parameters():
        p.grad = run["grads"][n].to(p.device)
    plain.optimizer.mini_step = DDP_MICRO_STEPS - 1
    plain.optimizer.step()
    same_update = all(torch.equal(p, run["params"][n])
                      for n, p in plain.model.named_parameters())
    del plain.model, run
    zero.consolidate_state_dict()
    same_state = True
    if rank == 0:
        full, want = zero.state_dict(), plain.optimizer.state_dict()
        same_state = (_bit_equal(torch, full["state"], want["state"])
                      is True and _bit_equal(torch, full["param_groups"],
                                             want["param_groups"]) is True
                      and full["accum"]["updates"] == 1)
        torch.save(dict(model=state.model.state_dict(), optimizer=full,
                        step=state.step), work / "zero.pt")
        del full, want
    dist.barrier()
    del state, zero
    gc.collect()
    torch.cuda.empty_cache()
    # a resume from the gathered state into ZeRO, and into the unsharded
    # optimizer; each state tensor on exactly one rank
    saved = torch.load(work / "zero.pt", mmap=True, weights_only=True)
    resumed = train_state(torch, DDP_MICRO_STEPS)
    resumed.optimizer = shard_optimizer(resumed.optimizer)
    resumed.model.load_state_dict(saved["model"])
    resumed.optimizer.load_state_dict(saved["optimizer"])
    same_model = _bit_equal(torch, saved["model"],
                            resumed.model.state_dict()) is True
    params = resumed.optimizer._params()
    held = torch.tensor([1 if resumed.optimizer.state[p] else 0
                         for p in params], device="cuda")
    dist.all_reduce(held)
    once = bool((held == 1).all().item())
    resumed.optimizer.consolidate_state_dict()
    same_resume = True
    if rank == 0:
        same_resume = _bit_equal(torch, saved["optimizer"],
                                 resumed.optimizer.state_dict()) is True
        plain.optimizer.load_state_dict(saved["optimizer"])
        same_resume &= _bit_equal(torch, saved["optimizer"],
                                  plain.optimizer.state_dict()) is True
    line(f"ddp rank {rank}", part="c", dtype="f32", zero_ranks=world,
         grad_accum=DDP_MICRO_STEPS, updates=1,
         update_equals_unsharded=same_update,
         params_equal_across_ranks=same_params,
         param_rel_l2=f"{param_rel:.3e}",
         gathered_state_equals_unsharded=same_state,
         state_tensors_on_one_rank=once, resume_bit_equal=same_model and (
             same_resume), state_gib=f"{state_gib:.3f}",
         peak_mem_gib=f"{peak:.3f}", base_gib=f"{base:.3f}",
         micro_step_ms_no_sync_sync_after_update=compact(zero_ms))
    del saved, resumed, plain
    gc.collect()
    torch.cuda.empty_cache()
    _agree(torch, same_update and same_params and same_state and once
           and same_model and same_resume and launches_ok
           and param_rel <= TRAIN_GRAD_REL_F32,
           f"zero: rank {rank}: update {same_update}, across ranks "
           f"{same_params}, gathered {same_state}, held once {once}, resume "
           f"{same_model}/{same_resume}, launches {launches_ok}, "
           f"{param_rel:.3e} from one process")
    return dict(zero_state_gib=round(state_gib, 3),
                zero_peak_gib=round(peak, 3), zero_ms=zero_ms,
                zero_launches=zero_launches)


class HeadsSeen:
    """Records the head counts the model hands K1-K4's wrappers, by
    wrapping the modules' references to them (the wrappers still count
    their launches)."""

    def __init__(self):
        import multimodal_sam_adapter_torch.models.sam_vit as vit
        import multimodal_sam_adapter_torch.ops.msda as msda
        from multimodal_sam_adapter_torch.ops.msda_cuda import kernel_name

        # (module, name, position of the head count in the call)
        self.targets = ((vit, "window_attention", 4),
                        (vit, "flash_attention", 4),
                        (msda, "ms_deform_attn", 5))
        self.kernel_name = kernel_name
        self.seen = {}

    def __enter__(self):
        self.real = [getattr(m, name) for m, name, _ in self.targets]
        for (m, name, i), real in zip(self.targets, self.real):
            def record(*args, _real=real, _name=name, _i=i):
                key = (self.kernel_name(len(args[1]))
                       if _name == "ms_deform_attn" else _name)
                self.seen.setdefault(key, set()).add(args[_i])
                return _real(*args)

            setattr(m, name, record)
        return self

    def __exit__(self, *exc):
        for (m, name, _), real in zip(self.targets, self.real):
            setattr(m, name, real)


def ddp_rank_tp(torch, kernels, rank, world):
    """Part (d) on one rank: the flagship forward with tensor parallelism
    over every rank (parallel/tp.py; data 1, model = the ranks) against
    the unsharded kernel-path forward on the same weights: float32 logits,
    bf16 class maps through InferenceEngine.predict('whole_dim'); the
    launches of one forward and the head counts K1-K4 were called with."""
    import copy

    import torch.distributed as dist

    from multimodal_sam_adapter_torch.configs.registry import get_config
    from multimodal_sam_adapter_torch.engine.inference import InferenceEngine
    from multimodal_sam_adapter_torch.models.segmentor import build_segmentor
    from multimodal_sam_adapter_torch.parallel.tp import (make_mesh,
                                                          shard_segmentor_)

    cfg = get_config("deliver_rgblidar")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    model = build_segmentor(cfg["model"], "cuda", generator=g)
    x = torch.randn((1, 1024, 1024, 6), generator=g, device="cuda")
    xb = x.to(torch.bfloat16)

    def timed(engine):
        """The first class map, then TP_REQUESTS forwards' host ms."""
        first, times = engine.predict(xb), []
        for _ in range(TP_REQUESTS):
            torch.cuda.synchronize()
            dist.barrier()
            t = time.perf_counter()
            engine.predict(xb)
            times.append(round((time.perf_counter() - t) * 1e3, 1))
        return first, times

    with torch.no_grad():
        want = model(x)
    want_map, whole_times = timed(InferenceEngine(
        copy.deepcopy(model).to(torch.bfloat16), cfg["test_cfg"]))
    mesh = make_mesh(1, world)
    shard_segmentor_(model, mesh)
    with torch.no_grad(), HeadsSeen() as heads:
        torch.cuda.synchronize()
        kernels.reset_launches()
        mesh.all_reduces = 0
        got = model(x)                            # the main path of (d)
        torch.cuda.synchronize()
        counts = dict(kernels.LAUNCHES)
        reduces = mesh.all_reduces
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    finite = torch.isfinite(got).all().item()
    del got, want
    engine = InferenceEngine(model.to(torch.bfloat16), cfg["test_cfg"])
    pred, times = timed(engine)
    agree = agreement(pred, want_map)
    bb = cfg["model"]["backbone"]
    share = {h: h // world if h % world == 0 else h
             for h in (bb["num_heads"], bb["deform_num_heads"])}
    want_heads = {"window_attention": {share[bb["num_heads"]]},
                  "flash_attention": {share[bb["num_heads"]]},
                  "msda_multi_level": {share[bb["deform_num_heads"]]},
                  "msda_single_level": {share[bb["deform_num_heads"]]}}
    line(f"ddp rank {rank}", part="d", tp=world, dtype="f32",
         logits_max_abs=f"{scale:.4e}", max_abs_err=f"{err:.3e}",
         tol=f"{FORWARD_RTOL_OF_MAX}*max|logits|",
         heads=compact({k: sorted(v) for k, v in heads.seen.items()}),
         all_reduces=reduces, launches=compact(counts))
    line(f"ddp rank {rank}", part="d", tp=world, dtype="bf16",
         class_agreement_with_unsharded=f"{agree:.4f}",
         ms_per_forward=compact(times),
         unsharded_ms_per_forward=compact(whole_times))
    del model, engine
    gc.collect()
    torch.cuda.empty_cache()
    _agree(torch, finite and err <= FORWARD_RTOL_OF_MAX * scale
           and agree >= AGREE_MIN and counts == PER_FORWARD
           and heads.seen == want_heads,
           f"tp: rank {rank}: logits {err:.3e} of {scale:.3e}, class maps "
           f"{agree:.4f}, launches {counts}, heads {heads.seen}")
    return dict(tp_launches=counts, tp_ms=times, tp_whole_ms=whole_times,
                tp_all_reduces=reduces)


def ddp_rank_main(work, backend):
    """One rank of phase 11 (run by phase_ddp with torchrun's
    environment): parts (a) to (d), then its results to
    <work>/rank<r>.json."""
    import torch

    from multimodal_sam_adapter_torch.ops import kernels
    from multimodal_sam_adapter_torch.parallel import (close_distributed,
                                                       init_distributed,
                                                       rank_device)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work = Path(work)
    rank, world = init_distributed(backend)
    device = rank_device()
    torch.cuda.set_device(device)
    line(f"ddp rank {rank}", world=world, backend=backend, device=device,
         card=repr(torch.cuda.get_device_name(device)),
         shares_card_0=backend == "gloo")
    kernels.library()
    try:
        out = ddp_rank_step(torch, kernels, rank, world, work)
        out.update(ddp_rank_runner(torch, kernels, rank, world, work,
                                   device))
        out["peak_gib"] = max(out["peak_gib"], out.pop("runner_peak_gib"))
        out.update(ddp_rank_zero(torch, kernels, rank, world, work))
        out.update(ddp_rank_tp(torch, kernels, rank, world))
        (work / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        close_distributed()


# --------------------------------------------------------------- phase 12

def _scene(rng, gt, palette, noise):
    """A uint8 BGR picture of a label map: each class's palette colour
    (ignored pixels black) plus uniform noise of +-`noise` levels."""
    pal = np.concatenate([np.asarray(palette, np.int16)[:, ::-1],
                          np.zeros((256 - len(palette), 3), np.int16)])
    img = pal[gt] + rng.integers(-noise, noise + 1, gt.shape + (3,))
    return np.clip(img, 0, 255).astype(np.uint8)


def _blocks(rng, hw, classes, block):
    """A (h, w) uint8 label map of `classes` in block x block squares, with
    ~5% of its pixels ignored (255)."""
    h, w = hw
    cells = rng.integers(0, classes, (-(-h // block), -(-w // block)),
                         dtype=np.uint8)
    gt = np.ascontiguousarray(
        np.repeat(np.repeat(cells, block, 0), block, 1)[:h, :w])
    gt[rng.random(hw) < 0.05] = 255
    return gt


def write_file_trees(root, rng):
    """Phase 12 (a): a DeLiVER tree (two 1024^2 samples in each split:
    BGR, 3-channel LiDAR, 25-class labels) and a MUSES tree (one 1920x1080
    clear/day frame, its LiDAR .npz and 19-class labels), the PNGs written
    by the port's writer with the row filters taken in turn. Returns
    {path: array written}."""
    from multimodal_sam_adapter_torch.data import image_io
    from multimodal_sam_adapter_torch.data.datasets import (CITYSCAPES_PALETTE,
                                                            DELIVER_PALETTE)

    written = {}

    def png(path, arr):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        image_io.imwrite(path, arr, filters=FILES_FILTERS)
        written[path] = arr

    deliver = os.path.join(root, "deliver", "samples")
    for stem in FILES_DELIVER_STEMS:
        gt = _blocks(rng, (1024, 1024), 25, 64)
        arrays = {"images": _scene(rng, gt, DELIVER_PALETTE, 12),
                  "lidar": _scene(rng, gt[::-1], DELIVER_PALETTE, 30),
                  "annotations": gt}
        for split in ("test", "training", "validation"):
            for d, arr in arrays.items():
                suffix = {"images": "rgb", "lidar": "lidar",
                          "annotations": "semantic"}[d]
                png(os.path.join(deliver, d, split,
                                 f"{stem}_{suffix}_front.png"), arr)
    muses = os.path.join(root, "muses")
    gt = _blocks(rng, (1080, 1920), 19, 60)
    png(os.path.join(muses, "frame_camera", "test", "clear", "day",
                     f"{FILES_MUSES_RECORD}_frame_camera.png"),
        _scene(rng, gt, CITYSCAPES_PALETTE, 12))
    png(os.path.join(muses, "gt_semantic", "test", "clear", "day",
                     f"{FILES_MUSES_RECORD}_gt_labelTrainIds.png"), gt)
    lidar = os.path.join(muses, "projected_to_rgb", "lidar", "test", "clear",
                         "day")
    os.makedirs(lidar, exist_ok=True)
    np.savez(os.path.join(lidar, f"{FILES_MUSES_RECORD}_lidar.npz"),
             rng.standard_normal((1080, 1920, 3)).astype(np.float32) * 5)
    return written, os.path.join(root, "deliver"), muses


def check_decoded(written):
    """Phase 12 (b): every PNG decodes, through the host core, to the array
    written; the numpy twin unfilters the first FILES_SLAB_ROWS scanlines
    of each file as the core does. Returns (decode ms, encode ms) of a
    1024^2 BGR file (medians of 3)."""
    from multimodal_sam_adapter_torch.data import image_io

    for path, arr in written.items():
        got = image_io.imread(path, "unchanged")
        check(got.dtype == arr.dtype and np.array_equal(got, arr),
              f"files: {path} decodes to another array")
        with open(path, "rb") as f:
            scan, bpp = image_io.png_scanlines(f.read(), path)
        slab = scan[:FILES_SLAB_ROWS]
        check(set(np.unique(scan[:, 0]).tolist()) == set(FILES_FILTERS),
              f"files: {path} does not use every row filter")
        check(np.array_equal(image_io.unfilter_native(slab, bpp),
                             image_io.unfilter_numpy(slab, bpp)),
              f"files: the numpy twin unfilters {path} otherwise")
    path = next(p for p, a in written.items() if a.shape == (1024, 1024, 3))
    dec, enc = [], []
    for _ in range(3):
        t = time.perf_counter()
        image_io.imread(path)
        dec.append(time.perf_counter() - t)
        t = time.perf_counter()
        image_io.encode_png(written[path])
        enc.append(time.perf_counter() - t)
    return _median(dec) * 1e3, _median(enc) * 1e3


class _Recorder:
    """While entered, records every `Evaluator.run` (the evaluator, its
    results, ms a sample) and every `dump_prediction` call (the blend's
    path, raw image and class map)."""

    def __init__(self, torch):
        from multimodal_sam_adapter_torch.engine import evaluator, visualize

        self.torch, self.ev_cls, self.vis = torch, evaluator.Evaluator, (
            visualize)
        self.runs, self.shown = [], {}

    def __enter__(self):
        run, dump, torch = self.ev_cls.run, self.vis.dump_prediction, (
            self.torch)
        self.saved = run, dump

        def recorded_run(ev, *a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = run(ev, *a, **kw)
            torch.cuda.synchronize()
            self.runs.append(dict(ev=ev, res=res, ms=(
                time.perf_counter() - t) * 1e3 / len(ev.dataset)))
            return res

        def recorded_dump(out_dir, cond, case, name, img, pred, *a):
            path = os.path.join(out_dir, "prediction", cond or "all",
                                case or "ordinary", name)
            self.shown[name] = (path, np.asarray(img), np.asarray(pred))
            return dump(out_dir, cond, case, name, img, pred, *a)

        self.ev_cls.run, self.vis.dump_prediction = recorded_run, (
            recorded_dump)
        return self

    def __exit__(self, *exc):
        self.ev_cls.run, self.vis.dump_prediction = self.saved


class _ListDataset:
    """Samples held in memory, with a file dataset's tables."""

    def __init__(self, samples, like):
        self.samples = samples
        for k in ("CLASSES", "PALETTE", "CONDITIONS", "CASES"):
            setattr(self, k, getattr(like, k))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        s = self.samples[i]
        return dict(s, meta=dict(s["meta"]))


def phase_files(torch, kernels, smi):
    """Phase 12: the entries on image files at full width. Returns the
    launches of (c), the eval entry's run from files."""
    import shutil
    import tempfile

    from multimodal_sam_adapter_torch import apis
    from multimodal_sam_adapter_torch.configs.registry import get_config
    from multimodal_sam_adapter_torch.data import TestPipeline, image_io
    from multimodal_sam_adapter_torch.engine.evaluator import (Evaluator,
                                                               _pad_for_model)
    from multimodal_sam_adapter_torch.engine.visualize import show_result
    from multimodal_sam_adapter_torch.models.segmentor import build_segmentor
    from multimodal_sam_adapter_torch.tools import infer_test
    from multimodal_sam_adapter_torch.tools import test as test_tool
    from multimodal_sam_adapter_torch.tools import train as train_tool

    work = tempfile.mkdtemp(prefix="msa_files_")
    try:
        # (a) and (b)
        written, deliver, muses = write_file_trees(
            work, np.random.default_rng(SEED + 12))
        dec_ms, enc_ms = check_decoded(written)

        # (c) tools/test.py on the DeLiVER tree, seed weights in a file
        cfg = get_config("deliver_rgblidar")
        ckpt = os.path.join(work, "deliver_rgblidar_seed.pth")
        model = build_segmentor(cfg["model"], "cuda",
                                generator=torch.Generator(
                                    device="cuda").manual_seed(SEED))
        torch.save(model.state_dict(), ckpt)
        del model
        show = os.path.join(work, "show")
        with _Recorder(torch) as rec:
            kernels.reset_launches()
            out_json = test_tool.main([                # the main path
                "deliver_rgblidar", ckpt, "--data-root", deliver,
                "--show-dir", show, "--out-dir", work])
            counts = dict(kernels.LAUNCHES)
            ev = rec.runs[0]["ev"]
            ds = ev.dataset
            samples = [ds[i] for i in range(len(ds))]
            pipe = TestPipeline(cfg["test_pipeline"],
                                cfg["dataset"]["modalities_ch"])
            t = time.perf_counter()
            for i in range(len(ds)):
                pipe(ds[i])
            pipe_ms = (time.perf_counter() - t) * 1e3 / len(ds)
            # the same engine again, warm and without blends: from the
            # files, then from the decoded samples held in memory
            for data in (ds, _ListDataset(samples, ds)):
                mem = Evaluator(ev.engine, data, ev.num_classes,
                                case_aware=True).run(pipeline=pipe,
                                                     progress_every=0)
        files_res, entry_ms = rec.runs[0]["res"], rec.runs[0]["ms"]
        files_ms, mem_ms = rec.runs[1]["ms"], rec.runs[2]["ms"]
        expect = {k: len(ds) * v for k, v in PER_FORWARD.items()}
        check(counts == expect,
              f"files: test entry launches {counts} != {expect}")
        for key in ("flat", "nested"):
            check(np.array_equal(files_res["payload"][key],
                                 mem["payload"][key]),
                  f"files: the {key} histograms from files differ from "
                  f"the in-memory run's")
        check(os.path.dirname(out_json) == show
              and len(rec.shown) == len(ds),
              f"files: {out_json}, {len(rec.shown)} blends")
        for name, (path, raw, pred) in rec.shown.items():
            check(np.array_equal(image_io.imread(path, "unchanged"),
                                 show_result(raw, pred, ds.PALETTE)),
                  f"files: {path} does not decode to show_result's blend")

        # (f) the single-image API on one file: (c)'s class map
        info = ds.infos[0]
        handle = apis.init_segmentor("deliver_rgblidar", ckpt, bf16=True)
        kernels.reset_launches()
        api_pred = apis.inference_segmentor(handle, info["img"],
                                            info["mod"][0])
        api_counts = dict(kernels.LAUNCHES)
        want = rec.shown[info["stem"] + ".png"][2]
        # the same input with numpy's batch axis (stride 0) in place of
        # torch's: the bf16 class map it gives beside the API's
        arr, _ = apis.inference.prepare_input(handle, info["img"],
                                              info["mod"][0])
        stride0 = handle.engine.predict(torch.from_numpy(arr[None]))[0]
        stride0_agree = float((stride0.numpy() == api_pred).mean())
        check(np.array_equal(api_pred, want) and api_counts == PER_FORWARD,
              f"files: inference_segmentor's class map agrees with the test "
              f"entry's on {(api_pred == want).mean():.6f}, launches "
              f"{api_counts}")
        del handle, ev, mem, rec
        gc.collect()
        torch.cuda.empty_cache()

        # (d) tools/infer_test.py on the MUSES tree, 'slide'
        out = os.path.join(work, "muses_out")
        with _Recorder(torch) as rec:
            kernels.reset_launches()
            infer_test.main(["muses_rgblidar", "random", "--data-root",
                             muses, "--show-dir", out])
            m_counts = dict(kernels.LAUNCHES)
            ev = rec.runs[0]["ev"]
        check(set(rec.runs[0]["res"]) == {"files"}
              and m_counts == PER_FORWARD,
              f"files: infer_test results {set(rec.runs[0]['res'])}, "
              f"launches {m_counts}")
        mcfg = get_config("muses_rgblidar")
        sample = TestPipeline(mcfg["test_pipeline"],
                              mcfg["dataset"]["modalities_ch"])(
            ev.dataset[0])
        img, valid = _pad_for_model(sample["img"])
        pred = ev.engine.predict(torch.from_numpy(img)[None],
                                 valid_hw=valid)[0].numpy()
        sub = os.path.join(out, "labelTrainIds", f"{FILES_MUSES_RECORD}.png")
        got = image_io.imread(sub, "unchanged")
        check(got.shape == (1024, 1820) and np.array_equal(
            got, pred.astype(np.uint8)),
              f"files: {sub} does not decode to the predicted class map")
        del ev, rec
        gc.collect()
        torch.cuda.empty_cache()

        # (e) tools/train.py on the DeLiVER tree: one epoch, one update
        steps = []
        real_build = train_tool.build_runner

        def instrumented(*a, **kw):
            runner = real_build(*a, **kw)
            step = runner.train_step

            def timed_step(state, batch):
                before = dict(kernels.LAUNCHES)
                torch.cuda.synchronize()
                t = time.perf_counter()
                res = step(state, batch)
                torch.cuda.synchronize()
                steps.append(dict(start=t, end=time.perf_counter(),
                                  loss=res["loss"].item(), launches={
                                      k: kernels.LAUNCHES[k] - before[k]
                                      for k in before}))
                return res

            runner.train_step = timed_step
            return runner

        train_tool.build_runner = instrumented
        try:
            kernels.reset_launches()
            runner = train_tool.main([
                "deliver_rgblidar", "--data-root", deliver, "--work-dir",
                os.path.join(work, "train"), "--max-epochs", "1",
                "--cfg-options", "data.grad_accum=2"])
        finally:
            train_tool.build_runner = real_build
        losses = [s["loss"] for s in steps]
        check(len(steps) == 2 and runner.state.optimizer.updates == 1
              and all(np.isfinite(v) for v in losses)
              and all(s["launches"] == PER_MICRO_STEP for s in steps),
              f"files: train entry micro-steps {len(steps)}, updates "
              f"{runner.state.optimizer.updates}, losses {losses}, "
              f"launches {[s['launches'] for s in steps]}")
        del runner
        gc.collect()
        torch.cuda.empty_cache()
        line("files", deliver=f"{len(FILES_DELIVER_STEMS)}x1024x1024 a split",
             muses="1920x1080", pngs=len(written),
             filters=compact(list(FILES_FILTERS)),
             decode_ms_1024=f"{dec_ms:.2f}", encode_ms_1024=f"{enc_ms:.2f}",
             test_pipeline_ms_per_sample=f"{pipe_ms:.2f}",
             eval_ms_per_img_entry=f"{entry_ms:.2f}",
             eval_ms_per_img_files=f"{files_ms:.2f}",
             eval_ms_per_img_memory=f"{mem_ms:.2f}",
             histograms_bit_equal=True, blends=len(ds),
             batch_stride0_agreement=f"{stride0_agree:.6f}",
             launches=compact(counts), api_launches=compact(api_counts),
             infer_test_launches=compact(m_counts),
             train_losses=compact([round(v, 5) for v in losses]),
             train_launches=compact([s["launches"] for s in steps]),
             micro_step_ms=compact([round((s["end"] - s["start"]) * 1e3, 1)
                                    for s in steps]),
             micro_step_ms_file_loader=(
                 f"{(steps[1]['end'] - steps[0]['end']) * 1e3:.1f}"),
             card=repr(smi))
        return counts
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(phases=None):
    """Every phase; with `phases` == ["ddp"], phases 1, 2 and 11 alone
    (the four-card run: phase 11 is what there is to see across cards);
    with ["files"], phases 1, 2 and 12."""
    import torch

    kind, smi = phase_device(torch)
    if phases in (["ddp"], ["files"]):
        from multimodal_sam_adapter_torch.ops import kernels

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        phase_build(kernels)
        (phase_ddp if phases == ["ddp"] else phase_files)(torch, kernels, smi)
        print(json.dumps({"ok": True, "phases": phases, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return
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
    torch.cuda.empty_cache()
    entry_counts = phase_train_entry(torch, kernels, smi)
    gc.collect()
    torch.cuda.empty_cache()
    ddp_counts = phase_ddp(torch, kernels, smi)
    gc.collect()
    torch.cuda.empty_cache()
    files_counts = phase_files(torch, kernels, smi)

    out = []
    for row in rows:
        f32, bf = row.pop("f32"), row.pop("bf16")
        extra = {k: bf[k] for k in ("per_forward_ms", "per_forward_plain_ms")
                 if k in bf}
        if "product_ms" in row:   # K6's yardstick: a key of its own
            extra["product_ms"] = row.pop("product_ms")
        out.append(dict(row, launches=counts[row["name"]],
                        train_launches=train_counts[row["name"]],
                        train_entry_launches=entry_counts[row["name"]],
                        ddp_launches=ddp_counts["ddp"][row["name"]],
                        zero_launches=ddp_counts["zero"][row["name"]],
                        tp_launches=ddp_counts["tp"][row["name"]],
                        files_launches=files_counts[row["name"]],
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
        if sys.argv[1:2] == ["--ddp-rank"]:
            ddp_rank_main(*sys.argv[2:4])
        elif sys.argv[1:2] == ["--phase"] and sys.argv[2:] in (["ddp"],
                                                             ["files"]):
            main(sys.argv[2:])
        elif sys.argv[1:]:
            raise SystemExit(f"usage: {sys.argv[0]} [--phase ddp|files]")
        else:
            main()
    except PhaseError as e:
        print(f"FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
