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
   on the same inputs (float32 and bf16 at the flagship shapes, float32
   at the others too), the yardstick; for K5 its ms per
   forward (each stage's ms times its blocks); for K6 the time of cuDNN's
   conv_transpose2d on its c2 and weight in both dtypes (`product_ms`: the
   product alone, a yardstick, not the same function). K5's delta-only
   mode (training's: no shortcut added) at the four stage shapes, batch 3, against the plain
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
   on the same weights, batch and masks (each one call's host ms to a
   synchronize beside it): in float32 the loss within 1e-3 relative and
   all gradients within 1e-2 relative L2; in bf16 autocast
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
   ranks heads and K3 and K4 with 16 / ranks heads; (e) the float32
   train step with tensor parallelism on a (ranks // 2, 2) mesh
   (parallel/tp.py: the backward's model-group all-reduces, DDP and the
   BatchNorm statistics over the data groups, the optimizer on the
   shards), one 1024^2 sample a data rank, grad_accum 2, one update,
   against this process's step on the same global batch: the data ranks'
   mean loss within 1e-3 relative, the gradients and updated parameters
   within 1e-2 relative L2 as a whole and for each tensor of the split
   modules (the gathered shares and the whole tensors they use), the
   BatchNorm statistics within 1e-3 relative, all equal across the data
   ranks, K1-K4 called with 8 heads, the launches of each micro-step a
   rank those of one process's (K1 40, K2 8, K3 8, K4 12, K5 144, K6 0);
   then one bf16 micro-step, timed, its loss finite; (f) the optimizer's
   memory modes under tensor parallelism on a (2, 2) mesh (four ranks: a
   card each over NCCL, or gloo ranks sharing the card in a launch of
   their own): one float32 update of part (e)'s first global batch with
   the factored second moment, and with it and ZeRO over the data group,
   against this process's factored step (part (e)'s rules), the split
   modules' updates against the unsharded optimizer on the same
   gradients within 1e-4 relative L2, ZeRO's update bit-equal to the
   sharded optimizer's on its own gradients; with a card a rank also
   Adam's run and a bf16 micro-step after each update, for each mode's
   peak and state GiB a rank. Prints each rank's micro-step ms
   with and without no_sync, three all-reduces' ms of the gradient
   volume, peak GiB (the step's beside ZeRO's and TP's), ZeRO's state
   GiB, TP's ms a forward and all-reduces, the TP micro-step's ms, its
   forward, recompute and backward all-reduces and its data group's
   gradient all-reduce GB and ms, beside the card's name and power
   limit. Two ranks sharing one card over gloo are a correctness run,
   not a speed figure.
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

13. m2f: deliver_rgblidar with model.head_type=mask2former (the flagship
   backbone and the Mask2Former head at its defaults: feat 512, 100
   queries, 9 decoder and 6 deformable encoder layers), weights as the
   JAX package initialises them, from the seed. K3 at the pixel
   decoder's shapes (21504 tokens querying their own 3 levels, 8 heads
   of D = 64, and deliver_tiny_m2f's D = 4) against its plain version in
   float32 and bf16, with the bound, `gather_mb` and its Function's
   gradients. (a) The float32 1024^2 forward kernel vs plain: the pixel
   decoder's mask features and three memories within 1e-3 x max|.|, the
   class maps >= 98% equal, the attention-mask entries that differ, the
   launches of one forward (K3 4 + 6 = 10). (b) The model in bf16 answers
   3 requests through InferenceEngine.predict ('whole_dim'): class maps
   >= 98% equal to the plain path's, launches, ms per image, peak GiB.
   (c) One float32 micro-step kernel vs plain on the same weights, batch
   and point draws, the plain path given the kernel path's attention
   masks and Hungarian assignments: loss within 1e-3 relative, gradients
   within 1e-2 relative L2; the assignments and mask bits the plain path
   changes when not given them; launches (K3 8 + 6 = 14). (d) Two bf16
   updates of grad_accum 2: finite losses, every parameter moved (or its
   step below half an ulp), the micro-step's launches, ms, peak GiB,
   device busy ms and idle share, and its Hungarian solves with their
   host ms. (e) tools/test.py with --cfg-options
   model.head_type=mask2former on a DeLiVER tree of two 1024^2 samples a
   split (phase 12's writer): histograms equal to Evaluator.run over the
   same samples in memory; tools/train.py: one epoch of two micro-steps,
   one update, the micro-step's launches.

14. rgb: the RGB-only segmentor, deliver_rgblidar with --cfg-options
   dataset.modalities_ch=[3] dataset.mod_dir=[] dataset.mod_suffix=[]
   model.backbone.modalities_ch=[3] (ViT-Adapter's conv-stem prior of
   widths 48/96/192/192 in place of the twin ConvNeXt and the neck), and
   the standalone SAM encoder. (a) The float32 1024x1024x3 forward,
   weights from the seed, kernel vs plain: logits within 1e-3 x
   max|logits|, K1-K6 at 20 / 4 / 4 / 6 / 0 / 1; 3 bf16 requests, class
   maps >= 98% equal; K6 timed on the operands the conv stem's c1 gives it
   (channels-last) and on the bimodal path's; the served request's device
   busy ms, ms, idle share and peak GiB (utils/profiling.py) beside the
   bimodal SegFormer path's in the same run. (b) One float32 and one bf16
   micro-step (with_cp, drop path and dropout on) kernel vs plain: loss
   1e-3 and gradients 1e-2 relative L2 in float32, bf16 cosine >= 0.98;
   K1-K6 at 40 / 8 / 8 / 12 / 0 / 0; K6 refuses a grad-recording call.
   (c) ImageEncoderViT at 1024^2, depth 24, from a SAM ViT-L checkpoint's
   layout (`image_encoder.` keys beside `neck.*` and a mask decoder key)
   through ingest_sam_pth(standalone=True): float32 tokens kernel vs plain
   within 1e-3 x max|tokens|, bf16 cosine >= 0.999, K1 20 and K2 4, ms a
   forward. (d) tools/test.py with the overrides on a DeLiVER tree without
   its LiDAR directory (phase 12's writer): histograms bit-equal to
   Evaluator.run over the same samples in memory; `load_bin_ann`, `shift`
   and `setr_resize` on samples read from those files (setr_resize's
   resize in the host core equal to its numpy twin); tools/train.py, one
   update of two micro-steps, K1-K6 at 40 / 8 / 8 / 12 / 0 / 0 each.

15. tools: the port's tools and the evidence that it learns. (a)
   tools/make_synth_deliver.py writes the learnable synthetic DeLiVER
   (seed 1, 16 samples a cell: 64 a split, 80^2). (b) tools/train.py
   deliver_tiny --max-epochs 20 --seed 1 trains on it in bf16 on the
   kernel path, evaluated every 4 epochs (`--cfg-options
   evaluation.interval=4`: 5 evaluations, which early stopping's
   patience of 10 cannot cut short): K1-K6 launched exactly as
   deliver_tiny's geometry predicts (640 micro-steps of 4 / 4 / 8 / 12 /
   48 / 0 and 640 eval forwards, two a validation sample, of 2 / 2 / 4 /
   6 / 24 / 1). (c)
   tools/test.py on the best checkpoint on the test split: its mIoU beside
   the JAX package's 52.21 from its entries at the same settings on one
   CPU device (JAX_SYNTH_MIOU), failing below 40; the first and last training
   loss and each evaluation's mIoU. (d) tools/get_flops.py's count of the
   full-width deliver_rgblidar forward at 1024^2 on the card's kernel path
   equal to the `meta` count, 459.05 M parameters, the GFLOPs beside
   XLA's 5029.65, and K1-K6 launched once a forward's worth. (e)
   tools/convert_deliver.py and tools/color_gt.py on a raw-layout tree of
   1042^2 frames this phase writes (labels remapped and coloured as the
   root tools do; files/s). (f) tools/convert_checkpoints.py `sam` on a
   SAM ViT-L layout file and `full` on the trained model in the
   reference's DDP mmcv form: the outputs load strictly through
   `load_state_dict_file('file://...')` and tools/test.py (the same mIoU).
   (a)-(c) run in a child process (`--tools-train`), which the full run
   starts before phase 11 so that it overlaps phases 11-14; phase 15
   waits for it, then runs (d)-(f).

`python3 chip_smoke.py --phase ddp` runs phases 1, 2 and 11 alone (the
four-card run); `--phase tp` phases 1, 2 and phase 11's parts (e) and
(f) alone (the tensor-parallel step and its optimizer, the path that
spans cards); `--phase files`
phases 1, 2 and 12; `--phase m2f` phases 1, 2 and 13; `--phase rgb`
phases 1, 2 and 14; `--phase tools` phases 1, 2 and 15.

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
DDP_TIMEOUT = 900              # seconds for the ranks together
TP_REQUESTS = 3                # timed bf16 TP forwards after a first
# part (e): the train step on a (ranks // 2, TP_TRAIN_MODEL) mesh, one
# 1024^2 sample a data rank, grad_accum DDP_MICRO_STEPS, one update. The
# gradients and parameters are held to TRAIN_GRAD_REL_F32 relative L2 as
# a whole, as part (a) holds DDP's, and so is each tensor of the modules
# tensor parallelism splits: of its own L2 norm, or of TP_REL_FLOOR x the
# whole's RMS x sqrt(its size) where that is larger (a gradient of
# round-off). The replicated modules' tensors one by one move with the
# data split's arithmetic (one sample a rank against the global batch in
# one process): on four ranks the neck's FFRM GroupNorm biases, behind a
# ReLU on a pooled 1x1 map, moved 0.48 under DDP alone on the same split
TP_TRAIN_MODEL = 2
TP_REL_FLOOR = 1e-3
# part (f): the optimizer's memory modes under tensor parallelism on a
# (data 2, model 2) mesh: four ranks, one a card over NCCL, or four gloo
# ranks sharing one card (a correctness run). From part (e)'s weights,
# one float32 update (grad_accum 1) of part (e)'s first global batch
# with the factored second moment, then with it and ZeRO over the data
# group. Held to the one process by part (e)'s rules (the whole gradient
# and update, and the split modules' gradients one by one); the split
# modules' updates one by one, on the gradients the ranks saw
# (gathered), within TP_OPTIM_SAME_GRADS_REL of the unsharded optimizer's
# (the factored moment's first update of a round-off gradient is about
# its sign, so against the one process these tensors move with the
# gradients' last bits: qkv's k bias); ZeRO's update bit-equal to the
# sharded optimizer's without ZeRO on the same gradients. With a card a
# rank, Adam's run first and one bf16 micro-step after each update with
# the state in memory: the peak a rank of the three
TP_OPTIM_MESH = (2, 2)
TP_OPTIM_SAME_GRADS_REL = 1e-4
DDP_PARTS = "abcdef"           # phase 11's parts; `--phase tp` runs "ef"
# phase 12: the DeLiVER samples on file (their conditions and cases route
# the report), the MUSES record, the PNG row filters taken in turn, the
# scanlines the numpy twin unfilters beside the host core
FILES_DELIVER_STEMS = ("sun_test_0", "motionblur_rain_test_1")
FILES_MUSES_RECORD = "REC0001"
FILES_FILTERS = (0, 1, 2, 3, 4)
FILES_SLAB_ROWS = 64
# phase 13: the Mask2Former head (deliver_rgblidar with
# model.head_type=mask2former) adds its pixel decoder's 6 encoder layers to
# K3's launches, a forward and a micro-step (the head is not checkpointed);
# its bf16 updates take grad_accum 2
M2F_ENCODER_LAYERS = 6
PER_M2F_FORWARD = dict(PER_FORWARD, msda_multi_level=(
    PER_FORWARD["msda_multi_level"] + M2F_ENCODER_LAYERS))
PER_M2F_MICRO_STEP = dict(PER_MICRO_STEP, msda_multi_level=(
    PER_MICRO_STEP["msda_multi_level"] + M2F_ENCODER_LAYERS))
M2F_ACCUM = 2
# phase 14: the RGB-only segmentor, deliver_rgblidar under these
# --cfg-options (one modality: ViT-Adapter's conv stem in place of the twin
# ConvNeXt and the neck, so no K5), and the standalone SAM encoder (K1 in
# its 20 windowed blocks, K2 in its 4 global ones)
RGB_ONLY = {"dataset.modalities_ch": "[3]", "dataset.mod_dir": "[]",
            "dataset.mod_suffix": "[]", "model.backbone.modalities_ch": "[3]"}
PER_RGB_FORWARD = dict(PER_FORWARD, convnext_block=0)
PER_RGB_MICRO_STEP = dict(PER_MICRO_STEP, convnext_block=0)
PER_ENCODER_FORWARD = dict({k: 0 for k in PER_FORWARD},
                           window_attention=20, flash_attention=4)
# bf16 tokens of the encoder's kernel path against its plain path
ENCODER_COS_MIN = 0.999
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
# the RGB-only segmentor's: K1-K4's, and the conv stem's first and last
RGB_WATCHED = TRAIN_WATCHED[:-1] + ("backbone.spm.stem.0.weight",
                                    "backbone.spm.conv4.0.weight")

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


def check_library(torch, kc, name, case, tag, label="flagship"):
    """The yardstick: the fastest SDPA backend on the same inputs as one of
    the kernel's cases (its operands built outside the timed calls), and
    how far its output lies from the plain version's."""
    fn, args = case
    ms, backend, out = kc.time_library(name, args)
    want = kc.plain_reference(fn, args)
    # SDPA returns (batch, heads, N, d): heads-pack it as the kernels do
    B, N, C = want.shape
    got = out.transpose(1, 2).reshape(B, N, C)
    err = (got.float() - want.float()).abs().max().item()
    line("kernels", name=name, shape=label, dtype=tag,
         library="scaled_dot_product_attention", backend=backend,
         library_ms=f"{ms:.4f}", library_max_abs_err=f"{err:.3e}")
    return dict(library_ms=ms, library_backend=backend,
                library_max_abs_err=err)


def check_product(kc, case, tag):
    """K6's yardstick: cuDNN's conv_transpose2d on K6's flagship c2 and
    weight, the product and depth-to-space alone (float32 with TF32 off,
    as main sets it)."""
    fn, args = kc.product_case(case[1])
    ms = kc.time_ms(fn, args)
    line("kernels", name="pixel_shuffle_up_bn", dtype=tag,
         product="conv_transpose2d", product_ms=f"{ms:.4f}")
    return dict(product_ms=ms)


class K6Operands:
    """Records the layouts of K6's operands (c2, c1, x1) as the backbone
    hands them over, by wrapping the backbone's reference to the wrapper
    (which still counts its launches)."""

    def __init__(self, keep=False):
        import multimodal_sam_adapter_torch.models.backbone as backbone
        self.module, self.seen, self.keep = backbone, [], keep
        self.first = None

    def __enter__(self):
        real = self.real = self.module.pixel_shuffle_up_bn

        def record(c2, weight, c1, x1, scale, shift):
            self.seen.append({name: dict(
                shape=list(t.shape), strides=list(t.stride()),
                dtype=str(t.dtype).replace("torch.", ""))
                for name, t in (("c2", c2), ("c1", c1), ("x1", x1))})
            if self.keep and self.first is None:
                # the operands as handed over, for timing K6 on them
                self.first = tuple(t.clone() for t in (c2, weight, c1, x1,
                                                       scale, shift))
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
    beside one SDPA call, K6 beside cuDNN's product alone, at the flagship
    shapes in float32 (under the row's `f32`) and bf16, and K1 and K2 in
    float32 at their off-path shapes too."""
    rows = []
    for name, meta in kc.KERNELS.items():
        row = dict(name=name, route="cuda", source=meta["source"],
                   replaces=meta["replaces"], library_ms=None,
                   library_backend=None)
        attention = name in ("window_attention", "flash_attention")
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            checked = []
            for label, on_path, case in kc.cases(name, dtype, SEED):
                res = check_case(torch, kc, name, label, case, dtype, tag)
                if attention and tag == "f32" and not on_path:
                    # float32 K1 / K2 off the main path: SDPA beside them
                    res.update(check_library(torch, kc, name, case, tag,
                                             label))
                checked.append((on_path, res))
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
        row["f32"].update(library_ms=None, library_backend=None)
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            g = torch.Generator(device="cuda").manual_seed(SEED)
            if attention:
                lib = check_library(torch, kc, name,
                                    kc.flagship_case(name, dtype, g), tag)
            elif name == "pixel_shuffle_up_bn":
                lib = check_product(kc, kc.flagship_case(name, dtype, g), tag)
            else:
                continue
            (row["f32"] if tag == "f32" else row).update(lib)
        rows.append(row)
    return rows


def phase_forward(torch, kernels, model, x, expect=PER_FORWARD,
                  phase="forward"):
    """The float32 forward through the kernels (its launches: `expect`)
    against the plain versions. Returns the launches."""
    with torch.no_grad(), K6Operands() as k6:
        kernels.reset_launches()
        got = model(x)
        torch.cuda.synchronize()
        counts = dict(kernels.LAUNCHES)
        with kernels.plain_kernels():
            want = model(x)
    k6.report(phase)
    check(got.shape == (1, 1024, 1024, 25), f"logits shape {got.shape}")
    check(torch.isfinite(got).all().item(), "non-finite float32 logits")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    line(phase, dtype="f32", logits_max_abs=f"{scale:.4e}",
         max_abs_err=f"{err:.3e}", tol=f"{FORWARD_RTOL_OF_MAX}*max|logits|",
         launches=compact(counts))
    check(err <= FORWARD_RTOL_OF_MAX * scale,
          f"{phase}: kernel path and plain path logits disagree")
    check(counts == expect, f"{phase}: launch counts {counts} != {expect}")
    return counts


def agreement(a, b):
    return (a == b).float().mean().item()


def phase_serve(torch, kernels, engine, imgs, per_forward=PER_FORWARD,
                phase="serve"):
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
    k6.report(phase)
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
    expect = {k: REQUESTS * v for k, v in per_forward.items()}
    # steady state: the requests after the first of each path
    ms = sorted(k_times[1:] + k_times2)
    pms = sorted(p_times[1:] + p_times2)
    line(phase, dtype="bf16", requests=REQUESTS,
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


def train_batch(torch, g, classes, channels=6):
    """One 1024^2 micro-batch on the card: a normalised-scale input and
    labels with ~5% ignored (255) pixels."""
    img = torch.randn((1, 1024, 1024, channels), generator=g, device="cuda")
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


def compare_paths(torch, kernels, model, img, gt, tag, dtype, ref=None,
                  watched=TRAIN_WATCHED, expect=PER_MICRO_STEP,
                  phase="train"):
    """One micro-step through the kernels and one through the plain
    versions on the same weights, batch and dropout key. bf16 takes `ref`,
    the float32 plain path's gradients, for the `watched` tensors on which
    bf16 autocast itself moves the gradient further than TRAIN_COS_EACH:
    there the kernel path must be as close to the float32 gradient as the
    plain bf16 path is (within TRAIN_COS_SLACK). The launches must be
    `expect`. Returns (launches, the plain path's gradients)."""
    kernels.reset_launches()
    t0 = time.perf_counter()
    loss_k = micro_step(torch, kernels, model, img, gt, 1, dtype, False)
    torch.cuda.synchronize()
    ms_k = (time.perf_counter() - t0) * 1e3
    counts = dict(kernels.LAUNCHES)
    g_k = grads_of(model)
    t0 = time.perf_counter()
    loss_p = micro_step(torch, kernels, model, img, gt, 1, dtype, True)
    torch.cuda.synchronize()
    ms_p = (time.perf_counter() - t0) * 1e3
    g_p = grads_of(model)
    model.zero_grad(set_to_none=True)
    lk, lp = loss_k.item(), loss_p.item()
    loss_rel = abs(lk - lp) / abs(lp)
    names = list(g_p)
    rel = (sum((g_k[n] - g_p[n]).square().sum().item() for n in names)
           / sum(g_p[n].square().sum().item() for n in names)) ** 0.5
    cos = cosine(g_k, g_p, names)
    each = {n: cosine(g_k, g_p, [n]) for n in watched}
    to_f32 = {}
    if ref is not None:
        to_f32 = {n: (cosine(g_k, ref, [n]), cosine(g_p, ref, [n]))
                  for n in watched}
    short = {n: n.replace("backbone.", "") for n in watched}
    line(phase, dtype=tag, loss_kernel=f"{lk:.6f}", loss_plain=f"{lp:.6f}",
         loss_rel_err=f"{loss_rel:.3e}", grad_rel_l2=f"{rel:.3e}",
         grad_cosine=f"{cos:.6f}", watched_cosine=compact(
             {short[n]: round(v, 5) for n, v in each.items()}),
         finite=all(torch.isfinite(t).all().item() for t in g_k.values()),
         launches=compact(counts), step_ms_kernel=f"{ms_k:.1f}",
         step_ms_plain=f"{ms_p:.1f}")
    if to_f32:
        line(phase, dtype=tag, watched_cosine_to_f32_kernel_plain=compact(
            {short[n]: [round(k, 5), round(p, 5)]
             for n, (k, p) in to_f32.items()}),
             all_cosine_to_f32_kernel_plain=compact(
                 [round(cosine(g_k, ref, names), 5),
                  round(cosine(g_p, ref, names), 5)]))
    check(counts == expect, f"{phase} {tag}: launches {counts} != {expect}")
    check(loss_rel <= TRAIN_LOSS_RTOL[tag],
          f"{phase} {tag}: losses {lk} (kernel) vs {lp} (plain)")
    check(all(torch.isfinite(t).all().item() for t in g_k.values()),
          f"{phase} {tag}: non-finite gradients")
    if dtype is None:
        check(rel <= TRAIN_GRAD_REL_F32,
              f"{phase} f32: gradients {rel:.3e} from plain > "
              f"{TRAIN_GRAD_REL_F32}")
    else:
        check(cos >= TRAIN_COS_ALL, f"{phase} bf16: cosine {cos:.4f} < "
                                    f"{TRAIN_COS_ALL}")
        for n, v in each.items():
            k32, p32 = to_f32[n]
            check(v >= TRAIN_COS_EACH or (p32 < TRAIN_COS_EACH and
                                          k32 >= p32 - TRAIN_COS_SLACK),
                  f"{phase} bf16: {short[n]}: cosine {v:.4f} to the plain "
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


def train_state(torch, accum, factored=False):
    """phase 11's float32 deliver_rgblidar train state: the JAX init from
    SEED, with_cp, drop path and dropout at the config's rates, the
    config's optimizer with grad_accum `accum` (the factored second
    moment with `factored`)."""
    from multimodal_sam_adapter_torch.configs.registry import get_config
    from multimodal_sam_adapter_torch.engine.train import init_train_state

    cfg = get_config("deliver_rgblidar")
    state = init_train_state(cfg["model"], "cuda", seed=SEED, init="jax",
                             optimizer_kwargs=dict(
                                 cfg["optimizer"], grad_accum_steps=accum,
                                 factored_second_moment=factored))
    state.seed = SEED + 1
    return state


def step_run(torch, kernels, samples, accum, wrap, grads_on="cuda",
             zero=False, keep_state=False, factored=False):
    """The float32 train step of `train_state` (OHEM; the factored second
    moment with `factored`) through `make_train_step` on `samples` (a
    list of (img, gt)), the model wrapped by `wrap`, the optimizer's state
    sharded over the ranks with `zero` (parallel/zero.py). Returns the
    losses, the gradients the optimizer saw at the update (copied to
    `grads_on`; None: not kept), the parameters after it, the BatchNorm
    statistics, each micro-step's launches and CUDA-event ms, and with
    `keep_state` the state itself."""
    from multimodal_sam_adapter_torch.engine.train import make_train_step
    from multimodal_sam_adapter_torch.parallel.zero import shard_optimizer

    state = train_state(torch, accum, factored)
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

    env = ddp.rank_env(0, 1, ddp.free_port())
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


def tp_train_reference(torch, kernels, work):
    """Part (e)'s single process: the float32 step on its global batches
    (micro-step i holds the data ranks' samples, one each; grad_accum 2,
    one update), saved to the host for the ranks."""
    data = ddp_ranks(torch) // TP_TRAIN_MODEL
    samples = ddp_samples(torch, data)
    glob = [(torch.cat([img for img, _ in samples[i:i + data]]),
             torch.cat([gt for _, gt in samples[i:i + data]]))
            for i in range(0, len(samples), data)]
    tp = step_run(torch, kernels, glob, DDP_MICRO_STEPS, lambda m: m,
                  grads_on="cpu")
    torch.save(dict(losses=tp["losses"], grads=tp["grads"],
                    params=_host_copy(torch, tp["params"]),
                    stats=_host_copy(torch, tp["stats"])),
               work / "tp_reference.pt")
    line("ddp", reference="1 process, float32, part (e)'s global batch "
         f"{data}x1024x1024x6, grad_accum {DDP_MICRO_STEPS}",
         losses=compact([round(v, 6) for v in tp["losses"]]),
         micro_step_ms=compact([round(v, 1) for v in tp["ms"]]))
    del tp, samples, glob
    torch.cuda.empty_cache()


def tp_optim_reference(torch, kernels, work):
    """Part (f)'s single process: one float32 update (grad_accum 1) with
    the factored second moment of part (e)'s first global batch on a data
    axis of TP_OPTIM_MESH[0] ranks, saved to the host for the ranks."""
    data = TP_OPTIM_MESH[0]
    samples = ddp_samples(torch, data)[:data]
    glob = [(torch.cat([img for img, _ in samples]),
             torch.cat([gt for _, gt in samples]))]
    ref = step_run(torch, kernels, glob, 1, lambda m: m, grads_on="cpu",
                   factored=True)
    torch.save(dict(loss=ref["losses"][0], grads=ref["grads"],
                    params=_host_copy(torch, ref["params"]),
                    stats=_host_copy(torch, ref["stats"])),
               work / "tp_optim_reference.pt")
    line("ddp", reference="1 process, float32, part (f)'s global batch "
         f"{data}x1024x1024x6, factored second moment, one update",
         loss=f"{ref['losses'][0]:.6f}",
         micro_step_ms=compact([round(v, 1) for v in ref["ms"]]))
    del ref, samples, glob
    torch.cuda.empty_cache()


def phase_ddp(torch, kernels, smi, parts=DDP_PARTS):
    """Phase 11: the references in this process, then `ddp_ranks` rank
    processes of this script (gloo sharing card 0 on a one-card machine,
    NCCL with a card each otherwise) run `parts`: (a) the step, (b) the
    runner, (c) the step with ZeRO, (d) the tensor-parallel forward, (e)
    the tensor-parallel step, (f) its optimizer's memory modes (on four
    ranks: gloo sharing the cards where there are fewer). Returns rank 0's launches of one micro-step
    of the step through DistributedDataParallel (`ddp`), of one with ZeRO
    (`zero`), of one TP forward (`tp`) and of one TP micro-step
    (`tp_train`), those of `parts`."""
    import shutil
    import tempfile

    from multimodal_sam_adapter_torch.parallel.ddp import launch_ranks

    work = Path(tempfile.mkdtemp(prefix="msa_ddp_"))
    try:
        if "a" in parts or "c" in parts:
            phase_ddp_reference(torch, kernels, work)
        if "e" in parts:
            tp_train_reference(torch, kernels, work)
        if "f" in parts:
            tp_optim_reference(torch, kernels, work)
        cards = torch.cuda.device_count()
        world = ddp_ranks(torch)
        backend = "nccl" if cards >= world else "gloo"
        # part (f) takes TP_OPTIM_MESH's ranks: in the same launch where
        # there are as many, else a launch of its own
        f_world = TP_OPTIM_MESH[0] * TP_OPTIM_MESH[1]
        launches = [(parts, world, backend)]
        if "f" in parts and world != f_world:
            launches = [(parts.replace("f", ""), world, backend),
                        ("f", f_world, "nccl" if cards >= f_world
                         else "gloo")]
        results = [{} for _ in range(max(w for _, w, _ in launches))]
        for these, n, how in launches:
            if not these:
                continue
            ranks = launch_ranks(
                [sys.executable, str(Path(__file__).resolve()),
                 "--ddp-rank", str(work), how, these], n, DDP_TIMEOUT)
            for rc, log in ranks:
                for ln in (log if rc == 0 else log[-6000:]).splitlines():
                    if ln.startswith(("[ddp", "FAILED")) or rc != 0:
                        print(ln, flush=True)
            codes = [rc for rc, _ in ranks]
            check(None not in codes,
                  f"ddp: the ranks of parts {these} ran past {DDP_TIMEOUT} s")
            check(codes == [0] * n,
                  f"ddp: parts {these}: rank exit codes {codes}")
            for r in range(n):
                results[r].update(json.loads(
                    (work / f"rank{r}_{these}.json").read_text()))
        shared = cards < world
        # printed name <- each rank's result (a list), or rank 0's alone
        each = dict(step_micro_step_ms="step_ms",
                    all_reduce_ms="all_reduce_ms",
                    runner_micro_step_ms="runner_ms",
                    peak_mem_gib="peak_gib", step_peak_gib="step_peak_gib",
                    zero_peak_gib="zero_peak_gib",
                    zero_state_gib="zero_state_gib",
                    zero_micro_step_ms="zero_ms", tp_ms_per_forward="tp_ms",
                    unsharded_ms_per_forward="tp_whole_ms",
                    tp_train_micro_step_ms_f32_f32_bf16="tp_train_ms",
                    tp_train_peak_gib="tp_train_peak_gib",
                    tp_train_state_gib="tp_train_state_gib",
                    tp_train_data_all_reduce_ms="tp_train_all_reduce_ms",
                    tp_optim_peak_gib="tp_optim_peak_gib",
                    tp_optim_state_gib="tp_optim_state_gib",
                    tp_optim_micro_step_ms_f32_bf16="tp_optim_ms")
        first = dict(all_reduce_gb="all_reduce_gb",
                     tp_all_reduces="tp_all_reduces",
                     tp_train_all_reduces_fwd_recompute_bwd=(
                         "tp_train_all_reduces"),
                     tp_train_data_all_reduce_gb="tp_train_all_reduce_gb")
        got = {k: compact([r[v] for r in results if v in r])
               for k, v in each.items() if v in results[0]}
        got.update({k: results[0][v] for k, v in first.items()
                    if v in results[0]})
        if "e" in parts:
            got["tp_train_mesh"] = (f"data{world // TP_TRAIN_MODEL}"
                                    f"xmodel{TP_TRAIN_MODEL}")
        if "f" in parts:
            these, n, how = launches[-1]
            got.update(tp_optim_mesh="data{}xmodel{}".format(*TP_OPTIM_MESH),
                       tp_optim_ranks=n, tp_optim_backend=how)
        line("ddp", ranks=world, backend=backend, cards=cards,
             shared_card=shared, parts=parts, **got, card=repr(smi), note=(
                 "not a speed claim: ranks sharing one card over gloo say "
                 "nothing of NCCL across cards" if shared else
                 "one card a rank over NCCL"))
        return {part: results[0][f"{part}_launches"]
                for part in ("ddp", "zero", "tp", "tp_train")
                if f"{part}_launches" in results[0]}
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


def _same_in_group(torch, tensors, group, src):
    """True on every rank when `tensors` (a name -> tensor dict, the same
    names on every rank of `group`) are bit-equal to those of global rank
    `src`, a member of `group`; every rank of the process group calls it
    (the flag's reduction spans them all)."""
    import torch.distributed as dist

    flat = torch.cat([t.detach().reshape(-1).float()
                      for t in tensors.values()])
    theirs = flat.clone()
    if dist.get_world_size(group) > 1:
        dist.broadcast(theirs, src=src, group=group)
    same = torch.equal(flat, theirs)
    del flat, theirs
    flag = torch.tensor([1 if same else 0], device="cuda")
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item())


def _rel_each(torch, got, want, inside):
    """(relative L2 of the whole, [worst relative L2, its name] among the
    tensors named in `inside`, the same among the others): each tensor's
    error over the larger of its own L2 norm and TP_REL_FLOOR x the whole
    reference's RMS x sqrt(its size)."""
    norms = {n: w.float().norm().item() for n, w in want.items()}
    size = sum(w.numel() for w in want.values())
    rms = (sum(v * v for v in norms.values()) / size) ** 0.5
    num = den = 0.0
    worst = {True: [-1.0, ""], False: [-1.0, ""]}
    for n, w in want.items():
        err = (got[n].float() - w.to(got[n].device).float()).norm().item()
        num += err * err
        den += norms[n] ** 2
        rel = err / max(norms[n], TP_REL_FLOOR * rms * w.numel() ** 0.5)
        if rel > worst[n in inside][0]:
            worst[n in inside] = [rel, n.replace("backbone.", "")]
    return (num / den) ** 0.5, worst[True], worst[False]


def ddp_rank_tp_train(torch, kernels, rank, world, work):
    """Part (e) on one rank: the float32 train step with tensor
    parallelism on a (world // 2, 2) mesh (parallel/tp.py; DDP and the
    BatchNorm statistics over the data group), the rank's data row's
    sample each micro-step, grad_accum DDP_MICRO_STEPS, one update,
    against the one process on the global batch; then one bf16
    micro-step, timed."""
    import torch.distributed as dist

    from multimodal_sam_adapter_torch.configs.registry import get_config
    from multimodal_sam_adapter_torch.engine.train import (init_train_state,
                                                           make_train_step)
    from multimodal_sam_adapter_torch.parallel import (all_reduce_sum,
                                                       wrap_model)
    from multimodal_sam_adapter_torch.parallel.tp import (RowParallelLinear,
                                                          gather_over_model,
                                                          make_mesh,
                                                          sharded_plan)

    data = world // TP_TRAIN_MODEL
    mesh = make_mesh(data, TP_TRAIN_MODEL)
    mine = ddp_samples(torch, data)[mesh.data_rank::data]
    base = _fresh_peak(torch)
    cfg = get_config("deliver_rgblidar")
    state = init_train_state(cfg["model"], "cuda", seed=SEED, init="jax",
                             optimizer_kwargs=dict(
                                 cfg["optimizer"],
                                 grad_accum_steps=DDP_MICRO_STEPS),
                             mesh=mesh)
    state.seed = SEED + 1
    named = dict(state.model.named_parameters())
    plan = sharded_plan(state.model)
    # the split modules' parameters: the shares and the whole ones
    inside = {f"{prefix}.{n}" for prefix, m in state.model.named_modules()
              if any(isinstance(c, RowParallelLinear) for c in m.children())
              for n, _ in m.named_parameters()}
    grads = {}

    def before_update(optimizer, args, kwargs):
        if optimizer.mini_step + 1 == DDP_MICRO_STEPS:
            grads.update({n: p.grad.detach().clone()
                          for n, p in named.items()})

    state.optimizer.register_step_pre_hook(before_update)
    model = wrap_model(state.model, mesh.data_group)
    steps = {dtype: make_train_step(model, state.optimizer, mesh=mesh,
                                    compute_dtype=dtype)
             for dtype in (None, torch.bfloat16)}
    losses, ms, launches, counts = [], [], [], []
    with HeadsSeen() as heads:
        for i, (img, gt) in enumerate(mine + mine[:1]):
            dtype = None if i < DDP_MICRO_STEPS else torch.bfloat16
            torch.cuda.synchronize()
            dist.barrier()
            kernels.reset_launches()
            mesh.reset_counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res = steps[dtype](state, dict(img=img, gt=gt))  # main path
            end.record()
            torch.cuda.synchronize()
            launches.append(dict(kernels.LAUNCHES))
            counts.append([mesh.all_reduces, mesh.recompute_all_reduces,
                           mesh.backward_all_reduces])
            ms.append(round(start.elapsed_time(end), 1))
            losses.append(res["loss"].item())
            if i == DDP_MICRO_STEPS - 1:
                params = {n: p.detach().clone() for n, p in named.items()}
                stats = {n: b.clone() for n, b in
                         state.model.named_buffers()
                         if n.endswith(("running_mean", "running_var"))}
    peak = torch.cuda.max_memory_allocated() / 2**30
    numel = sum(p.numel() for p in named.values())
    state_gib = state.optimizer.state_bytes() / 2**30
    del steps, model, state, named, mine
    gc.collect()
    torch.cuda.empty_cache()

    def whole(tensors):
        return {n: gather_over_model(t, plan[n], mesh) if n in plan else t
                for n, t in tensors.items()}

    ref = torch.load(work / "tp_reference.pt", mmap=True, weights_only=True)
    loss_mean = (all_reduce_sum(torch.tensor(losses[:DDP_MICRO_STEPS],
                                             device="cuda"),
                                mesh.data_group) / data).tolist()
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(loss_mean,
                                                        ref["losses"]))
    mine_grads = grads
    grads = whole(grads)
    grad_rel, grad_in, grad_out = _rel_each(torch, grads, ref["grads"],
                                            inside)
    same = _same_in_group(torch, mine_grads, mesh.data_group,
                          mesh.model_rank)
    del grads, mine_grads
    torch.cuda.empty_cache()
    mine_params = params
    params = whole(params)
    param_rel, param_in, param_out = _rel_each(torch, params,
                                               ref["params"], inside)
    same &= _same_in_group(torch, mine_params, mesh.data_group,
                           mesh.model_rank)
    del params, mine_params
    torch.cuda.empty_cache()
    # the BatchNorm statistics after the float32 micro-steps, as part (a)
    # holds them
    stats_rel, stats_worst = max(
        ((stats[n] - w.to("cuda")).abs().max().item()
         / (w.abs().max().item() + DDP_STATS_ATOL / DDP_STATS_RTOL), n)
        for n, w in ref["stats"].items())
    same &= _same_in_group(torch, stats, mesh.data_group, mesh.model_rank)
    ref_losses = list(ref["losses"])
    del ref, stats
    gc.collect()
    torch.cuda.empty_cache()
    # the data group's all-reduce of this rank's gradient volume
    all_reduce_ms = []
    if data > 1:
        buf = torch.ones(numel, device="cuda")
        for _ in range(3):
            torch.cuda.synchronize()
            dist.barrier()
            t = time.perf_counter()
            dist.all_reduce(buf, group=mesh.data_group)
            torch.cuda.synchronize()
            all_reduce_ms.append(round((time.perf_counter() - t) * 1e3, 1))
        del buf
    bb = cfg["model"]["backbone"]
    want_heads = {k: {bb["num_heads"] // TP_TRAIN_MODEL}
                  for k in ("window_attention", "flash_attention")}
    want_heads.update({k: {bb["deform_num_heads"] // TP_TRAIN_MODEL}
                       for k in ("msda_multi_level", "msda_single_level")})
    launches_ok = all(c == PER_MICRO_STEP for c in launches)
    finite = all(np.isfinite(v) for v in losses)
    line(f"ddp rank {rank}", part="e", dtype="f32",
         mesh=f"data{data}xmodel{TP_TRAIN_MODEL}",
         data_rank=mesh.data_rank, model_rank=mesh.model_rank,
         grad_accum=DDP_MICRO_STEPS, updates=1,
         loss_mean=compact([round(v, 6) for v in loss_mean]),
         loss_ref=compact([round(v, 6) for v in ref_losses]),
         loss_rel_err=f"{loss_rel:.3e}", grad_rel_l2=f"{grad_rel:.3e}",
         grad_worst_split=f"{grad_in[0]:.3e}:{grad_in[1]}",
         grad_worst_replicated=f"{grad_out[0]:.3e}:{grad_out[1]}",
         param_rel_l2=f"{param_rel:.3e}",
         param_worst_split=f"{param_in[0]:.3e}:{param_in[1]}",
         param_worst_replicated=f"{param_out[0]:.3e}:{param_out[1]}",
         bn_stats_rel_err=f"{stats_rel:.3e}",
         bn_stats_worst=stats_worst.replace("backbone.", ""),
         equal_across_data_ranks=same,
         heads=compact({k: sorted(v) for k, v in heads.seen.items()}),
         launches=compact(launches[0]),
         all_reduces_fwd_recompute_bwd=compact(counts))
    line(f"ddp rank {rank}", part="e", micro_step_ms_f32_no_sync_sync=compact(
        ms[:DDP_MICRO_STEPS]), micro_step_ms_bf16_no_sync=ms[-1],
         bf16_loss=f"{losses[-1]:.6f}", peak_mem_gib=f"{peak:.3f}",
         base_gib=f"{base:.3f}", state_gib=f"{state_gib:.3f}",
         data_all_reduce_gb=f"{numel * 4 / 1e9:.3f}",
         data_all_reduce_ms=compact(all_reduce_ms) if all_reduce_ms
         else "none: a data group of one rank")
    _agree(torch, finite and launches_ok and heads.seen == want_heads
           and same and loss_rel <= DDP_LOSS_RTOL
           and stats_rel <= DDP_STATS_RTOL
           and max(grad_rel, param_rel, grad_in[0], param_in[0])
           <= TRAIN_GRAD_REL_F32,
           f"tp train: rank {rank}: loss {loss_rel:.3e}, gradients "
           f"{grad_rel:.3e} (split modules' worst {grad_in}), parameters "
           f"{param_rel:.3e} ({param_in}), statistics {stats_rel:.3e}, "
           f"equal across data ranks {same}, launches "
           f"{launches}, heads {heads.seen}, losses {losses}")
    return dict(tp_train_launches=launches[0], tp_train_ms=ms,
                tp_train_peak_gib=round(peak, 3),
                tp_train_state_gib=round(state_gib, 3),
                tp_train_all_reduces=counts[0],
                tp_train_all_reduce_gb=round(numel * 4 / 1e9, 3),
                tp_train_all_reduce_ms=all_reduce_ms)


def ddp_rank_tp_optim(torch, kernels, rank, world, work):
    """Part (f) on one rank: part (e)'s float32 step on a TP_OPTIM_MESH
    mesh, grad_accum 1, one update of the rank's data row's sample of
    part (e)'s first global batch, with the factored second moment and
    then with it and ZeRO over the data group. The first update against
    the one process, its split modules' updates against the unsharded
    optimizer's on the same gradients; ZeRO's update against the sharded
    optimizer's without ZeRO on the gradients ZeRO was handed (the
    backward's atomics make two runs' gradients differ in the last bits).
    With a card a rank, Adam's run first, and each run then takes one
    bf16 micro-step with its state in memory: the peak a rank of the
    three under one protocol."""
    import torch.distributed as dist

    from multimodal_sam_adapter_torch.configs.registry import get_config
    from multimodal_sam_adapter_torch.engine.optim import LayerDecayAdamW
    from multimodal_sam_adapter_torch.engine.train import (init_train_state,
                                                           make_train_step)
    from multimodal_sam_adapter_torch.parallel import (all_reduce_sum,
                                                       wrap_model)
    from multimodal_sam_adapter_torch.parallel.tp import (RowParallelLinear,
                                                          gather_over_model,
                                                          make_mesh,
                                                          sharded_plan)
    from multimodal_sam_adapter_torch.parallel.zero import shard_optimizer

    mesh = make_mesh(*TP_OPTIM_MESH)
    img, gt = ddp_samples(torch, mesh.data)[mesh.data_rank]
    cfg = get_config("deliver_rgblidar")
    own_card = dist.get_backend() == "nccl"
    modes = (("adam",) if own_card else ()) + ("factored", "factored_zero")
    runs = {}
    for mode in modes:
        base = _fresh_peak(torch)
        state = init_train_state(cfg["model"], "cuda", seed=SEED,
                                 init="jax", optimizer_kwargs=dict(
                                     cfg["optimizer"], grad_accum_steps=1,
                                     factored_second_moment=mode != "adam"),
                                 mesh=mesh)
        state.seed = SEED + 1
        if mode == "factored_zero":
            state.optimizer = shard_optimizer(state.optimizer)
        named = dict(state.model.named_parameters())
        # on the host, so that the peak is the step's
        run = dict(grads={}, before={n: p.detach().cpu()
                                     for n, p in named.items()})

        def before_update(optimizer, args, kwargs):
            if not run["grads"]:
                run["grads"] = {n: p.grad.detach().cpu()
                                for n, p in named.items()}

        state.optimizer.register_step_pre_hook(before_update)
        model = wrap_model(state.model, mesh.data_group)
        ms, losses, launches = [], [], []
        for dtype in (None, torch.bfloat16) if own_card else (None,):
            step = make_train_step(model, state.optimizer, mesh=mesh,
                                   compute_dtype=dtype)
            torch.cuda.synchronize()
            dist.barrier()
            kernels.reset_launches()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res = step(state, dict(img=img, gt=gt))  # main path
            end.record()
            torch.cuda.synchronize()
            launches.append(dict(kernels.LAUNCHES))
            ms.append(round(start.elapsed_time(end), 1))
            losses.append(res["loss"].item())
            if dtype is None:
                run["params"] = {n: p.detach().cpu()
                                 for n, p in named.items()}
                run["stats"] = {n: b.clone() for n, b in
                                state.model.named_buffers()
                                if n.endswith(("running_mean",
                                               "running_var"))}
        run.update(peak=torch.cuda.max_memory_allocated() / 2**30,
                   base=base, ms=ms, losses=losses, launches=launches,
                   state_gib=state.optimizer.state_bytes() / 2**30,
                   plan=sharded_plan(state.model),
                   marks={n: (p.tp_split, p.tp_mesh) for n, p in
                          named.items() if getattr(p, "tp_split", None)},
                   inside={f"{prefix}.{n}" for prefix, m in
                           state.model.named_modules()
                           if any(isinstance(c, RowParallelLinear)
                                  for c in m.children())
                           for n, _ in m.named_parameters()},
                   groups=[dict(g, params=[]) for g in
                           state.optimizer.param_groups],
                   optimizer=(state.optimizer.schedule,
                              state.optimizer.betas, state.optimizer.eps))
        if mode == "adam":     # its numbers only: part (e) holds the step
            run = {k: run[k] for k in ("peak", "base", "ms", "losses",
                                       "launches", "state_gib")}
        runs[mode] = run
        del state, model, step, named, res
        gc.collect()
        torch.cuda.empty_cache()

    run, zero = runs["factored"], runs["factored_zero"]
    plan, inside = run["plan"], run["inside"]
    schedule, betas, eps = run["optimizer"]

    def whole(n, t):
        t = t.to("cuda")
        return gather_over_model(t, plan[n], mesh) if n in plan else t

    ref = torch.load(work / "tp_optim_reference.pt", mmap=True,
                     weights_only=True)
    loss = (all_reduce_sum(torch.tensor(run["losses"][0], device="cuda"),
                           mesh.data_group) / mesh.data).item()
    loss_rel = abs(loss - ref["loss"]) / abs(ref["loss"])
    grad_rel, grad_in, _ = _rel_each(
        torch, {n: whole(n, g) for n, g in run["grads"].items()},
        ref["grads"], inside)
    param_rel = _rel_l2(torch, {n: whole(n, p) for n, p in
                                run["params"].items()}, ref["params"])
    zero_rel = _rel_l2(torch, {n: whole(n, p) for n, p in
                               zero["params"].items()}, ref["params"])
    stats_rel = max((run["stats"][n] - w.to("cuda")).abs().max().item()
                    / (w.abs().max().item() + DDP_STATS_ATOL
                       / DDP_STATS_RTOL) for n, w in ref["stats"].items())
    ref_loss = ref["loss"]
    del ref
    gc.collect()
    # the split modules' updates, tensor by tensor, against the unsharded
    # optimizer's (the same group, schedule and settings) on the whole
    # tensors and the gathered gradients
    group_of = {n: g for g in run["groups"] for n in g["names"]}
    same_worst = [-1.0, ""]
    for n in sorted(inside):
        w0 = torch.nn.Parameter(whole(n, run["before"][n]))
        w0.grad = whole(n, run["grads"][n])
        start = w0.detach().clone()
        g = group_of[n]
        LayerDecayAdamW([dict(params=[w0], names=[n], lr_scale=g["lr_scale"],
                              weight_decay=g["weight_decay"])], schedule,
                        betas, eps, factored_second_moment=True).step()
        got = whole(n, run["params"][n])
        rel = ((got - w0.detach()).norm()
               / (w0.detach() - start).norm().clamp_min(1e-30)).item()
        if rel > same_worst[0]:
            same_worst = [rel, n.replace("backbone.", "")]
        del w0, start, got
    # ZeRO's update against the sharded optimizer's without ZeRO on the
    # shares ZeRO's run started from and the gradients it was handed
    shares = {}
    for n, p in zero["before"].items():
        shares[n] = torch.nn.Parameter(p.to("cuda"))
        if n in zero["marks"]:
            shares[n].tp_split, shares[n].tp_mesh = zero["marks"][n]
        shares[n].grad = zero["grads"][n].to("cuda")
    LayerDecayAdamW([dict(g, params=[shares[n] for n in g["names"]])
                     for g in zero["groups"]], schedule, betas, eps,
                    factored_second_moment=True).step()
    zero_equal = all(torch.equal(shares[n].detach().cpu(), p)
                     for n, p in zero["params"].items())
    del shares
    gc.collect()
    torch.cuda.empty_cache()
    same = _same_in_group(torch, {n: p.to("cuda") for n, p in
                                  run["params"].items()},
                          mesh.data_group, mesh.model_rank)
    same &= _same_in_group(torch, {n: p.to("cuda") for n, p in
                                   zero["params"].items()},
                           mesh.data_group, mesh.model_rank)
    launches_ok = all(c == PER_MICRO_STEP for r in runs.values()
                      for c in r["launches"])
    finite = all(np.isfinite(v) for r in runs.values()
                 for v in r["losses"])
    peaks = {m: round(r["peak"], 3) for m, r in runs.items()}
    states = {m: round(r["state_gib"], 3) for m, r in runs.items()}
    line(f"ddp rank {rank}", part="f", dtype="f32",
         mesh="data{}xmodel{}".format(*TP_OPTIM_MESH),
         data_rank=mesh.data_rank, model_rank=mesh.model_rank,
         modes=",".join(modes), loss_mean=f"{loss:.6f}",
         loss_ref=f"{ref_loss:.6f}", loss_rel_err=f"{loss_rel:.3e}",
         grad_rel_l2=f"{grad_rel:.3e}",
         grad_worst_split=f"{grad_in[0]:.3e}:{grad_in[1]}",
         param_rel_l2=f"{param_rel:.3e}",
         zero_param_rel_l2=f"{zero_rel:.3e}",
         split_update_vs_unsharded_optimizer=(
             f"{same_worst[0]:.3e}:{same_worst[1]}"),
         bn_stats_rel_err=f"{stats_rel:.3e}",
         equal_across_data_ranks=same,
         zero_update_bit_equal_on_its_gradients=zero_equal,
         launches=compact(run["launches"][0]))
    line(f"ddp rank {rank}", part="f", peak_mem_gib=compact(peaks),
         state_gib=compact(states),
         base_gib=compact({m: round(r["base"], 3)
                           for m, r in runs.items()}),
         micro_step_ms_f32_bf16=compact({m: r["ms"]
                                         for m, r in runs.items()}),
         losses=compact({m: [round(v, 6) for v in r["losses"]]
                         for m, r in runs.items()}))
    _agree(torch, finite and launches_ok and same and zero_equal
           and loss_rel <= DDP_LOSS_RTOL and stats_rel <= DDP_STATS_RTOL
           and max(grad_rel, param_rel, zero_rel, grad_in[0])
           <= TRAIN_GRAD_REL_F32
           and same_worst[0] <= TP_OPTIM_SAME_GRADS_REL,
           f"tp optim: rank {rank}: loss {loss_rel:.3e}, gradients "
           f"{grad_rel:.3e} (split modules' worst {grad_in}), parameters "
           f"{param_rel:.3e} (ZeRO {zero_rel:.3e}), split updates vs the "
           f"unsharded optimizer {same_worst}, statistics {stats_rel:.3e}, "
           f"equal across data ranks {same}, ZeRO bit-equal {zero_equal}, "
           f"launches {[r['launches'] for r in runs.values()]}")
    return dict(tp_optim_launches=run["launches"][0],
                tp_optim_ms={m: r["ms"] for m, r in runs.items()},
                tp_optim_peak_gib=peaks, tp_optim_state_gib=states)


def ddp_rank_main(work, backend, parts=DDP_PARTS):
    """One rank of phase 11 (run by phase_ddp with torchrun's
    environment): `parts` of (a) to (f), then its results to
    <work>/rank<r>_<parts>.json."""
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
        out = {}
        if "a" in parts:
            out.update(ddp_rank_step(torch, kernels, rank, world, work))
        if "b" in parts:
            out.update(ddp_rank_runner(torch, kernels, rank, world, work,
                                       device))
            out["peak_gib"] = max(out.get("peak_gib", 0),
                                  out.pop("runner_peak_gib"))
        if "c" in parts:
            out.update(ddp_rank_zero(torch, kernels, rank, world, work))
        if "d" in parts:
            out.update(ddp_rank_tp(torch, kernels, rank, world))
        if "e" in parts:
            out.update(ddp_rank_tp_train(torch, kernels, rank, world, work))
        if "f" in parts:
            out.update(ddp_rank_tp_optim(torch, kernels, rank, world, work))
        (work / f"rank{rank}_{parts}.json").write_text(json.dumps(out))
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


def _png_writer(written):
    """png(path, arr): the port's writer (row filters FILES_FILTERS in
    turn), each array kept in `written` under its path."""
    from multimodal_sam_adapter_torch.data import image_io

    def png(path, arr):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        image_io.imwrite(path, arr, filters=FILES_FILTERS)
        written[path] = arr

    return png


def write_deliver_tree(root, rng, png, aux=True):
    """A DeLiVER tree under root/deliver: the FILES_DELIVER_STEMS 1024^2
    samples in each split (BGR, 3-channel LiDAR unless not `aux`, 25-class
    labels with 5% ignored). Returns its root."""
    from multimodal_sam_adapter_torch.data.datasets import DELIVER_PALETTE

    deliver = os.path.join(root, "deliver", "samples")
    for stem in FILES_DELIVER_STEMS:
        gt = _blocks(rng, (1024, 1024), 25, 64)
        arrays = {"images": _scene(rng, gt, DELIVER_PALETTE, 12),
                  "lidar": _scene(rng, gt[::-1], DELIVER_PALETTE, 30),
                  "annotations": gt}
        if not aux:
            del arrays["lidar"]
        for split in ("test", "training", "validation"):
            for d, arr in arrays.items():
                suffix = {"images": "rgb", "lidar": "lidar",
                          "annotations": "semantic"}[d]
                png(os.path.join(deliver, d, split,
                                 f"{stem}_{suffix}_front.png"), arr)
    return os.path.dirname(deliver)


def write_file_trees(root, rng):
    """Phase 12 (a): a DeLiVER tree (two 1024^2 samples in each split:
    BGR, 3-channel LiDAR, 25-class labels) and a MUSES tree (one 1920x1080
    clear/day frame, its LiDAR .npz and 19-class labels), the PNGs written
    by the port's writer with the row filters taken in turn. Returns
    {path: array written}."""
    from multimodal_sam_adapter_torch.data.datasets import CITYSCAPES_PALETTE

    written = {}
    png = _png_writer(written)
    deliver = write_deliver_tree(root, rng, png)
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
    return written, deliver, muses


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


def stride0_layouts(torch, model, arr):
    """Where a bf16 B = 1 input whose batch axis has numpy's stride 0
    (`arr[None]`) parts from the same input with torch's strides
    (`torch.from_numpy(arr)[None]`): each one's strides on the card, and
    whether its NCHW view is channels-last (what cuDNN's layout choice
    reads); then the first convolutions the input meets, the twin's RGB
    and auxiliary stems and the ViT patch embed, on each: their outputs'
    strides and the largest difference of the two outputs, and K5's
    operand after the stem's LayerNorm (its strides, equal or not)."""
    bb = model.backbone
    tw = bb.spm.twin_conv
    convs = {"rgb_stem": (tw.downsample_layers_x[0][0], slice(0, 3)),
             "aux_stem": (tw.downsample_layers_y[0][0], slice(3, None)),
             "patch_embed": (bb.patch_embed.proj, slice(0, 3))}
    seen = {}
    with torch.inference_mode():
        for name, t in (("stride0", torch.from_numpy(arr[None])),
                        ("torch", torch.from_numpy(arr)[None])):
            x = t.to(device="cuda", dtype=torch.bfloat16)
            view = x.permute(0, 3, 1, 2)
            outs = {k: conv(view[:, ch]) for k, (conv, ch) in convs.items()}
            ln = tw.downsample_layers_x[0][1]
            k5_in = torch.nn.functional.layer_norm(
                outs["rgb_stem"].permute(0, 2, 3, 1), ln.weight.shape,
                ln.weight, ln.bias, ln.eps).contiguous()
            seen[name] = dict(x=x, outs=outs, k5_in=k5_in)
    rep = {name: dict(strides=list(d["x"].stride()),
                      channels_last=d["x"].permute(0, 3, 1, 2).is_contiguous(
                          memory_format=torch.channels_last),
                      out_strides={k: list(v.stride())
                                   for k, v in d["outs"].items()},
                      k5_in_strides=list(d["k5_in"].stride()))
           for name, d in seen.items()}
    a, b = seen["stride0"], seen["torch"]
    rep["max_abs_diff"] = {k: (a["outs"][k].float() - b["outs"][k].float())
                           .abs().max().item() for k in convs}
    rep["k5_in_max_abs_diff"] = (a["k5_in"].float() - b["k5_in"].float()
                                 ).abs().max().item()
    return rep


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
        stride0_convs = stride0_layouts(torch, handle.model, arr)
        line("files", stride0_inputs=compact(stride0_convs))
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


def m2f_config():
    """deliver_rgblidar with model.head_type=mask2former: the flagship
    backbone and the Mask2Former head at its defaults (feat 512, 100
    queries, 9 decoder and 6 encoder layers), as the entries build it
    from `--cfg-options model.head_type=mask2former`."""
    from multimodal_sam_adapter_torch.configs.registry import (
        apply_overrides, get_config)

    return apply_overrides(get_config("deliver_rgblidar"),
                           {"model.head_type": "mask2former"})


def check_k3_pixel_decoder(torch, kc):
    """K3 at the pixel decoder's shapes (`kc.MSDA_PIXEL_DECODER`) in
    float32 and bf16 against its plain version, and its Function's
    gradients against the plain autodiff there. Returns {dtype tag: [case
    results]}."""
    name = "msda_multi_level"
    out = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        out[tag] = []
        for label, kw in kc.MSDA_PIXEL_DECODER:
            g = torch.Generator(device="cuda").manual_seed(SEED)
            case = kc.msda_encoder_case(dtype, g, **kw)
            res = check_case(torch, kc, name, label, case, dtype, tag)
            res["gather_mb"] = kc.msda_gather_bytes(case[1]) / 1e6
            g = torch.Generator(device="cuda").manual_seed(SEED)
            fres = kc.function_check(*kc.msda_encoder_case(dtype, g, **kw),
                                     g)
            tol = kc.GRAD_TOLERANCES[dtype]
            line("kernels", name=name, shape=label, dtype=tag,
                 gather_mb=f"{res['gather_mb']:.1f}",
                 grad_recording_call=fres["function"],
                 same_output=fres["same_output"],
                 grad_rel_err=f"{fres['grad_rel_err']:.3e}", tol=tol)
            check(fres["same_output"] and fres["grad_rel_err"] <= tol
                  and str(fres["function"]).endswith("FunctionBackward"),
                  f"K3 {label} {tag}: the Function's output or gradients "
                  f"off the plain version's: {fres}")
            out[tag].append(res)
    return out


def _rel_l2_of(a, b, names):
    return (sum((a[n] - b[n]).square().sum().item() for n in names)
            / sum(b[n].square().sum().item() for n in names)) ** 0.5


def _differing(a, b):
    """(entries that differ, entries) over two lists of tensors."""
    return (sum(int((x != y).sum().item()) for x, y in zip(a, b)),
            sum(x.numel() for x in a))


def m2f_forward(torch, kernels, model, x):
    """(a): the float32 forward through the kernels and through the plain
    versions; the pixel decoder's outputs, the class maps, the attention
    masks. Returns the launches of one forward."""
    head = model.decode_head
    outs = []
    hook = head.pixel_decoder.register_forward_hook(
        lambda m, a, out: outs.append([out[0], *out[1]]))
    try:
        with torch.no_grad():
            kernels.reset_launches()
            got = model(x)                         # the main path
            torch.cuda.synchronize()
            counts = dict(kernels.LAUNCHES)
            masks_k = head.record["attn_masks"]
            with kernels.plain_kernels():
                want = model(x)
            masks_p = head.record["attn_masks"]
    finally:
        hook.remove()
    check(got.shape == (1, 1024, 1024, 25), f"m2f logits shape {got.shape}")
    check(torch.isfinite(got).all().item(), "m2f: non-finite logits")
    errs = {}
    for label, k, p in zip(("mask_features", "memory_32", "memory_16",
                            "memory_8"), *outs):
        scale = p.abs().max().item()
        errs[label] = ((k - p).abs().max().item(), scale)
    agree = agreement(got.argmax(-1), want.argmax(-1))
    flips, bits = _differing(masks_k, masks_p)
    logit_err = (got - want).abs().max().item()
    line("m2f", part="a", dtype="f32", config="deliver_rgblidar+mask2former",
         encoder_layers=len(head.pixel_decoder.encoder.layers),
         decoder_layers=len(head.transformer_decoder.layers),
         queries=head.num_queries,
         pixel_decoder_err_over_max=compact(
             {k: float(f"{e / s:.3e}") for k, (e, s) in errs.items()}),
         tol=f"{FORWARD_RTOL_OF_MAX}*max|.|",
         logits_max_abs_err=f"{logit_err:.3e}",
         logits_max_abs=f"{want.abs().max().item():.4e}",
         class_agreement_with_plain=f"{agree:.6f}",
         attn_mask_entries_differing=f"{flips}/{bits}",
         attn_mask_share_differing=f"{flips / bits:.3e}",
         launches=compact(counts))
    for label, (e, s) in errs.items():
        check(e <= FORWARD_RTOL_OF_MAX * s, f"m2f: {label} of the kernel "
              f"and plain paths differ by {e:.3e} > {FORWARD_RTOL_OF_MAX} x "
              f"{s:.3e}")
    check(agree >= AGREE_MIN, f"m2f: float32 class maps agree on "
                              f"{agree:.4f} < {AGREE_MIN}")
    check(counts == PER_M2F_FORWARD,
          f"m2f: launch counts {counts} != {PER_M2F_FORWARD}")
    return counts


def m2f_compare_step(torch, kernels, model, img, gt):
    """(c): one float32 micro-step through the kernels, then through the
    plain versions given the kernel path's attention masks and
    assignments (the thresholds' and the argmin's round-off apart), and
    once more unpinned to count what they would have changed."""
    from multimodal_sam_adapter_torch.models.mask2former import matching

    head = model.decode_head
    kernels.reset_launches()
    matching.SOLVES.update(calls=0, images=0)
    loss_k = micro_step(torch, kernels, model, img, gt, 1, None, False)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    solves = dict(matching.SOLVES)
    g_k = grads_of(model)
    rec_k = {k: list(v) for k, v in head.record.items()}
    loss_u = micro_step(torch, kernels, model, img, gt, 1, None, True)
    rec_u = {k: list(v) for k, v in head.record.items()}
    head.pinned = rec_k
    try:
        loss_p = micro_step(torch, kernels, model, img, gt, 1, None, True)
    finally:
        head.pinned = None
    g_p = grads_of(model)
    model.zero_grad(set_to_none=True)
    lk, lp, lu = loss_k.item(), loss_p.item(), loss_u.item()
    names = list(g_p)
    rel = _rel_l2_of(g_k, g_p, names)
    head_rel = _rel_l2_of(g_k, g_p, [n for n in names
                                     if n.startswith("decode_head.")])
    loss_rel = abs(lk - lp) / abs(lp)
    a_diff, a_all = _differing(rec_u["assign"], rec_k["assign"])
    m_diff, m_all = _differing(rec_u["attn_masks"], rec_k["attn_masks"])
    line("m2f", part="c", dtype="f32", loss_kernel=f"{lk:.6f}",
         loss_plain=f"{lp:.6f}", loss_rel_err=f"{loss_rel:.3e}",
         grad_rel_l2=f"{rel:.3e}", head_grad_rel_l2=f"{head_rel:.3e}",
         unpinned_loss_plain=f"{lu:.6f}",
         unpinned_assignments_differing=f"{a_diff}/{a_all}",
         unpinned_attn_mask_bits_differing=f"{m_diff}/{m_all}",
         solves=int(solves["calls"]), launches=compact(counts))
    check(counts == PER_M2F_MICRO_STEP,
          f"m2f f32: launches {counts} != {PER_M2F_MICRO_STEP}")
    check(all(torch.isfinite(t).all().item() for t in g_k.values()),
          "m2f f32: non-finite gradients")
    check(loss_rel <= TRAIN_LOSS_RTOL["f32"],
          f"m2f f32: losses {lk} (kernel) vs {lp} (plain)")
    check(rel <= TRAIN_GRAD_REL_F32,
          f"m2f f32: gradients {rel:.3e} from plain > {TRAIN_GRAD_REL_F32}")
    return counts


def m2f_updates(torch, kernels, state, smi, g, classes):
    """(d): two bf16 updates of grad_accum M2F_ACCUM through the kernels,
    then one micro-step profiled."""
    from multimodal_sam_adapter_torch.engine.train import make_train_step
    from multimodal_sam_adapter_torch.models.mask2former import matching
    from multimodal_sam_adapter_torch.utils.profiling import profile_calls

    model = state.model
    step = make_train_step(model, state.optimizer,
                           compute_dtype=torch.bfloat16)
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    losses, times, updated, solves = [], [], [], []
    for i in range(2 * M2F_ACCUM):
        img, gt = train_batch(torch, g, classes)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        kernels.reset_launches()
        matching.SOLVES.update(calls=0, images=0, copy_ms=0.0, solve_ms=0.0)
        start.record()
        out = step(state, dict(img=img, gt=gt))
        end.record()
        torch.cuda.synchronize()
        check(dict(kernels.LAUNCHES) == PER_M2F_MICRO_STEP,
              f"m2f micro-step {i}: launches {dict(kernels.LAUNCHES)}")
        times.append(start.elapsed_time(end))
        losses.append(out["loss"].item())
        updated.append(out["updated"])
        solves.append(dict(matching.SOLVES))
    peak = torch.cuda.max_memory_allocated()
    unchanged = [n for n, p in model.named_parameters()
                 if torch.equal(p, params0[n])]
    rounded = [n for n in unchanged if unchanged_by_rounding(
        torch, state.optimizer, model.get_parameter(n))]
    accum_ms = sorted(t for t, u in zip(times[1:], updated[1:]) if not u)

    img, gt = train_batch(torch, g, classes)
    res = profile_calls(lambda: micro_step(
        torch, kernels, model, img, gt, 2, torch.bfloat16, False), 1,
        Path(__file__).resolve().parent / "build" / "profiles"
        / "m2f_micro_step.json", repeats=3)
    model.zero_grad(set_to_none=True)
    fams = list(res["family_ms"].items())[:6]
    line("m2f", part="d", dtype="bf16", micro_steps=len(losses),
         grad_accum=M2F_ACCUM, updates=state.optimizer.updates,
         losses=compact([round(v, 5) for v in losses]),
         first_micro_step_ms=f"{times[0]:.1f}",
         micro_step_ms=f"{_median(accum_ms or times[1:]):.1f}",
         micro_step_ms_all=compact([round(t, 1) for t in times]),
         peak_mem_gib=f"{peak / 2**30:.3f}",
         hungarian_solves_per_micro_step=int(solves[-1]["calls"]),
         hungarian_images_per_micro_step=int(solves[-1]["images"]),
         hungarian_copy_ms=compact([round(s["copy_ms"], 2) for s in solves]),
         hungarian_solve_ms=compact([round(s["solve_ms"], 2)
                                     for s in solves]),
         busy_ms=f"{res['busy_ms']:.2f}",
         unprofiled_ms=f"{res['unprofiled_ms']:.2f}",
         idle_share=f"{res['idle_share']:.3f}",
         top_families_ms=compact({k: round(v, 2) for k, v in fams}),
         unchanged_params=compact(unchanged),
         unchanged_by_rounding=len(rounded), card=repr(smi))
    check(all(np.isfinite(v) for v in losses), f"m2f: losses {losses}")
    check(updated == [(i + 1) % M2F_ACCUM == 0
                      for i in range(2 * M2F_ACCUM)]
          and state.optimizer.updates == 2, f"m2f: updates at {updated}")
    check(unchanged == rounded, "m2f: parameters unchanged whose step "
          f"exceeds half an ulp: {sorted(set(unchanged) - set(rounded))}")


def m2f_entries(torch, kernels, smi):
    """(e): tools/test.py and tools/train.py with --cfg-options
    model.head_type=mask2former on a DeLiVER tree of two 1024^2 samples a
    split (phase 12's writer). Returns the test entry's launches."""
    import shutil
    import tempfile

    from multimodal_sam_adapter_torch.configs.registry import get_config
    from multimodal_sam_adapter_torch.data import TestPipeline
    from multimodal_sam_adapter_torch.engine.evaluator import Evaluator
    from multimodal_sam_adapter_torch.tools import test as test_tool
    from multimodal_sam_adapter_torch.tools import train as train_tool

    work = tempfile.mkdtemp(prefix="msa_m2f_")
    opts = ["--cfg-options", "model.head_type=mask2former"]
    try:
        deliver = write_deliver_tree(work, np.random.default_rng(SEED + 13),
                                     _png_writer({}))
        with _Recorder(torch) as rec:
            kernels.reset_launches()
            test_tool.main(["deliver_rgblidar", "random", "--data-root",
                            deliver, "--out-dir", work] + opts)
            counts = dict(kernels.LAUNCHES)
            ev = rec.runs[0]["ev"]
            cfg = get_config("deliver_rgblidar")
            pipe = TestPipeline(cfg["test_pipeline"],
                                cfg["dataset"]["modalities_ch"])
            samples = [ev.dataset[i] for i in range(len(ev.dataset))]
            mem = Evaluator(ev.engine, _ListDataset(samples, ev.dataset),
                            ev.num_classes, case_aware=True).run(
                pipeline=pipe, progress_every=0)
        res, entry_ms = rec.runs[0]["res"], rec.runs[0]["ms"]
        n = len(ev.dataset)
        expect = {k: n * v for k, v in PER_M2F_FORWARD.items()}
        check(counts == expect, f"m2f: test entry launches {counts} != "
                                f"{expect}")
        check(type(ev.engine.model.decode_head).__name__ ==
              "Mask2FormerHead", "m2f: the test entry built another head")
        for key in ("flat", "nested"):
            check(np.array_equal(res["payload"][key], mem["payload"][key]),
                  f"m2f: the entry's {key} histograms differ from the "
                  f"in-memory Evaluator's")
        del ev, rec, mem
        gc.collect()
        torch.cuda.empty_cache()

        steps = []
        real_build = train_tool.build_runner

        def instrumented(*a, **kw):
            runner = real_build(*a, **kw)
            step = runner.train_step

            def counted_step(state, batch):
                before = dict(kernels.LAUNCHES)
                res = step(state, batch)
                steps.append(dict(loss=res["loss"].item(), launches={
                    k: kernels.LAUNCHES[k] - before[k] for k in before}))
                return res

            runner.train_step = counted_step
            return runner

        train_tool.build_runner = instrumented
        try:
            kernels.reset_launches()
            runner = train_tool.main([
                "deliver_rgblidar", "--data-root", deliver, "--work-dir",
                os.path.join(work, "train"), "--max-epochs", "1"]
                + opts + ["data.grad_accum=2"])
        finally:
            train_tool.build_runner = real_build
        losses = [s["loss"] for s in steps]
        check(type(runner.state.model.decode_head).__name__ ==
              "Mask2FormerHead" and len(steps) == 2
              and runner.state.optimizer.updates == 1
              and all(np.isfinite(v) for v in losses)
              and all(s["launches"] == PER_M2F_MICRO_STEP for s in steps),
              f"m2f: train entry micro-steps {len(steps)}, updates "
              f"{runner.state.optimizer.updates}, losses {losses}, "
              f"launches {[s['launches'] for s in steps]}")
        line("m2f", part="e", samples=n, histograms_bit_equal=True,
             eval_ms_per_img_entry=f"{entry_ms:.2f}",
             test_launches=compact(counts),
             train_losses=compact([round(v, 5) for v in losses]),
             train_launches=compact([s["launches"] for s in steps]),
             card=repr(smi))
        del runner
        gc.collect()
        torch.cuda.empty_cache()
        return counts
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_m2f(torch, kernels, smi, kc):
    """Phase 13: the Mask2Former head at full width. Returns the launches
    of one float32 forward and of one float32 micro-step, and K3's checks
    at the pixel decoder's shapes."""
    from multimodal_sam_adapter_torch.engine.inference import InferenceEngine
    from multimodal_sam_adapter_torch.engine.train import init_train_state
    from multimodal_sam_adapter_torch.models.segmentor import build_segmentor

    k3 = check_k3_pixel_decoder(torch, kc)
    cfg = m2f_config()
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    model = build_segmentor(cfg["model"], "cuda", generator=g, init="jax")
    imgs = [torch.randn((1, 1024, 1024, 6), generator=g, device="cuda")
            for _ in range(REQUESTS)]
    fwd = m2f_forward(torch, kernels, model, imgs[0])
    model = model.to(torch.bfloat16)
    phase_serve(torch, kernels, InferenceEngine(model, cfg["test_cfg"]),
                [x.to(torch.bfloat16) for x in imgs], PER_M2F_FORWARD, "m2f")
    del model, imgs
    gc.collect()
    torch.cuda.empty_cache()

    state = init_train_state(
        cfg["model"], "cuda", seed=SEED,
        optimizer_kwargs=dict(cfg["optimizer"], grad_accum_steps=M2F_ACCUM),
        init="jax")
    classes = cfg["model"]["num_classes"]
    img, gt = train_batch(torch, g, classes)
    step = m2f_compare_step(torch, kernels, state.model, img, gt)
    m2f_updates(torch, kernels, state, smi, g, classes)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    m2f_entries(torch, kernels, smi)
    return fwd, step, k3


def rgb_config():
    """deliver_rgblidar with the RGB-only overrides (RGB_ONLY): one
    modality, so the conv-stem prior (widths 48/96/192/192) in place of
    the twin ConvNeXt and the neck, as the entries build it from
    `--cfg-options`."""
    from multimodal_sam_adapter_torch.configs.registry import (
        apply_overrides, get_config)

    return apply_overrides(get_config("deliver_rgblidar"), dict(RGB_ONLY))


def check_k6_operands(torch, kc, k6, tag):
    """K6 on the operands the backbone handed it in a served forward
    (their layouts as they came) against its plain version, timed in
    turns with it (check_case). Returns K6's ms there."""
    from multimodal_sam_adapter_torch.ops.pixel_shuffle import (
        pixel_shuffle_up_bn)

    args = k6.first
    line("rgb", kernel="pixel_shuffle_up_bn", operands=tag,
         c1_channels_last=args[2].is_contiguous(
             memory_format=torch.channels_last))
    return check_case(torch, kc, "pixel_shuffle_up_bn", tag + "_operands",
                      (pixel_shuffle_up_bn, args), args[0].dtype,
                      "bf16")["ms"]


def serve_profile(torch, engine, img, name):
    """Device busy, unprofiled ms and idle share of one served request
    (utils/profiling.py, 3 calls, 3 repeats), and the peak memory."""
    from multimodal_sam_adapter_torch.utils.profiling import profile_calls

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = profile_calls(lambda: engine.predict(img), 3,
                        Path(__file__).resolve().parent / "build"
                        / "profiles" / f"{name}_serve.json", repeats=3)
    fams = list(res["family_ms"].items())[:5]
    return dict(busy_ms=res["busy_ms"], ms=res["unprofiled_ms"],
                idle_share=res["idle_share"],
                launches=res["kernel_launches"],
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                top_families_ms={k: round(v, 3) for k, v in fams})


def rgb_serve(torch, kernels, kc, cfg, g, smi):
    """(a): the float32 forward kernel vs plain, three bf16 requests, K6
    on the operands the conv stem's c1 gives it, and the served request's
    busy, idle share and peak beside the bimodal (SegFormer) path's in
    this run. Returns the launches of one forward."""
    from multimodal_sam_adapter_torch.configs.registry import get_config
    from multimodal_sam_adapter_torch.engine.inference import InferenceEngine
    from multimodal_sam_adapter_torch.models.adapter import (
        SpatialPriorModule)
    from multimodal_sam_adapter_torch.models.segmentor import build_segmentor

    model = build_segmentor(cfg["model"], "cuda", generator=g)
    spm = model.backbone.spm
    check(type(spm) is SpatialPriorModule
          and spm.stem[0].out_channels == 48
          and spm.conv4[0].out_channels == 192,
          "rgb: not the conv-stem prior of conv_inplane 48")
    imgs = [torch.randn((1, 1024, 1024, 3), generator=g, device="cuda")
            for _ in range(REQUESTS)]
    counts = phase_forward(torch, kernels, model, imgs[0], PER_RGB_FORWARD,
                           "rgb")
    model = model.to(torch.bfloat16)
    engine = InferenceEngine(model, cfg["test_cfg"])
    bf = [x.to(torch.bfloat16) for x in imgs]
    phase_serve(torch, kernels, engine, bf, PER_RGB_FORWARD, "rgb")
    with torch.inference_mode(), K6Operands(keep=True) as k6:
        engine.predict(bf[0])
    k6_ms = check_k6_operands(torch, kc, k6, "rgb_only")
    prof = {"rgb_only": serve_profile(torch, engine, bf[0], "rgb_only")}
    del model, engine
    gc.collect()
    torch.cuda.empty_cache()
    bimodal = get_config("deliver_rgblidar")
    model = _build_bf16(torch, build_segmentor, bimodal["model"], g)
    engine = InferenceEngine(model, bimodal["test_cfg"])
    x6 = torch.randn((1, 1024, 1024, 6), generator=g, device="cuda").to(
        torch.bfloat16)
    with torch.inference_mode(), K6Operands(keep=True) as k6:
        engine.predict(x6)
    k6_ms_bimodal = check_k6_operands(torch, kc, k6, "bimodal")
    prof["bimodal"] = serve_profile(torch, engine, x6, "bimodal")
    del model, engine
    gc.collect()
    torch.cuda.empty_cache()
    line("rgb", part="a", dtype="bf16", served=compact(
        {k: {n: (round(v, 3) if isinstance(v, float) else v)
             for n, v in d.items()} for k, d in prof.items()}),
         k6_ms=compact({"rgb_only": round(k6_ms, 4),
                        "bimodal": round(k6_ms_bimodal, 4)}),
         card=repr(smi))
    return counts, prof, k6_ms


def rgb_train(torch, kernels, cfg, g):
    """(b): one float32 and one bf16 micro-step through the kernels
    against the plain versions (the config's train mode: with_cp, drop
    path and dropout on). Returns the launches of one micro-step."""
    from multimodal_sam_adapter_torch.engine.train import init_train_state

    state = init_train_state(
        cfg["model"], "cuda", seed=SEED,
        optimizer_kwargs=dict(cfg["optimizer"],
                              grad_accum_steps=cfg["data"]["grad_accum"]),
        init="random")
    model = state.model
    check(model.training and model.backbone.with_cp,
          "rgb: not the config's train mode")
    img, gt = train_batch(torch, g, cfg["model"]["num_classes"], channels=3)
    _, ref = compare_paths(torch, kernels, model, img, gt, "f32", None,
                           watched=RGB_WATCHED, expect=PER_RGB_MICRO_STEP,
                           phase="rgb")
    counts, _ = compare_paths(torch, kernels, model, img, gt, "bf16",
                              torch.bfloat16, ref, watched=RGB_WATCHED,
                              expect=PER_RGB_MICRO_STEP, phase="rgb")
    del ref, state, model
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def sam_checkpoint(torch, path, g):
    """A SAM ViT-L checkpoint's layout, as SAM's own file holds it: the
    encoder under `image_encoder.` (24 blocks, width 1024, 16 heads,
    windows of 14, global blocks 5/11/17/23) beside its `neck.*` and a
    mask decoder key. Weights N(0, 0.05), norm gains 1 + N(0, 0.05), from
    the seed; saved to `path`."""
    from multimodal_sam_adapter_torch.models.sam_vit import ImageEncoderViT

    with torch.device("meta"):
        enc = ImageEncoderViT()
    sd = {}
    for name, p in enc.state_dict().items():
        t = torch.randn(p.shape, generator=g, device="cuda") * 0.05
        if name.endswith(("norm1.weight", "norm2.weight")):
            t += 1.0
        sd["image_encoder." + name] = t.cpu()
    for key, shape in (("0.weight", (256, 1024, 1, 1)), ("1.weight", (256,)),
                       ("1.bias", (256,)), ("2.weight", (256, 256, 3, 3)),
                       ("3.weight", (256,)), ("3.bias", (256,))):
        sd[f"image_encoder.neck.{key}"] = torch.zeros(shape)
    sd["mask_decoder.iou_token.weight"] = torch.zeros(1, 256)
    torch.save(sd, path)
    return len(sd)


def encoder_phase(torch, kernels, kc, g, work):
    """(c): ImageEncoderViT at 1024^2, depth 24, from a SAM-layout file
    through ingest_sam_pth(standalone=True): float32 kernel vs plain,
    bf16 kernel vs plain (cosine), the launches of one forward, ms a
    forward (CUDA events). Returns the launches."""
    from multimodal_sam_adapter_torch.engine.checkpoint import ingest_sam_pth
    from multimodal_sam_adapter_torch.models.sam_vit import ImageEncoderViT

    path = os.path.join(work, "sam_vit_l.pth")
    n_keys = sam_checkpoint(torch, path, g)
    with torch.device("meta"):
        enc = ImageEncoderViT()
    enc = enc.to_empty(device="cuda")
    enc.load_state_dict(ingest_sam_pth(path, standalone=True), strict=True)
    enc.eval()
    x = torch.randn((1, 3, 1024, 1024), generator=g, device="cuda")

    def run(model, inp):
        with torch.inference_mode():
            return model(inp)

    kernels.reset_launches()
    got, Hp, Wp = run(enc, x)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    with kernels.plain_kernels():
        want, _, _ = run(enc, x)
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    ms = {}
    for tag in ("f32", "bf16"):
        if tag == "bf16":
            enc = enc.to(torch.bfloat16)
            x = x.to(torch.bfloat16)
            got_b, _, _ = run(enc, x)
            with kernels.plain_kernels():
                want_b, _, _ = run(enc, x)
            a, b = got_b.float().flatten(), want_b.float().flatten()
            cos = (a @ b / (a.norm() * b.norm())).item()
            cos32 = (a @ want.flatten() / (a.norm() * want.norm())).item()
        ms[tag] = kc.time_ms(lambda: run(enc, x), (), iters=5, warmup=1)
        with kernels.plain_kernels():
            ms["plain_" + tag] = kc.time_ms(lambda: run(enc, x), (),
                                              iters=5, warmup=1)
    line("rgb", part="c", model="ImageEncoderViT", input="1x3x1024x1024",
         grid=f"{Hp}x{Wp}", ckpt_keys=n_keys, tokens=list(got.shape),
         f32_max_abs_err=f"{err:.3e}", tokens_max_abs=f"{scale:.4e}",
         tol=f"{FORWARD_RTOL_OF_MAX}*max|tokens|",
         bf16_cosine_to_plain=f"{cos:.6f}",
         bf16_cosine_to_f32=f"{cos32:.6f}",
         ms=compact({k: round(v, 3) for k, v in ms.items()}),
         launches=compact(counts))
    check(tuple(got.shape) == (1, 4096, 1024) and (Hp, Wp) == (64, 64),
          f"encoder: tokens {tuple(got.shape)}, grid {Hp}x{Wp}")
    check(torch.isfinite(got).all().item(), "encoder: non-finite tokens")
    check(err <= FORWARD_RTOL_OF_MAX * scale,
          "encoder: kernel and plain tokens disagree")
    check(cos >= ENCODER_COS_MIN, f"encoder: bf16 cosine {cos:.6f} < "
                                  f"{ENCODER_COS_MIN}")
    check(counts == PER_ENCODER_FORWARD,
          f"encoder: launches {counts} != {PER_ENCODER_FORWARD}")
    del enc
    gc.collect()
    torch.cuda.empty_cache()
    return counts, ms


def rgb_entries(torch, kernels, smi, work):
    """(d): tools/test.py and one update of tools/train.py with the
    RGB-only overrides on a DeLiVER tree without its LiDAR directory
    (phase 12's writer); the unused transforms on samples read from those
    files. Returns the test entry's launches."""
    from multimodal_sam_adapter_torch.data import pipelines as pl
    from multimodal_sam_adapter_torch.data import TestPipeline
    from multimodal_sam_adapter_torch.engine.evaluator import Evaluator
    from multimodal_sam_adapter_torch.tools import test as test_tool
    from multimodal_sam_adapter_torch.tools import train as train_tool

    opts = ["--cfg-options", *(f"{k}={v}" for k, v in RGB_ONLY.items())]
    deliver = write_deliver_tree(work, np.random.default_rng(SEED + 14),
                                 _png_writer({}), aux=False)
    check(not os.path.exists(os.path.join(deliver, "samples", "lidar")),
          "rgb: the tree has a LiDAR directory")
    cfg = rgb_config()
    with _Recorder(torch) as rec:
        kernels.reset_launches()
        test_tool.main(["deliver_rgblidar", "random", "--data-root",
                        deliver, "--out-dir", work] + opts)
        counts = dict(kernels.LAUNCHES)
        ev = rec.runs[0]["ev"]
        pipe = TestPipeline(cfg["test_pipeline"],
                            cfg["dataset"]["modalities_ch"])
        samples = [ev.dataset[i] for i in range(len(ev.dataset))]
        mem = Evaluator(ev.engine, _ListDataset(samples, ev.dataset),
                        ev.num_classes, case_aware=True).run(
            pipeline=pipe, progress_every=0)
    res, entry_ms = rec.runs[0]["res"], rec.runs[0]["ms"]
    n = len(ev.dataset)
    expect = {k: n * v for k, v in PER_RGB_FORWARD.items()}
    check(counts == expect, f"rgb: test entry launches {counts} != {expect}")
    check(samples[0]["img"].shape == (1024, 1024, 3)
          and ev.dataset.mod_dirs == [], "rgb: the entry read an auxiliary "
                                         "modality")
    for key in ("flat", "nested"):
        check(np.array_equal(res["payload"][key], mem["payload"][key]),
              f"rgb: the entry's {key} histograms differ from the "
              f"in-memory Evaluator's")

    # the unused transforms on a sample read from the files
    info = ev.dataset.infos[0]
    t = time.perf_counter()
    ann = pl.load_bin_ann(info["ann"])
    bin_ms = (time.perf_counter() - t) * 1e3
    want = pl.load_annotation(info["ann"])
    want[want == 255] = 1
    check(np.array_equal(ann, want), "rgb: load_bin_ann of a gray label "
                                     "file is not its labels, 255 -> 1")
    rng = np.random.default_rng(SEED)
    t = time.perf_counter()
    shifted = pl.shift(dict(samples[0]), rng, 32.5, 17.25, prob=1.0,
                       seg_pad_val=255)
    shift_ms = (time.perf_counter() - t) * 1e3
    check(shifted["img"].shape == samples[0]["img"].shape
          and shifted["gt"].dtype == np.uint8
          and np.isfinite(shifted["img"]).all()
          and set(np.unique(shifted["gt"])) <= set(np.unique(
              samples[0]["gt"])) | {255}, "rgb: shift's sample")
    setr = {}
    for native in (True, False):
        t = time.perf_counter()
        setr[native] = pl.setr_resize(
            dict(samples[0]), np.random.default_rng(SEED),
            img_scale=(2048, 512), ratio_range=(0.5, 2.0),
            crop_size=512, setr_multi_scale=True, native=native)
        setr[f"ms_{native}"] = (time.perf_counter() - t) * 1e3
    check(np.array_equal(setr[True]["img"], setr[False]["img"])
          and np.array_equal(setr[True]["gt"], setr[False]["gt"]),
          "rgb: setr_resize in the host core differs from its numpy twin")
    del ev, rec, mem
    gc.collect()
    torch.cuda.empty_cache()

    steps = []
    real_build = train_tool.build_runner

    def instrumented(*a, **kw):
        runner = real_build(*a, **kw)
        step = runner.train_step

        def counted_step(state, batch):
            before = dict(kernels.LAUNCHES)
            out = step(state, batch)
            steps.append(dict(loss=out["loss"].item(), launches={
                k: kernels.LAUNCHES[k] - before[k] for k in before}))
            return out

        runner.train_step = counted_step
        return runner

    train_tool.build_runner = instrumented
    try:
        kernels.reset_launches()
        runner = train_tool.main([
            "deliver_rgblidar", "--data-root", deliver, "--work-dir",
            os.path.join(work, "train"), "--max-epochs", "1"]
            + opts + ["data.grad_accum=2"])
    finally:
        train_tool.build_runner = real_build
    losses = [s["loss"] for s in steps]
    check(len(steps) == 2 and runner.state.optimizer.updates == 1
          and all(np.isfinite(v) for v in losses)
          and all(s["launches"] == PER_RGB_MICRO_STEP for s in steps),
          f"rgb: train entry micro-steps {len(steps)}, updates "
          f"{runner.state.optimizer.updates}, losses {losses}, launches "
          f"{[s['launches'] for s in steps]}")
    line("rgb", part="d", samples=n, histograms_bit_equal=True,
         eval_ms_per_img_entry=f"{entry_ms:.2f}",
         test_launches=compact(counts),
         load_bin_ann_ms=f"{bin_ms:.2f}", shift_ms=f"{shift_ms:.2f}",
         setr_resize_ms=compact({"core": round(setr["ms_True"], 2),
                                 "numpy": round(setr["ms_False"], 2)}),
         setr_shape=list(setr[True]["img"].shape),
         train_losses=compact([round(v, 5) for v in losses]),
         train_launches=compact([s["launches"] for s in steps]),
         card=repr(smi))
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_rgb(torch, kernels, smi, kc):
    """Phase 14: the RGB-only segmentor at full width and the standalone
    SAM encoder. Returns the launches of one forward, one micro-step and
    one encoder forward, the served profiles and K6's ms on the RGB-only
    operands."""
    import shutil
    import tempfile

    cfg = rgb_config()
    g = torch.Generator(device="cuda").manual_seed(SEED + 14)
    check_autograd(torch, kc, "pixel_shuffle_up_bn")
    fwd, prof, k6_ms = rgb_serve(torch, kernels, kc, cfg, g, smi)
    step = rgb_train(torch, kernels, cfg, g)
    work = tempfile.mkdtemp(prefix="msa_rgb_")
    try:
        enc, enc_ms = encoder_phase(torch, kernels, kc, g, work)
        rgb_entries(torch, kernels, smi, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return dict(forward=fwd, micro_step=step, encoder=enc, encoder_ms=enc_ms,
                served=prof, k6_ms=k6_ms)


# --------------------------------------------------------------- phase 15

# the learnable synthetic DeLiVER of tools/make_synth_deliver.py (seed 1,
# 16 samples a cell: 64 a split) and deliver_tiny trained on it for 20
# epochs, half the 40 of the JAX package's artifact
# eval_single_scale_20260819_103412 (~0.4 untrained), whose best epoch is
# the 7th on the card and in JAX: 40 epochs took 730-934 s on an H100's
# host beside phases 11-14, and set the whole run's end past its 1200 s
# limit; evaluated every TOOLS_EVAL_INTERVAL epochs: 5 evaluations, so
# early stopping (patience 10 evaluations) cannot end the run before its
# 20 epochs. JAX_SYNTH_MIOU: the JAX package's root
# train.py and test.py at these settings (bf16, --seed 1, 40 epochs,
# evaluation.interval=4) on one CPU device, its batch the config's 2:
# test mIoU of the best checkpoint (epoch 7); the artifact's 44.35 is
# not what that entry gives today (PERF.md §6)
TOOLS_SEED, TOOLS_PER_CELL, TOOLS_EPOCHS = 1, 16, 20
TOOLS_EVAL_INTERVAL = 4
JAX_SYNTH_MIOU = 52.21
MIN_SYNTH_MIOU = 40.0
# deliver_tiny's launches: an eval forward (K1 in its 2 windowed blocks,
# K2 in its 2 global ones, 4 injectors, 4 + 2 extractors, 2 x 12 ConvNeXt
# blocks, the f1 assembly); a micro-step runs the forward and the with_cp
# recompute of each checkpointed region, K6 never
PER_TINY_FORWARD = {"window_attention": 2, "flash_attention": 2,
                    "msda_multi_level": 4, "msda_single_level": 6,
                    "convnext_block": 24, "pixel_shuffle_up_bn": 1}
PER_TINY_STEP = dict({k: 2 * v for k, v in PER_TINY_FORWARD.items()},
                     pixel_shuffle_up_bn=0)
# forwards an evaluated sample: the synthetic labels are 80^2 and
# deliver_tiny's `whole_dim` predicts 64^2, so the evaluator runs each
# sample again at the label's size (as the JAX package's evaluator does)
TOOLS_EVAL_FORWARDS = 2
# XLA's cost analysis of the JAX flagship forward (bf16, 1024^2, batch 1)
# and its parameters, from the root tools/get_flops.py
JAX_FLAGSHIP_GFLOPS = 5029.65
FLAGSHIP_PARAMS_M = "459.05"
# (e): raw DeLiVER frames at the dataset's 1042^2, 2 cases x 3 splits x 2
RAW_SIDE, RAW_CASES, RAW_FRAMES = 1042, ("cloud", "night"), 2
# the convergence run took 754.6 s of phase 15's 830 s alone on an H100
# (PR 15): the limit of the wait for it
TOOLS_TRAIN_TIMEOUT = 1000


def tools_launches(steps, evals, val):
    """K1-K6 launches of a deliver_tiny train entry run on the synthetic
    DeLiVER: `steps` micro-steps and `evals` evaluations of `val`
    samples."""
    forwards = evals * val * TOOLS_EVAL_FORWARDS
    return {k: steps * PER_TINY_STEP[k] + forwards * PER_TINY_FORWARD[k]
            for k in PER_TINY_FORWARD}


def tools_convergence(torch, kernels, smi, work):
    """(a)-(c): the synthetic tree, 20 bf16 epochs of tools/train.py on
    the kernel path, tools/test.py on the best checkpoint. Returns the
    run's launches, the best checkpoint, the tree and the test mIoU."""
    from multimodal_sam_adapter_torch.tools import make_synth_deliver
    from multimodal_sam_adapter_torch.tools import test as test_tool
    from multimodal_sam_adapter_torch.tools import train as train_tool

    data = os.path.join(work, "synth")
    t = time.perf_counter()
    n = make_synth_deliver.write(data, TOOLS_PER_CELL, TOOLS_SEED)
    line("tools", part="synth", samples=n,
         seconds=f"{time.perf_counter() - t:.2f}")
    per_split = n // 3
    cfg_batch = 2            # deliver_tiny's samples_per_gpu
    kernels.reset_launches()
    t = time.perf_counter()
    runner = train_tool.main([
        "deliver_tiny", "--data-root", data, "--work-dir",
        os.path.join(work, "train"), "--max-epochs", str(TOOLS_EPOCHS),
        "--seed", str(TOOLS_SEED), "--cfg-options",
        f"evaluation.interval={TOOLS_EVAL_INTERVAL}",
        "log_config.interval=32"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    counts = dict(kernels.LAUNCHES)
    evals = TOOLS_EPOCHS // TOOLS_EVAL_INTERVAL
    steps = TOOLS_EPOCHS * (per_split // cfg_batch)
    expect = tools_launches(steps, evals, per_split)
    check(counts == expect, f"tools: train launches {counts} != {expect}")
    check(runner.state.step == steps, f"tools: {runner.state.step} updates")
    with open(os.path.join(work, "train", "train_log.jsonl")) as f:
        log = [json.loads(r) for r in f]
    losses = [r["loss"] for r in log if "loss" in r]
    val = [(r["epoch"], r["eval"]["mIoU"]) for r in log if "eval" in r]
    check(len(val) == evals and all(np.isfinite(losses)),
          f"tools: {len(val)} evaluations, losses {losses[:3]}...")
    best = os.path.join(work, "train", "ckpts", "best.pth")
    t = time.perf_counter()
    out = test_tool.main(["deliver_tiny", best, "--data-root", data,
                          "--out-dir", os.path.join(work, "test")])
    test_s = time.perf_counter() - t
    with open(out) as f:
        miou = json.load(f)["mIoU"]
    line("tools", part="convergence", epochs=TOOLS_EPOCHS,
         eval_interval=TOOLS_EVAL_INTERVAL, updates=runner.state.step,
         first_loss=f"{losses[0]:.4f}", last_loss=f"{losses[-1]:.4f}",
         val_miou=compact(val), test_miou=miou, jax_test_miou=JAX_SYNTH_MIOU,
         launches=compact(counts), train_s=f"{train_s:.1f}",
         test_s=f"{test_s:.1f}", gpu=repr(smi))
    check(miou >= MIN_SYNTH_MIOU, f"tools: test mIoU {miou} after "
          f"{TOOLS_EPOCHS} bf16 epochs < {MIN_SYNTH_MIOU} (JAX "
          f"{JAX_SYNTH_MIOU})")
    return counts, best, data, miou


def tools_flops(torch, kernels):
    """(d): tools/get_flops.py's count of the full-width deliver_rgblidar
    forward at 1024^2 on the card's kernel path and on `meta`. Returns
    the kernel path's launches."""
    from multimodal_sam_adapter_torch.tools import get_flops

    cfg = get_flops.model_config("deliver_rgblidar")
    t = time.perf_counter()
    n_meta, meta = get_flops.count(cfg, (1024, 1024), "meta")
    meta_s = time.perf_counter() - t
    kernels.reset_launches()
    n_card, card = get_flops.count(cfg, (1024, 1024), "cuda")
    counts = dict(kernels.LAUNCHES)
    check(counts == PER_FORWARD, f"tools: get_flops launches {counts}")
    m, c = meta.totals(), card.totals()
    same = {k: m[k] == c[k] for k in m if k != "bytes"}
    check(all(same.values()) and meta.kernels.keys() == card.kernels.keys(),
          f"tools: the card's count {c} != meta's {m}")
    check(n_meta == n_card and f"{n_meta / 1e6:.2f}" == FLAGSHIP_PARAMS_M,
          f"tools: params {n_meta} / {n_card}")
    line("tools", part="flops", params_m=f"{n_meta / 1e6:.2f}",
         gflops=f"{m['flops'] / 1e9:.2f}",
         card_gflops=f"{c['flops'] / 1e9:.2f}",
         jax_xla_gflops=JAX_FLAGSHIP_GFLOPS,
         ratio=f"{m['flops'] / 1e9 / JAX_FLAGSHIP_GFLOPS:.4f}",
         split_gflops=compact({k: round(m[k] / 1e9, 3) for k in (
             "products", "interpolations", "tensor_ops", "other_ops")}),
         bytes_gb=f"{m['bytes'] / 1e9:.2f}",
         card_bytes_gb=f"{c['bytes'] / 1e9:.2f}",
         launches=compact(counts), meta_s=f"{meta_s:.1f}")
    return counts


def tools_files(work):
    """(e): convert_deliver and color_gt on a raw DeLiVER tree of 1042^2
    frames this phase writes: files/s, the labels remapped and coloured
    as the root tools do."""
    from multimodal_sam_adapter_torch.data import image_io
    from multimodal_sam_adapter_torch.data.datasets import DELIVER_PALETTE
    from multimodal_sam_adapter_torch.tools import color_gt, convert_deliver

    rng = np.random.default_rng(SEED + 15)
    raw, labels = os.path.join(work, "raw"), {}
    for case in RAW_CASES:
        for split in ("train", "val", "test"):
            for i in range(RAW_FRAMES):
                gt = _blocks(rng, (RAW_SIDE, RAW_SIDE), 26, 64).astype(
                    np.uint8)
                gt[rng.random(gt.shape) < 0.05] = 255
                for mod, suffix, arr in (
                        ("img", "rgb_front", _scene(rng, gt % 25,
                                                    DELIVER_PALETTE, 12)),
                        ("lidar", "lidar_front", _scene(
                            rng, gt[::-1] % 25, DELIVER_PALETTE, 30)),
                        ("semantic", "semantic_front", gt)):
                    d = os.path.join(raw, mod, case, split, "MAP_1_point0")
                    os.makedirs(d, exist_ok=True)
                    image_io.imwrite(os.path.join(d, f"{i:06d}_{suffix}.png"),
                                     arr)
                labels[f"{case}_MAP_1_point0_{i:06d}_semantic_front.png",
                       split] = gt
    out = os.path.join(work, "converted")
    t = time.perf_counter()
    n = convert_deliver.convert(raw, out)
    convert_s = time.perf_counter() - t
    check(n == 3 * len(labels), f"tools: convert_deliver wrote {n} files")
    split_dir = {"train": "training", "val": "validation", "test": "test"}
    for (name, split), gt in labels.items():
        want = gt.astype(np.int32)
        want[want == 255] = 0
        want = want - 1
        want[want < 0] = 255
        got = image_io.imread(os.path.join(
            out, "samples", "annotations", split_dir[split], name),
            "unchanged")
        check(np.array_equal(got, want.astype(np.uint8)),
              f"tools: {name} remapped wrongly")
    ann = os.path.join(out, "samples", "annotations", "training")
    colored = os.path.join(work, "colored")
    t = time.perf_counter()
    n_color = color_gt.color_dir("DELIVER", ann, colored)
    color_s = time.perf_counter() - t
    name = sorted(os.listdir(ann))[0]
    check(np.array_equal(
        image_io.imread(os.path.join(colored, name)),
        color_gt.colorize(image_io.imread(os.path.join(ann, name),
                                          "unchanged"), DELIVER_PALETTE)),
        f"tools: {name} coloured wrongly")
    line("tools", part="files", side=RAW_SIDE, converted=n,
         convert_files_per_s=f"{n / convert_s:.2f}", colored=n_color,
         color_files_per_s=f"{n_color / color_s:.2f}")


def tools_checkpoints(torch, kernels, work, best, data, miou):
    """(f): convert_checkpoints on a SAM ViT-L layout file (`sam`) and on
    the trained model saved in the reference's DDP mmcv form (`full`):
    the outputs load strictly through `load_state_dict_file('file://...')`
    and tools/test.py, equal to the direct paths."""
    from multimodal_sam_adapter_torch.engine.checkpoint import (
        ingest_sam_pth, load_state_dict_file)
    from multimodal_sam_adapter_torch.models.sam_vit import ImageEncoderViT
    from multimodal_sam_adapter_torch.tools import convert_checkpoints
    from multimodal_sam_adapter_torch.tools import test as test_tool

    g = torch.Generator(device="cuda").manual_seed(SEED + 15)
    sam = os.path.join(work, "sam_vit_l.pth")
    sam_checkpoint(torch, sam, g)
    t = time.perf_counter()
    out = convert_checkpoints.main(["sam", sam,
                                    os.path.join(work, "sam.ckpt")])
    sam_s = time.perf_counter() - t
    got = load_state_dict_file("file://" + out)
    want = ingest_sam_pth(sam, standalone=True)
    check(got.keys() == want.keys() and all(
        torch.equal(got[k], want[k]) for k in want),
        "tools: the converted SAM file differs from ingest_sam_pth's")
    with torch.device("meta"):
        enc = ImageEncoderViT()
    enc.to_empty(device="cpu").load_state_dict(got, strict=True)
    del got, want, enc

    ref = os.path.join(work, "reference_full.pth")
    sd = load_state_dict_file(best)
    torch.save({"meta": {}, "state_dict": {"module." + k: v
                                           for k, v in sd.items()},
                "optimizer": {}}, ref)
    full = convert_checkpoints.main(["full", ref, os.path.join(
        work, "full.ckpt"), "--config", "deliver_tiny"])
    res = test_tool.main(["deliver_tiny", full, "--data-root", data,
                          "--out-dir", os.path.join(work, "test_full")])
    with open(res) as f:
        full_miou = json.load(f)["mIoU"]
    check(full_miou == miou, f"tools: the converted checkpoint scores "
          f"{full_miou}, the trained one {miou}")
    line("tools", part="checkpoints", sam_convert_s=f"{sam_s:.1f}",
         full_test_miou=full_miou)


def tools_train_main(work, smi):
    """Phase 15's (a)-(c) in a process of their own (started by
    `start_tools_train` with `--tools-train`): the results to
    <work>/result.json."""
    import torch

    from multimodal_sam_adapter_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.library()
    counts, best, data, miou = tools_convergence(torch, kernels, smi, work)
    with open(os.path.join(work, "result.json"), "w") as f:
        json.dump(dict(counts=counts, best=best, data=data, miou=miou), f)


class ToolsTrain:
    """Phase 15's convergence run (`tools_train_main`) in a child process:
    it starts when made, so that it overlaps the phases before 15 (the
    full run starts it before phase 11, whose two ranks sharing the card
    are a correctness run, not a speed figure); `result()` waits for it.
    The child and its directory go at `close()` or at exit."""

    def __init__(self, smi):
        import atexit
        import tempfile

        self.work = tempfile.mkdtemp(prefix="msa_tools_")
        self.log = os.path.join(self.work, "train.log")
        with open(self.log, "w") as out:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--tools-train",
                 self.work, smi], stdout=out, stderr=subprocess.STDOUT)
        self.t0 = time.perf_counter()
        atexit.register(self.close)

    def result(self):
        rc = self.proc.wait(timeout=TOOLS_TRAIN_TIMEOUT)
        with open(self.log) as f:
            text = f.read()
        for row in text.splitlines():
            if row.startswith("[tools]"):
                print(row, flush=True)
        if rc != 0:
            print(text[-4000:], file=sys.stderr, flush=True)
        check(rc == 0, f"tools: the convergence run exited {rc}")
        line("tools", part="child",
             seconds=f"{time.perf_counter() - self.t0:.1f}")
        with open(os.path.join(self.work, "result.json")) as f:
            return json.load(f)

    def close(self):
        import shutil

        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        shutil.rmtree(self.work, ignore_errors=True)


def phase_tools(torch, kernels, smi, train_run):
    """Phase 15: the port's tools on the card's machine and the
    convergence run (`train_run`, a ToolsTrain). Returns the launches of
    the train run and of the flagship count on the card."""
    try:
        res = train_run.result()
        flops_counts = tools_flops(torch, kernels)
        work = train_run.work
        tools_files(work)
        tools_checkpoints(torch, kernels, work, res["best"], res["data"],
                          res["miou"])
    finally:
        train_run.close()
    return dict(train=res["counts"], flops=flops_counts)


def main(phases=None):
    """Every phase; with `phases` == ["ddp"], phases 1, 2 and 11 alone
    (the four-card run: phase 11 is what there is to see across cards);
    with ["tp"], phases 1, 2 and phase 11's parts (e) and (f) alone;
    with ["files"], phases 1, 2 and 12; with ["m2f"], phases 1, 2 and
    13; with ["rgb"], phases 1, 2 and 14; with ["tools"], 1, 2 and 15."""
    import torch

    kind, smi = phase_device(torch)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import kernel_checks as kc
    if phases in (["ddp"], ["tp"], ["files"], ["m2f"], ["rgb"],
                  ["tools"]):
        from multimodal_sam_adapter_torch.ops import kernels

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        phase_build(kernels)
        if phases == ["m2f"]:
            phase_m2f(torch, kernels, smi, kc)
        elif phases == ["rgb"]:
            phase_rgb(torch, kernels, smi, kc)
        elif phases == ["tools"]:
            phase_tools(torch, kernels, smi, ToolsTrain(smi))
        elif phases == ["tp"]:
            phase_ddp(torch, kernels, smi, parts="ef")
        else:
            (phase_ddp if phases == ["ddp"] else phase_files)(torch, kernels,
                                                              smi)
        print(json.dumps({"ok": True, "phases": phases, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return
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
    tools_run = ToolsTrain(smi)      # phase 15's convergence run, meanwhile
    ddp_counts = phase_ddp(torch, kernels, smi)
    gc.collect()
    torch.cuda.empty_cache()
    files_counts = phase_files(torch, kernels, smi)
    gc.collect()
    torch.cuda.empty_cache()
    m2f_counts, m2f_step_counts, k3_m2f = phase_m2f(torch, kernels, smi, kc)
    gc.collect()
    torch.cuda.empty_cache()
    rgb = phase_rgb(torch, kernels, smi, kc)
    gc.collect()
    torch.cuda.empty_cache()
    tools = phase_tools(torch, kernels, smi, tools_run)

    out = []
    for row in rows:
        f32, bf = row.pop("f32"), row.pop("bf16")
        extra = {k: bf[k] for k in ("per_forward_ms", "per_forward_plain_ms")
                 if k in bf}
        if "product_ms" in row:   # K6's yardstick: a key of its own
            extra["product_ms"] = row.pop("product_ms")
        if row["name"] == "msda_multi_level":   # the pixel decoder's K3
            extra["m2f_shapes"] = k3_m2f
        if row["name"] == "pixel_shuffle_up_bn":  # on the conv stem's c1
            extra["rgb_operands_ms"] = rgb["k6_ms"]
        out.append(dict(row, launches=counts[row["name"]],
                        train_launches=train_counts[row["name"]],
                        train_entry_launches=entry_counts[row["name"]],
                        ddp_launches=ddp_counts["ddp"][row["name"]],
                        zero_launches=ddp_counts["zero"][row["name"]],
                        tp_launches=ddp_counts["tp"][row["name"]],
                        tp_train_launches=ddp_counts["tp_train"][
                            row["name"]],
                        files_launches=files_counts[row["name"]],
                        m2f_launches=m2f_counts[row["name"]],
                        m2f_train_launches=m2f_step_counts[row["name"]],
                        rgb_launches=rgb["forward"][row["name"]],
                        rgb_train_launches=rgb["micro_step"][row["name"]],
                        encoder_launches=rgb["encoder"][row["name"]],
                        tools_launches=tools["train"][row["name"]],
                        flops_launches=tools["flops"][row["name"]],
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
            ddp_rank_main(*sys.argv[2:5])
        elif sys.argv[1:2] == ["--tools-train"]:
            tools_train_main(*sys.argv[2:4])
        elif sys.argv[1:2] == ["--phase"] and sys.argv[2:] in (
                ["ddp"], ["tp"], ["files"], ["m2f"], ["rgb"], ["tools"]):
            main(sys.argv[2:])
        elif sys.argv[1:]:
            raise SystemExit(
                f"usage: {sys.argv[0]} [--phase ddp|tp|files|m2f|rgb|tools]")
        else:
            main()
    except PhaseError as e:
        print(f"FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
