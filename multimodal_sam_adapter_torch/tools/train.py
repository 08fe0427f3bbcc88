"""Train a segmentor with the PyTorch port (the counterpart of the root
`train.py`, same arguments):

    python -m multimodal_sam_adapter_torch.tools.train <config>
        --data-root DIR [--work-dir DIR] [--load-from CKPT]
        [--resume-from CKPT] [--auto-resume] [--sam-pretrained PTH]
        [--convnext-pretrained PTH] [--seed N] [--deterministic]
        [--max-epochs N] [--freeze-backbone] [--bf16 | --no-bf16]
        [--cfg-options k=v ...] [--device cuda|cpu]
        [--dist-backend nccl|gloo]

`samples_per_gpu` samples a micro-batch on each rank, `grad_accum`
micro-batches an update. One process, or N data-parallel ranks under
torchrun (parallel/ddp.py):

    python -m torch.distributed.run --nproc_per_node=N \
        -m multimodal_sam_adapter_torch.tools.train <config> ...

Each rank trains on its shard of the train split (the loader's
`num_shards` / `shard_index`) on its own card, `cuda:LOCAL_RANK`; the
gradients are averaged by DistributedDataParallel once an update and the
BatchNorm statistics cover the global batch. `--dist-backend nccl` (the
default) wants a card a rank; ranks that share a card, or run on the CPU
(`--device cpu`), take `gloo`. The weights start as the JAX package draws
them (models/init.py), from the seed, then take the pretrained files
given. The train split is read by the port's `data/` (PNG files through
data/image_io.py, no OpenCV) and transformed by `TrainPipeline`, the
validation split through `TestPipeline` by one bf16 eval model whose
weights and BatchNorm statistics are copied from the trained float32 ones
at each evaluation, each rank evaluating its shard. Rank 0 writes the
checkpoints to <work-dir>/ckpts/ (`step_<N>.pth`, `best.pth`) and the log
to <work-dir>/train_log.jsonl. Runs on `--device`, `cuda` by default,
which fails when there is no card.

`build_runner` is the loop on dataset objects, for callers that hold
their samples in memory.
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp
from typing import Dict, Optional


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a segmentor (PyTorch)")
    p.add_argument("config", help="config name (see configs/registry.py)")
    p.add_argument("--data-root", required=True)
    p.add_argument("--work-dir", default=None)
    p.add_argument("--load-from", default=None,
                   help="start from these weights (fresh optimizer)")
    p.add_argument("--resume-from", default=None,
                   help="resume model, optimizer and step from a "
                        "checkpoint written by this entry")
    p.add_argument("--auto-resume", action="store_true",
                   help="resume from the newest step_<N>.pth in "
                        "<work-dir>/ckpts, if there is one")
    p.add_argument("--sam-pretrained", default=None,
                   help=".pth SAM checkpoint to ingest")
    p.add_argument("--convnext-pretrained", default=None,
                   help=".pth ConvNeXt checkpoint to ingest (both branches)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--deterministic", action="store_true",
                   help="cuDNN deterministic and not benchmarking, as the "
                        "reference sets it; torch.use_deterministic_"
                        "algorithms stays off, since grid_sample's backward "
                        "(the MSDA kernels' VJP) has no deterministic CUDA "
                        "path")
    p.add_argument("--max-epochs", type=int, default=None)
    p.add_argument("--freeze-backbone", action="store_true",
                   help="freeze patch_embed/pos_embed/non-MLP ViT params")
    p.add_argument("--bf16", action="store_true", default=True,
                   help="bf16 autocast over float32 parameters (default)")
    p.add_argument("--no-bf16", dest="bf16", action="store_false")
    p.add_argument("--cfg-options", nargs="+", default=[],
                   help="dotted overrides, e.g. optimizer.base_lr=1e-4")
    p.add_argument("--device", default="cuda",
                   help="cuda: the rank's card, cuda:LOCAL_RANK; cpu: the "
                        "plain PyTorch path")
    p.add_argument("--dist-backend", default="nccl", choices=("nccl", "gloo"),
                   help="the process group's backend under torchrun: nccl "
                        "for a card a rank, gloo for ranks on the CPU or "
                        "sharing a card")
    return p.parse_args(argv)


def entry_device(name: str):
    """The entry's device: the CPU, or for `cuda` this rank's card
    (cuda:LOCAL_RANK % count); no card exits with the reason."""
    import torch

    from ..parallel.ddp import rank_device

    if torch.device(name).type != "cuda":
        return torch.device(name)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: the port's kernels need one "
                         "(pass --device cpu for the plain PyTorch path)")
    return rank_device()


def ckpt_meta(cfg: Dict, config_name: str, dataset, seed: int,
              deterministic: bool) -> Dict:
    """The checkpoint's meta as the JAX entry writes it: version, config
    name and config (through JSON: plain types), CLASSES, PALETTE, seed,
    deterministic."""
    from .. import __version__

    return {
        "version": __version__,
        "config_name": config_name,
        "config": json.loads(json.dumps(cfg, default=str)),
        "CLASSES": list(getattr(dataset, "CLASSES", ()) or ()),
        "PALETTE": [list(c) for c in getattr(dataset, "PALETTE", ()) or ()],
        "seed": seed,
        "deterministic": bool(deterministic),
    }


def build_runner(cfg: Dict, train_ds, work_dir: str, *, device="cuda",
                 seed: int = 0, bf16: bool = True, val_ds=None,
                 val_pipeline=None, sam_pretrained: Optional[str] = None,
                 convnext_pretrained: Optional[str] = None,
                 freeze_backbone: bool = False, meta: Optional[Dict] = None):
    """The EpochRunner of the train entry on dataset objects (`train_ds[i]`
    a raw sample dict): loader and `TrainPipeline` over `train_ds`, model
    and optimizer (JAX init from `seed`, then the pretrained files), the
    step (bf16 autocast when `bf16`), and, with `val_ds`, the eval hook
    (`val_pipeline` None: the samples are already preprocessed). Under a
    process group: this rank's shard of `train_ds` and of `val_ds`, the
    model in DistributedDataParallel for the step."""
    import torch

    from ..data.loader import DataLoader
    from ..data.pipelines import TrainPipeline
    from ..engine.checkpoint import (ingest_convnext_pth, ingest_sam_pth,
                                     merge_pretrained)
    from ..engine.evaluator import Evaluator
    from ..engine.inference import InferenceEngine
    from ..engine.runner import EarlyStopping, EpochRunner
    from ..engine.train import init_train_state, make_train_step
    from ..models.segmentor import build_segmentor
    from ..parallel.ddp import rank_world, wrap_model

    device = torch.device(device)
    rank, world = rank_world()
    m = cfg["model"]
    if m.get("head_type", "segformer") != "segformer":
        raise NotImplementedError(f"head {m['head_type']!r} is not ported")
    loader = DataLoader(
        train_ds, TrainPipeline(cfg["train_pipeline"],
                                cfg["dataset"]["modalities_ch"]),
        batch_size=cfg["data"]["samples_per_gpu"], shuffle=True, seed=seed,
        num_shards=world, shard_index=rank)
    opt_kwargs = dict(cfg["optimizer"], steps_per_epoch=max(len(loader), 1),
                      grad_accum_steps=cfg["data"]["grad_accum"],
                      freeze_backbone=freeze_backbone)
    state = init_train_state(m, device, seed=seed,
                             optimizer_kwargs=opt_kwargs)
    # the dropout keys' root, as the JAX entry's PRNGKey(seed + 1)
    state.seed = seed + 1
    pretrained = {}
    if sam_pretrained:
        pretrained.update(ingest_sam_pth(
            sam_pretrained, m["backbone"]["interaction_indexes"]))
    if convnext_pretrained:
        pretrained.update(ingest_convnext_pth(convnext_pretrained))
    if pretrained:
        state.model.load_state_dict(merge_pretrained(
            state.model.state_dict(), pretrained), strict=True)
    step = make_train_step(wrap_model(state.model), state.optimizer,
                           compute_dtype=torch.bfloat16 if bf16 else None)

    eval_fn = None
    if val_ds is not None and cfg.get("evaluation"):
        # one eval model for every evaluation, in the compute dtype, as
        # the JAX entry keeps one engine; K6 runs on it alone
        eval_model = build_segmentor(
            m, device, generator=torch.Generator(device).manual_seed(0))
        if bf16:
            eval_model = eval_model.to(torch.bfloat16)
        engine = InferenceEngine(eval_model, cfg["test_cfg"])
        evaluator = Evaluator(engine, val_ds, m["num_classes"],
                              case_aware=bool(cfg["evaluation"].get("case")))

        def eval_fn(state):
            eval_model.load_state_dict(state.model.state_dict(), strict=True)
            return evaluator.run(pipeline=val_pipeline,
                                 progress_every=0).get("summary", {})

    return EpochRunner(
        state, step, loader, work_dir,
        max_epochs=cfg["runner"]["max_epochs"], eval_fn=eval_fn,
        eval_interval=cfg["evaluation"]["interval"],
        save_best=cfg["evaluation"].get("save_best"),
        ckpt_interval=cfg["checkpoint"]["interval"],
        max_keep_ckpts=cfg["checkpoint"]["max_keep_ckpts"],
        log_interval=cfg.get("log_config", {}).get("interval", 50),
        early_stopping=EarlyStopping(), ckpt_meta=meta)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from ..configs.registry import apply_overrides, get_config
    from ..data import TestPipeline, build_dataset
    from ..parallel.ddp import close_distributed, init_distributed

    init_distributed(args.dist_backend)
    device = entry_device(args.device)
    if args.deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    cfg = get_config(args.config)
    if args.cfg_options:
        apply_overrides(cfg, dict(kv.split("=", 1)
                                  for kv in args.cfg_options))
    if args.max_epochs:
        cfg["runner"]["max_epochs"] = args.max_epochs
        cfg["optimizer"]["max_epochs"] = args.max_epochs
    work_dir = args.work_dir or osp.join("work_dirs", cfg["name"])
    os.makedirs(work_dir, exist_ok=True)

    train_ds = build_dataset(cfg["dataset"], args.data_root)
    val_ds = val_pipe = None
    if cfg.get("evaluation"):
        val_ds = build_dataset(cfg["dataset"], args.data_root, split="val")
        val_pipe = TestPipeline(cfg["test_pipeline"],
                                cfg["dataset"]["modalities_ch"])
    runner = build_runner(
        cfg, train_ds, work_dir, device=device, seed=args.seed,
        bf16=args.bf16, val_ds=val_ds, val_pipeline=val_pipe,
        sam_pretrained=args.sam_pretrained,
        convnext_pretrained=args.convnext_pretrained,
        freeze_backbone=args.freeze_backbone,
        meta=ckpt_meta(cfg, args.config, train_ds, args.seed,
                       args.deterministic))
    if args.resume_from or args.auto_resume:
        runner.resume(args.resume_from, auto=args.auto_resume)
    elif args.load_from:
        runner.load_weights(args.load_from)
    try:
        runner.run()
    finally:
        runner.logger.close()
        close_distributed()
    return runner


if __name__ == "__main__":
    main()
