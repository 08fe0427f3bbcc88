"""Evaluate a segmentor with the PyTorch port (the counterpart of the root
`test.py`, same arguments and the same result file):

    python -m multimodal_sam_adapter_torch.tools.test <config> <checkpoint>
        --data-root DIR [--eval mIoU] [--aug-test [--aug-ratios R ...]]
        [--resize-dim H W] [--case ...] [--max-samples N] [--batch-size N]
        [--show-dir DIR] [--format-only] [--bf16 | --no-bf16]
        [--cfg-options k=v ...] [--device cuda|cpu] [--out-dir DIR]
        [--dist-backend nccl|gloo]

<checkpoint> is a torch checkpoint file with the reference checkpoint's key
names, loaded strictly: a bare state_dict, the reference's mmcv container
(`state_dict`, `meta`, `optimizer`) or `{"model": ...}`, keys with or
without DistributedDataParallel's `module.` prefix
(`engine/checkpoint.py`); or `random` for weights drawn from a
torch.Generator seeded with 0. A checkpoint's `meta` may name the CLASSES
and PALETTE the dataset reports and draws with, as the root `test.py`
reads them. The dataset is read and preprocessed by the port's `data/`
(PNG files through data/image_io.py, no OpenCV); the model runs on
`--device`, `cuda` by default, which fails when there is no card. Writes
eval_single_scale_<stamp>.json (eval_multi_scale_... with --aug-test) into
--show-dir when one is given, else --out-dir: the summary metrics, the
condition x case results for DELIVER, and the run's provenance.

--show-dir DIR writes each sample's palette blend under
DIR/prediction/<condition>/<case>/<stem>.png (engine/visualize.py);
--format-only writes the dataset's submission files instead of metrics
(MUSES: DIR/labelTrainIds/R....png, into --show-dir or ./results), as
tools/infer_test.py does.

On N ranks under torchrun (`python -m torch.distributed.run
--nproc_per_node=N -m multimodal_sam_adapter_torch.tools.test ...`) each
rank evaluates its shard (indices rank::N) on its card, cuda:LOCAL_RANK,
the histograms are summed over the ranks, and rank 0 prints the tables
and writes the file; `--dist-backend` as for tools/train.py (nccl: a
card a rank; gloo: on the CPU or ranks sharing a card).
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Test a segmentor (PyTorch)")
    p.add_argument("config")
    p.add_argument("checkpoint",
                   help="torch checkpoint (state_dict), or 'random'")
    p.add_argument("--data-root", required=True)
    p.add_argument("--eval", nargs="*", default=["mIoU"])
    p.add_argument("--aug-test", action="store_true",
                   help="flip + multi-scale TTA (ratios 0.5 ... 1.75)")
    p.add_argument("--aug-ratios", nargs="+", type=float, default=None,
                   help="override the TTA scale ratios (with --aug-test)")
    p.add_argument("--resize-dim", nargs=2, type=int, default=None)
    p.add_argument("--case", nargs="*", default=None)
    p.add_argument("--show-dir", default=None,
                   help="write palette-blended predictions (and the "
                        "result file) here")
    p.add_argument("--format-only", action="store_true",
                   help="write the dataset's submission files, no metrics")
    p.add_argument("--max-samples", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=1,
                   help="stack same-shape images through one forward "
                        "(slide mode and TTA stay batch-1)")
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--no-bf16", dest="bf16", action="store_false")
    p.add_argument("--cfg-options", nargs="+", default=[])
    p.add_argument("--device", default="cuda",
                   help="cuda: the rank's card, cuda:LOCAL_RANK; cpu: the "
                        "plain PyTorch path")
    p.add_argument("--out-dir", default=".")
    p.add_argument("--dist-backend", default="nccl", choices=("nccl", "gloo"),
                   help="the process group's backend under torchrun")
    return p.parse_args(argv)


def main(argv=None):
    """Returns the path of the file written (None on ranks other than 0)."""
    args = parse_args(argv)
    from ..parallel.ddp import close_distributed, init_distributed
    from .train import entry_device

    init_distributed(args.dist_backend)
    try:
        return _evaluate(args, entry_device(args.device))
    finally:
        close_distributed()


def _evaluate(args, device):
    import torch

    from ..configs.registry import apply_overrides, get_config
    from ..data import TestPipeline, build_dataset
    from ..engine.checkpoint import read_checkpoint
    from ..engine.evaluator import Evaluator
    from ..engine.inference import InferenceEngine
    from ..models.segmentor import build_segmentor
    from ..parallel.ddp import is_main

    cfg = get_config(args.config)
    if args.cfg_options:
        apply_overrides(cfg, dict(kv.split("=", 1)
                                  for kv in args.cfg_options))
    if args.resize_dim:
        cfg["test_cfg"]["dim"] = tuple(args.resize_dim)

    ds = build_dataset(cfg["dataset"], args.data_root, test_mode=True)
    pipe = TestPipeline(cfg["test_pipeline"], cfg["dataset"]["modalities_ch"])
    m = cfg["model"]
    if args.checkpoint == "random":
        gen = torch.Generator(device=device).manual_seed(0)
        model = build_segmentor(m, device, generator=gen)
    else:
        sd, meta = read_checkpoint(args.checkpoint, device)
        model = build_segmentor(m, device, state_dict=sd)
        # self-describing checkpoints, as the root test.py reads them
        if meta.get("config_name") not in (None, args.config) and is_main():
            print(f"note: checkpoint was trained with config "
                  f"'{meta['config_name']}', evaluating with "
                  f"'{args.config}'")
        if meta.get("CLASSES"):
            ds.CLASSES = tuple(meta["CLASSES"])
        if meta.get("PALETTE"):
            ds.PALETTE = [tuple(c) for c in meta["PALETTE"]]
    if args.bf16:
        model = model.to(torch.bfloat16)

    engine = InferenceEngine(model, cfg["test_cfg"])
    case_aware = args.case is not None or bool(cfg["evaluation"].get("case"))
    ev = Evaluator(engine, ds, m["num_classes"], case_aware=case_aware,
                   out_dir=args.show_dir)
    aug_cfg = None
    if args.aug_test:
        ratios = args.aug_ratios or [0.5, 0.75, 1.0, 1.25, 1.5, 1.75]
        aug_cfg = {"ratios": ratios, "flip": True}
    results = ev.run(pipeline=pipe, max_samples=args.max_samples,
                     format_only=args.format_only,
                     show=args.show_dir is not None,
                     batch_size=args.batch_size, aug_cfg=aug_cfg)
    if not is_main():
        return None
    ev.print_tables(results)
    stamp = time.strftime("%Y%m%d_%H%M%S")
    scale_tag = "multi_scale" if args.aug_test else "single_scale"
    out_json = osp.join(args.show_dir or args.out_dir,
                        f"eval_{scale_tag}_{stamp}.json")
    payload = dict(results.get("summary", {}))
    payload["provenance"] = {
        "config": args.config,
        "checkpoint": args.checkpoint,
        "data_root": args.data_root,
        "aug_test": bool(args.aug_test),
        "n_samples": len(ds) if args.max_samples is None
        else min(args.max_samples, len(ds)),
        "timestamp": stamp,
        "framework": "torch",
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else device.type),
        "dtype": "bfloat16" if args.bf16 else "float32",
    }
    if "eval_results" in results:
        payload["eval_results"] = results["eval_results"]
    os.makedirs(osp.dirname(out_json) or ".", exist_ok=True)
    with open(out_json, "w") as f:
        json.dump(payload, f, indent=2)
    print(f"wrote {out_json}")
    return out_json


if __name__ == "__main__":
    main()
