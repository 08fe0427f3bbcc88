"""Entry points of the port: the counterpart of __graft_entry__.py.

- `flagship_config(tiny)`: the flagship segmentor's model config
  (deliver_rgblidar: SAM ViT-L and the multimodal adapter, 1024^2,
  RGB + LiDAR), or with `tiny` the dryrun's geometry (the backbone dict of
  `__graft_entry__._flagship_model(tiny=True)`, copied here);
  `flagship_model(dtype, tiny, device)` builds it from a seeded generator.
- `entry(device)` -> (fn, (model, img)): the flagship bf16 eval forward,
  fn(model, img), on one 1024x1024x6 input.
- `dryrun_multichip(n, device, backend)`: one full train step (loss,
  gradients, layer-decay AdamW under grad_accum 2, BatchNorm statistics)
  of the tiny model in float32 on a (data, model) mesh of n rank
  processes, tp = 2 when n is even and at least 4 (JAX's rule), the
  parameters sharded by parallel/tp.py, one 64^2 sample (ones, labels 0)
  a data rank. It prints
  `dryrun_multichip(n) ok: mesh=data{d}xmodel{tp}, loss=...` with the data
  ranks' mean loss. device "cuda": one card a rank over NCCL, and fewer
  cards than n raise unless the caller passes backend="gloo" (the ranks
  then share the cards); device "cpu": gloo ranks on the CPU. Nothing
  falls back on its own.

The rank processes run this module:

    python -m multimodal_sam_adapter_torch.graft_entry --dryrun-rank \
        <n> <device> <backend>

with torchrun's environment (parallel/ddp.py:launch_ranks sets it).
"""
from __future__ import annotations

import math
import os
import sys
from typing import Dict, Optional

import torch

from .configs.registry import get_config
from .models.segmentor import build_segmentor

# __graft_entry__._flagship_model(tiny=True)'s backbone
TINY_BACKBONE = dict(
    img_size=64, patch_size=16, embed_dim=32, depth=4, num_heads=2,
    drop_path_rate=0.1, conv_drop_path_rate=0.1, conv_inplane=40,
    n_points=2, deform_num_heads=4, init_values=1e-6,
    cffn_ratio=0.25, deform_ratio=0.5,
    interaction_indexes=((0, 0), (1, 1), (2, 2), (3, 3)),
    global_attn_indexes=(1, 3), window_size=2, pretrained_size=64,
    modalities_ch=(3, 3), arch="atto",
)
TINY_HEAD = dict(num_classes=25, head_channels=16, dropout_ratio=0.1)
# the dryrun's optimizer settings, input side and OHEM floor
DRYRUN_OPTIMIZER = dict(steps_per_epoch=10, max_epochs=2, warmup_epochs=1,
                        grad_accum_steps=2)
DRYRUN_SIZE = 64
DRYRUN_OHEM_MIN_KEPT = 64
DRYRUN_TIMEOUT = 600           # seconds for the ranks together
ENTRY_SIZE = 1024


def flagship_config(tiny: bool = False) -> Dict:
    """The flagship's model config (a registry `model` dict), or the
    dryrun's tiny geometry."""
    if tiny:
        return dict(TINY_HEAD, backbone=dict(TINY_BACKBONE))
    m = get_config("deliver_rgblidar")["model"]
    return {k: m[k] for k in ("num_classes", "head_channels",
                              "dropout_ratio", "backbone")}


def flagship_model(dtype: torch.dtype = torch.bfloat16, tiny: bool = False,
                   device="cuda", seed: int = 0) -> torch.nn.Module:
    """`flagship_config(tiny)` built on `device` in eval mode, weights as
    the JAX package initialises them from a generator seeded with `seed`
    (a `meta` model draws nothing), cast to `dtype`."""
    device = torch.device(device)
    gen = torch.Generator(device="cpu" if device.type == "meta" else device)
    model = build_segmentor(flagship_config(tiny), device,
                            generator=gen.manual_seed(seed), init="jax")
    return model.to(dtype)


def entry(device="cuda"):
    """(fn, (model, img)): the flagship bf16 eval forward, fn(model, img)
    -> logits (1, 1024, 1024, 25), on an all-zero 1x1024x1024x6 input."""
    model = flagship_model(torch.bfloat16, device=device)
    img = torch.zeros((1, ENTRY_SIZE, ENTRY_SIZE, 6), dtype=torch.bfloat16,
                      device=device)

    def fn(model, img):
        with torch.no_grad():
            return model(img)

    return fn, (model, img)


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     backend: Optional[str] = None) -> float:
    """One train step of the tiny model on n_devices ranks (see the
    module's docstring); prints its line and returns the loss."""
    if device == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if backend is None:
            if cards < n_devices:
                raise RuntimeError(
                    f"dryrun_multichip({n_devices}) on cuda needs a card a "
                    f"rank and this host has {cards} (pass backend='gloo' "
                    f"for ranks that share cards, or device='cpu')")
            backend = "nccl"
        if cards == 0:
            raise RuntimeError("dryrun_multichip on cuda: no CUDA card")
    elif device == "cpu":
        backend = backend or "gloo"
        if backend != "gloo":
            raise ValueError("ranks on the CPU take the gloo backend")
    else:
        raise ValueError(f"device {device!r} is not 'cuda' or 'cpu'")
    from .parallel.ddp import launch_ranks

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    ranks = launch_ranks(
        [sys.executable, "-m", "multimodal_sam_adapter_torch.graft_entry",
         "--dryrun-rank", str(n_devices), device, backend],
        n_devices, DRYRUN_TIMEOUT, env=env, cwd=root)
    if any(rc != 0 for rc, _ in ranks):
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) failed:\n" + "\n".join(
                f"--- rank {r} (exit code {rc}):\n{log[-4000:]}"
                for r, (rc, log) in enumerate(ranks)))
    lines = [ln for ln in ranks[0][1].splitlines()
             if ln.startswith(f"dryrun_multichip({n_devices}) ok")]
    if len(lines) != 1:
        raise RuntimeError(f"rank 0 printed no result:\n{ranks[0][1]}")
    print(lines[0], flush=True)
    return float(lines[0].rpartition("loss=")[2])


def _dryrun_rank(n_devices: int, device: str, backend: str) -> None:
    """One rank of `dryrun_multichip`, in a process torchrun's environment
    describes."""
    from .engine.train import init_train_state, make_train_step
    from .parallel.ddp import (all_reduce_sum, close_distributed,
                               init_distributed, rank_device, wrap_model)
    from .parallel.tp import make_mesh

    if device == "cpu":
        torch.set_num_threads(1)
    rank, world = init_distributed(backend)
    try:
        dev = torch.device("cpu") if device == "cpu" else rank_device()
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        tp = 2 if world % 2 == 0 and world >= 4 else 1
        mesh = make_mesh(world // tp, tp)
        state = init_train_state(flagship_config(tiny=True), dev, seed=0,
                                 init="jax", mesh=mesh,
                                 optimizer_kwargs=DRYRUN_OPTIMIZER)
        state.seed = 1
        step = make_train_step(wrap_model(state.model, mesh.data_group),
                               state.optimizer,
                               ohem_min_kept=DRYRUN_OHEM_MIN_KEPT, mesh=mesh)
        S = DRYRUN_SIZE
        batch = {"img": torch.ones((1, S, S, 6), device=dev),
                 "gt": torch.zeros((1, S, S), dtype=torch.long, device=dev)}
        out = step(state, batch)
        loss = (all_reduce_sum(out["loss"], mesh.data_group)
                / mesh.data).item()
        if not math.isfinite(loss):
            raise RuntimeError(f"non-finite loss {loss} in the dryrun")
        if rank == 0:
            print(f"dryrun_multichip({n_devices}) ok: mesh=data{mesh.data}"
                  f"xmodel{mesh.model}, loss={loss:.4f}", flush=True)
    finally:
        close_distributed()


if __name__ == "__main__":
    if sys.argv[1:2] != ["--dryrun-rank"] or len(sys.argv) != 5:
        raise SystemExit(f"usage: {sys.argv[0]} --dryrun-rank <n> "
                         f"<cuda|cpu> <nccl|gloo>")
    _dryrun_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
