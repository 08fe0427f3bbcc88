"""The train step: the counterpart of
multimodal_sam_adapter_tpu/engine/train.py.

One call of the step takes one micro-batch: the segmentor's loss in
train mode (dropout and drop path keyed by (seed, step), BatchNorm on the
global batch's statistics, updating its running statistics), its
backward, and the optimizer's `step`, which updates the parameters every
`grad_accum_steps`-th call (engine/optim.py). With `compute_dtype`
bfloat16 the forward and the backward run under torch.autocast over the
float32 parameters, as the JAX package runs bf16 compute over float32
params. The step takes batches on the model's device; the epoch loop,
the loader and checkpoints are engine/runner.py's.

Under data parallelism the step takes the DistributedDataParallel that
wraps the segmentor (parallel/ddp.py:wrap_model) and this rank's share of
the global batch: the loss goes through the wrapper's forward, each
micro-step that does not end an accumulation runs under `no_sync`, so the
gradients summed in `.grad` are all-reduced (averaged) once an update,
and the dropout masks are drawn for this rank's rows of the global batch.
N ranks of B samples then take the step of one process on the N x B
samples in rank order.

Under tensor parallelism (`mesh`, parallel/tp.py: the segmentor sharded
by `shard_segmentor_`, the optimizer built after it on the shards, the
wrapper's DistributedDataParallel over `mesh.data_group`) the data ranks
take the place of the ranks above: each model rank of a data row takes
the row's samples and draws its dropout masks, and the step is again the
unsharded one on the global batch (the model ranks hold its shares).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..models.segmentor import EncoderDecoder, build_segmentor
from ..nn.layers import fold_in, set_dropout_key
from ..parallel.ddp import rank_world
from ..parallel.tp import Mesh, shard_segmentor_
from .optim import LayerDecayAdamW, make_optimizer


@dataclasses.dataclass
class TrainState:
    """model and optimizer; `step` counts the micro-batches taken (the JAX
    state's step), `seed` roots the dropout keys: micro-batch i draws its
    masks under fold_in(seed, i)."""
    model: EncoderDecoder
    optimizer: LayerDecayAdamW
    step: int = 0
    seed: int = 0


def make_train_step(model: nn.Module, optimizer: LayerDecayAdamW,
                    ignore_index: int = 255, ohem_thresh: float = 0.7,
                    ohem_min_kept: int = 100_000,
                    ohem_per_sample: bool = True,
                    compute_dtype: Optional[torch.dtype] = None,
                    mesh: Optional[Mesh] = None
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Dict[str, object]]:
    """The step: train_step(state, batch) -> {'loss', 'updated'}.

    model: the segmentor, or the DistributedDataParallel wrapping it.
    batch: {'img': (B, H, W, C) float NHWC, 'gt': (B, H, W) integer
    labels}, moved to the model's device; under data parallelism this
    rank's B samples, rows rank x B ... of the global batch (every rank
    holds the same B). 'loss' is this rank's. ohem_per_sample=True is the
    reference's per-rank OHEM threshold at samples_per_gpu=1 (PARITY.md):
    a mean of per-sample means, which the ranks' average keeps.
    compute_dtype: None (float32) or the autocast dtype.
    mesh: a tensor-parallel mesh: the batch is this rank's data row's,
    rows data_rank x B ...; 'loss' is this rank's, the mean over
    `mesh.data_group` that of the global batch."""
    segmentor = getattr(model, "module", model)
    device = next(segmentor.parameters()).device
    ddp = isinstance(model, nn.parallel.DistributedDataParallel)
    shard = rank_world() if mesh is None else (mesh.data_rank, mesh.data)
    own = {id(p) for p in segmentor.parameters()}
    if any(id(p) not in own for g in optimizer.param_groups
           for p in g["params"]):
        raise ValueError("the optimizer holds tensors that are not the "
                         "model's parameters (under tensor parallelism, "
                         "build it after shard_segmentor_)")

    def train_step(state: TrainState, batch) -> Dict[str, object]:
        segmentor.train()
        img = batch["img"].to(device, non_blocking=True)
        gt = batch["gt"].to(device, non_blocking=True)
        set_dropout_key(segmentor, fold_in(state.seed, state.step), shard)
        last = optimizer.mini_step + 1 >= optimizer.grad_accum_steps
        with (model.no_sync() if ddp and not last
              else contextlib.nullcontext()):
            with torch.autocast(device.type, dtype=compute_dtype,
                                enabled=compute_dtype is not None):
                loss, _ = model(img, gt, ignore_index=ignore_index,
                                ohem_thresh=ohem_thresh,
                                ohem_min_kept=ohem_min_kept,
                                ohem_per_sample=ohem_per_sample)
            loss.backward()
        updated = optimizer.step()
        state.step += 1
        return {"loss": loss.detach(), "updated": updated}

    return train_step


def init_train_state(model_cfg: Dict, device="cuda", *, seed: int = 0,
                     state_dict: Optional[Dict[str, torch.Tensor]] = None,
                     optimizer_kwargs: Optional[Dict] = None,
                     init: str = "jax",
                     mesh: Optional[Mesh] = None) -> TrainState:
    """A model from a registry `model` config on `device` (the card unless
    the caller passes the CPU), its weights from `state_dict` or drawn from
    a generator seeded with `seed` by `init` ('jax': as the JAX package
    initialises them, models/init.py; 'random': `random_init_`), in train
    mode, sharded over `mesh` when one is given (every rank draws the same
    whole weights, then keeps its shares), with its optimizer
    (`make_optimizer(**optimizer_kwargs)`, on the shards)."""
    generator = None
    if state_dict is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    model = build_segmentor(model_cfg, device, state_dict=state_dict,
                            generator=generator, init=init).train()
    if mesh is not None:
        shard_segmentor_(model, mesh)
    optimizer = make_optimizer(model, **(optimizer_kwargs or {}))
    return TrainState(model, optimizer, 0, seed)
