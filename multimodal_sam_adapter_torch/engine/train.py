"""The train step: the counterpart of
multimodal_sam_adapter_tpu/engine/train.py.

One call of the step takes one micro-batch: the segmentor's `loss` in
train mode (dropout and drop path keyed by (seed, step), BatchNorm on the
batch's statistics, updating its running statistics), its backward, and
the optimizer's `step`, which updates the parameters every
`grad_accum_steps`-th call (engine/optim.py). With `compute_dtype`
bfloat16 the forward and the backward run under torch.autocast over the
float32 parameters, as the JAX package runs bf16 compute over float32
params. Data loading, checkpoints and the epoch loop are not ported yet:
the step takes in-memory batches.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from ..models.segmentor import EncoderDecoder, build_segmentor
from ..nn.layers import fold_in, set_dropout_key
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


def make_train_step(model: EncoderDecoder, optimizer: LayerDecayAdamW,
                    ignore_index: int = 255, ohem_thresh: float = 0.7,
                    ohem_min_kept: int = 100_000,
                    ohem_per_sample: bool = True,
                    compute_dtype: Optional[torch.dtype] = None
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Dict[str, object]]:
    """The step: train_step(state, batch) -> {'loss', 'updated'}.

    batch: {'img': (B, H, W, C) float NHWC, 'gt': (B, H, W) integer
    labels}, moved to the model's device. ohem_per_sample=True is the
    reference's per-rank OHEM threshold at samples_per_gpu=1 (PARITY.md).
    compute_dtype: None (float32) or the autocast dtype."""
    device = next(model.parameters()).device

    def train_step(state: TrainState, batch) -> Dict[str, object]:
        model.train()
        set_dropout_key(model, fold_in(state.seed, state.step))
        img = batch["img"].to(device, non_blocking=True)
        gt = batch["gt"].to(device, non_blocking=True)
        with torch.autocast(device.type, dtype=compute_dtype,
                            enabled=compute_dtype is not None):
            loss, _ = model.loss(img, gt, ignore_index=ignore_index,
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
                     optimizer_kwargs: Optional[Dict] = None) -> TrainState:
    """A model from a registry `model` config on `device` (the card unless
    the caller passes the CPU), its weights from `state_dict` or drawn from
    a generator seeded with `seed`, in train mode, with its optimizer
    (`make_optimizer(**optimizer_kwargs)`)."""
    generator = None
    if state_dict is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    model = build_segmentor(model_cfg, device, state_dict=state_dict,
                            generator=generator).train()
    optimizer = make_optimizer(model, **(optimizer_kwargs or {}))
    return TrainState(model, optimizer, 0, seed)
