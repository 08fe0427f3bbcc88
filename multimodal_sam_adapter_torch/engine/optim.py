"""Layer-decay AdamW with the poly / exponential-warmup learning rate and
gradient accumulation: the counterpart of
multimodal_sam_adapter_tpu/engine/optim.py (its optax chain), on the
port's parameter names, which are the reference checkpoint's keys, as the
reference's own LayerDecayOptimizerConstructor reads them.

- Layer decay: a parameter's learning rate is scaled by
  rate ** (L - 1 - layer_id), L = num_layers + 2; layer id 0 for the patch
  and position embeddings and the twin ConvNeXt, N + 1 for ViT block N,
  L - 1 for everything else.
- Weight decay everywhere except 1-D parameters and biases (the twin
  ConvNeXt keeps it on those) and the fusion neck (none at all).
- AdamW as the JAX package chains it: p -= lr * scale * (adam_dir + wd * p),
  the first moment kept in bfloat16 and the second in float32, as its
  optax.scale_by_adam(mu_dtype=bfloat16) keeps them.
- Gradient accumulation as optax.MultiSteps: `step` is called after every
  micro-batch's backward; the gradients sum in `.grad`, and every k-th
  call updates with their mean over the k micro-batches.

Not ported yet: `factored_second_moment` and `ReduceOnPlateau`.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, Iterable, List, Tuple

import numpy as np
import torch
from torch import nn

Named = Iterable[Tuple[str, torch.Tensor]]


# ---------------------------------------------------------------- classes

def vit_layer_id(name: str, num_layers: int) -> int:
    """The layer id of parameter `name` (get_num_layer_for_vit)."""
    if "pos_embed" in name or "patch_embed" in name:
        return 0
    if "twin_conv" in name:
        return 0
    m = re.search(r"(?:^|\.)blocks\.(\d+)\.", name)
    if m:
        return int(m.group(1)) + 1
    return num_layers + 1


def wants_weight_decay(name: str, p: torch.Tensor) -> bool:
    """The reference's no-decay rules on the port's names."""
    if "twin_conv" in name:
        return True  # the reference exempts twin_conv from the 1-D rule
    if "smart_fusion" in name:
        return False
    return not (p.dim() <= 1 or name.endswith(".bias"))


def layer_decay_scales(named: Named, num_layers: int,
                       decay_rate: float) -> Dict[str, float]:
    """name -> learning-rate multiplier rate ** (L - 1 - layer_id)."""
    L = num_layers + 2
    return {n: decay_rate ** (L - 1 - vit_layer_id(n, num_layers))
            for n, _ in named}


def weight_decay_mask(named: Named) -> Dict[str, bool]:
    return {n: wants_weight_decay(n, p) for n, p in named}


def freeze_backbone_mask(named: Named) -> Dict[str, float]:
    """freeze_backbone (the reference train.py): 0 (no update) for the
    patch and position embeddings and the ViT blocks' parameters outside
    their MLPs, 1 elsewhere."""
    def frozen(n: str) -> bool:
        if "patch_embed" in n or n.endswith("pos_embed"):
            return True
        return bool(re.search(r"(?:^|\.)blocks\.\d+\.", n)) and "mlp" not in n

    return {n: 0.0 if frozen(n) else 1.0 for n, _ in named}


def twin_convnext_freeze_mask(named: Named,
                              frozen_stages: int) -> Dict[str, float]:
    """The twin ConvNeXt's freeze_stages: 0 for both branches' downsample
    layer and blocks of the first `frozen_stages` stages (their out-norms
    stay trainable, as in the reference), 1 elsewhere."""
    pat = re.compile(r"twin_conv\.(?:downsample_layers|stages)_[xy]\.(\d+)\.")

    def frozen(n: str) -> bool:
        m = pat.search(n)
        return bool(m) and int(m.group(1)) < frozen_stages

    return {n: 0.0 if frozen(n) else 1.0 for n, _ in named}


# ---------------------------------------------------------------- schedule

def poly_schedule_with_exp_warmup(base_lr: float, steps_per_epoch: int,
                                  max_epochs: int, power: float = 0.9,
                                  min_lr: float = 0.0,
                                  warmup_epochs: int = 10,
                                  warmup_ratio: float = 0.1,
                                  by_epoch: bool = True
                                  ) -> Callable[[int], float]:
    """mmcv's poly policy, lr = (base - min) (1 - progress) ** power + min,
    progress advancing per epoch (by_epoch) or per step, with exponential
    warmup lr *= ratio ** (1 - t / warmup_iters). In float32, as the JAX
    schedule computes it. Takes the count of updates made so far."""
    f32 = np.float32
    warmup_iters = warmup_epochs * steps_per_epoch
    max_iters = max_epochs * steps_per_epoch

    def sched(step: int) -> float:
        step = f32(step)
        if by_epoch:
            progress = f32(np.floor(step / f32(steps_per_epoch))
                           / f32(max_epochs))
        else:
            progress = f32(step / f32(max_iters))
        coeff = f32(np.power(np.clip(f32(1.0) - progress, f32(0), f32(1)),
                             f32(power)))
        lr = f32(f32(base_lr - min_lr) * coeff + f32(min_lr))
        if warmup_iters > 0 and step < warmup_iters:
            t = np.clip(f32(step / f32(warmup_iters)), f32(0), f32(1))
            lr = f32(lr * f32(np.power(f32(warmup_ratio), f32(1.0) - t)))
        return float(lr)

    return sched


# ---------------------------------------------------------------- AdamW

class LayerDecayAdamW(torch.optim.Optimizer):
    """AdamW over parameter groups that each carry `lr_scale` (layer decay
    times any freeze mask) and `weight_decay`; the learning rate comes from
    `schedule(updates made)`. Call `step()` after each micro-batch's
    backward: it returns True on the calls that updated (every
    `grad_accum_steps`-th), after which the gradients are cleared."""

    def __init__(self, param_groups: List[dict],
                 schedule: Callable[[int], float],
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, grad_accum_steps: int = 1):
        if grad_accum_steps < 1:
            raise ValueError(f"grad_accum_steps {grad_accum_steps} < 1")
        super().__init__(param_groups, dict(lr_scale=1.0, weight_decay=0.0))
        self.schedule = schedule
        self.betas = tuple(betas)
        self.eps = eps
        self.grad_accum_steps = grad_accum_steps
        self.mini_step = 0   # micro-batches accumulated since the update
        self.updates = 0     # updates made (the schedule's and Adam's count)

    @torch.no_grad()
    def step(self, closure=None) -> bool:
        if closure is not None:
            raise ValueError("LayerDecayAdamW.step takes no closure")
        self.mini_step += 1
        if self.mini_step < self.grad_accum_steps:
            return False
        self.mini_step = 0
        lr = self.schedule(self.updates)
        self.updates += 1
        b1, b2 = self.betas
        f32 = np.float32
        # bias corrections in float32, and b1 as the bfloat16 first moment
        # meets it in the JAX package's jitted step: rounded to bf16, the
        # product taken in float32
        bc1 = float(f32(1) - f32(b1) ** f32(self.updates))
        bc2 = float(f32(1) - f32(b2) ** f32(self.updates))
        b1_lo = torch.tensor(b1, dtype=torch.bfloat16).item()
        for group in self.param_groups:
            scale, wd = group["lr_scale"], group["weight_decay"]
            for p in group["params"]:
                g = (p.grad.float() if p.grad is not None
                     else torch.zeros_like(p, dtype=torch.float32))
                if self.grad_accum_steps > 1:
                    g = g / self.grad_accum_steps
                st = self.state[p]
                if not st:
                    st["mu"] = torch.zeros_like(p, dtype=torch.bfloat16)
                    st["nu"] = torch.zeros_like(p, dtype=torch.float32)
                mu = (1 - b1) * g + st["mu"].float() * b1_lo
                nu = (1 - b2) * (g * g) + b2 * st["nu"]
                u = (mu / bc1) / ((nu / bc2).sqrt() + self.eps)
                if wd:
                    u = u + wd * p
                p.sub_(u * scale * lr)
                st["mu"] = mu.to(torch.bfloat16)
                st["nu"] = nu
                p.grad = None
        return True


def make_optimizer(model: nn.Module, base_lr: float = 2e-4,
                   weight_decay: float = 0.01,
                   betas: Tuple[float, float] = (0.9, 0.999),
                   eps: float = 1e-8, num_layers: int = 24,
                   layer_decay_rate: float = 0.9,
                   steps_per_epoch: int = 1000, max_epochs: int = 100,
                   power: float = 0.9, min_lr: float = 0.0,
                   warmup_epochs: int = 10, warmup_ratio: float = 0.1,
                   grad_accum_steps: int = 1, freeze_backbone: bool = False,
                   twin_frozen_stages: int = 0) -> LayerDecayAdamW:
    """The JAX package's make_optimizer on `model`'s parameters: one group
    per (lr scale, weight decay), the schedule, grad accumulation."""
    schedule = poly_schedule_with_exp_warmup(
        base_lr, steps_per_epoch, max_epochs, power, min_lr, warmup_epochs,
        warmup_ratio)
    named = list(model.named_parameters())
    scales = layer_decay_scales(named, num_layers, layer_decay_rate)
    masks = []
    if freeze_backbone:
        masks.append(freeze_backbone_mask(named))
    if twin_frozen_stages > 0:
        masks.append(twin_convnext_freeze_mask(named, twin_frozen_stages))
    decay = weight_decay_mask(named)
    groups: Dict[Tuple[float, float], dict] = {}
    for n, p in named:
        s = scales[n]
        for m in masks:
            s *= m[n]
        wd = weight_decay if decay[n] else 0.0
        groups.setdefault((s, wd), dict(params=[], names=[], lr_scale=s,
                                         weight_decay=wd))
        groups[(s, wd)]["params"].append(p)
        groups[(s, wd)]["names"].append(n)
    return LayerDecayAdamW(list(groups.values()), schedule, betas, eps,
                           grad_accum_steps)
