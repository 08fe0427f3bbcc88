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
- `factored_second_moment`: Adafactor's row / column factored second
  moment and a bf16 first moment in place of Adam's, as the JAX package
  chains optax.scale_by_factored_rms (decay 0.8, factored where two axes
  hold >= 128, epsilon 1e-30) and optax.ema(b1, debias) in bf16. It picks
  the two largest axes by size, which are the same axes in torch's layout
  as in JAX's, and the factored update is symmetric in the two. The
  fusion neck's fused project_in weights hold JAX's gate and value
  kernels as two halves of the output axis (the modules say which, by a
  `fused_halves()` method): each half is factored on its own, as JAX
  factors the two kernels.
- `state_dict` carries what MultiSteps' state carries in the JAX package:
  the micro-batch count, the update count, and, partway through an
  accumulation, the gradients summed so far; `load_state_dict` restores
  them and the moments' dtypes (bf16 first moment), so that a resumed run
  takes the same steps as one never stopped. `state_dict` is this
  process's alone: under data parallelism, where each rank's `.grad`
  holds its own partial sum partway through an accumulation, the runner
  averages them over the ranks before it takes the state
  (engine/runner.py:average_partial_grads).
- `ReduceOnPlateau`: a factor for the schedule, driven by a metric.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, Iterable, List, Optional, Tuple

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


class ReduceOnPlateau:
    """A learning-rate factor driven by a metric (the reference's
    mmcv_custom/sched.py, registered but unused by the shipped configs):
    multiply the schedule's output by `.factor`, call `.update(metric)`
    after each evaluation. After more than `patience` evaluations without
    a better value the factor shrinks by `factor`, down to `min_factor`."""

    def __init__(self, mode: str = "max", factor: float = 0.1,
                 patience: int = 10, min_factor: float = 1e-3):
        self.mode = mode
        self.factor_step = factor
        self.patience = patience
        self.min_factor = min_factor
        self.best = None
        self.wait = 0
        self.factor = 1.0

    def update(self, value: float) -> float:
        better = (self.best is None
                  or (self.mode == "max" and value > self.best)
                  or (self.mode == "min" and value < self.best))
        if better:
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait > self.patience:
                self.factor = max(self.factor * self.factor_step,
                                  self.min_factor)
                self.wait = 0
        return self.factor


# ---------------------------------------------------------------- AdamW

FACTORED_DECAY = 0.8             # optax.scale_by_factored_rms's defaults
FACTORED_MIN_DIM = 128
FACTORED_EPS = 1e-30


def _factored_dims(shape) -> Optional[Tuple[int, int]]:
    """(d1, d0): the second largest and the largest axis, when both hold
    at least FACTORED_MIN_DIM (optax's _factored_dims), else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < FACTORED_MIN_DIM:
        return None
    return int(order[-2]), int(order[-1])


def _factored_rms(g: torch.Tensor, st: dict, decay: float,
                  tag: str = "") -> torch.Tensor:
    """g scaled by the inverse root of its factored second moment (or the
    full one where the shape does not factor), the moments in `st` (under
    keys ending in `tag`) updated: optax.scale_by_factored_rms's step."""
    sq = g * g + FACTORED_EPS
    dims = _factored_dims(tuple(g.shape))
    if dims is None:
        v = decay * st.get("v" + tag, torch.zeros_like(g)) + (1 - decay) * sq
        st["v" + tag] = v
        return g * v.rsqrt()
    d1, d0 = dims
    v_row = (decay * st.get("v_row" + tag, torch.zeros_like(sq.mean(d0)))
             + (1 - decay) * sq.mean(d0))
    v_col = (decay * st.get("v_col" + tag, torch.zeros_like(sq.mean(d1)))
             + (1 - decay) * sq.mean(d1))
    st["v_row" + tag], st["v_col" + tag] = v_row, v_col
    reduced_d1 = d1 - 1 if d1 > d0 else d1
    row = (v_row / v_row.mean(reduced_d1, keepdim=True)).rsqrt()
    return g * row.unsqueeze(d0) * v_col.rsqrt().unsqueeze(d1)


class LayerDecayAdamW(torch.optim.Optimizer):
    """AdamW over parameter groups that each carry `lr_scale` (layer decay
    times any freeze mask) and `weight_decay`; the learning rate comes from
    `schedule(updates made)`. Call `step()` after each micro-batch's
    backward: it returns True on the calls that updated (every
    `grad_accum_steps`-th), after which the gradients are cleared."""

    def __init__(self, param_groups: List[dict],
                 schedule: Callable[[int], float],
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, grad_accum_steps: int = 1,
                 factored_second_moment: bool = False):
        if grad_accum_steps < 1:
            raise ValueError(f"grad_accum_steps {grad_accum_steps} < 1")
        super().__init__(param_groups, dict(lr_scale=1.0, weight_decay=0.0))
        self.schedule = schedule
        self.betas = tuple(betas)
        self.eps = eps
        self.grad_accum_steps = grad_accum_steps
        self.factored = factored_second_moment
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
        self._update()
        return True

    def _update(self) -> None:
        """One update of every parameter this process owns from its
        gradient (the mean over the accumulation), which is then cleared."""
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
        # the factored moment's decay at this update, 1 - t^-0.8
        decay = float(f32(1) - np.power(f32(self.updates),
                                        f32(-FACTORED_DECAY)))
        for group in self.param_groups:
            scale, wd = group["lr_scale"], group["weight_decay"]
            halves = group.get("factored_halves", False)
            for p in group["params"]:
                if not self.owns(p):
                    p.grad = None
                    continue
                g = (p.grad.float() if p.grad is not None
                     else torch.zeros_like(p, dtype=torch.float32))
                if self.grad_accum_steps > 1:
                    g = g / self.grad_accum_steps
                st = self.state[p]
                if not st:
                    st["mu"] = torch.zeros_like(p, dtype=torch.bfloat16)
                if self.factored:
                    # the bf16 EMA of the factored step, debiased
                    if halves:
                        u = torch.cat([_factored_rms(h, st, decay, f".{j}")
                                       for j, h in enumerate(g.chunk(2))])
                    else:
                        u = _factored_rms(g, st, decay)
                    mu = (1 - b1) * u + st["mu"].float() * b1_lo
                    u = mu / bc1
                else:
                    nu = (1 - b2) * (g * g) + b2 * st.get(
                        "nu", torch.zeros_like(g))
                    mu = (1 - b1) * g + st["mu"].float() * b1_lo
                    u = (mu / bc1) / ((nu / bc2).sqrt() + self.eps)
                    st["nu"] = nu
                if wd:
                    u = u + wd * p
                p.sub_(u * scale * lr)
                st["mu"] = mu.to(torch.bfloat16)
                p.grad = None

    def owns(self, p: torch.Tensor) -> bool:
        """Whether this process updates `p` and keeps its state: every
        parameter here; one rank's share under ZeRO (parallel/zero.py)."""
        return True

    def _params(self) -> List[torch.Tensor]:
        return [p for group in self.param_groups for p in group["params"]]

    def state_dict(self) -> dict:
        """torch's optimizer state (moments, groups) plus `accum`: the
        micro-batch and update counts and, when the state is taken partway
        through an accumulation, each parameter's summed gradient (None
        where it has none), by its index in the groups' order."""
        sd = super().state_dict()
        accum = {"mini_step": self.mini_step, "updates": self.updates}
        if self.mini_step > 0:
            accum["grads"] = [None if p.grad is None else p.grad.detach().clone()
                              for p in self._params()]
        sd["accum"] = accum
        return sd

    def load_state_dict(self, state_dict: dict) -> None:
        sd = dict(state_dict)
        accum = sd.pop("accum")
        dtypes = {i: {k: v.dtype for k, v in st.items() if torch.is_tensor(v)}
                  for i, st in sd["state"].items()}
        super().load_state_dict(sd)
        params = self._params()
        # torch casts floating state to its parameter's dtype: put the
        # bf16 first moment back
        for i, want in dtypes.items():
            st = self.state[params[i]]
            for k, dtype in want.items():
                st[k] = st[k].to(dtype)
        self.mini_step = int(accum["mini_step"])
        self.updates = int(accum["updates"])
        grads = accum.get("grads")
        if self.mini_step > 0 and grads is None:
            raise ValueError("the state is partway through an accumulation "
                             "but holds no gradients")
        for p, g in zip(params, grads or [None] * len(params)):
            p.grad = None if g is None else g.to(p.device, p.dtype).clone()


def make_optimizer(model: nn.Module, base_lr: float = 2e-4,
                   weight_decay: float = 0.01,
                   betas: Tuple[float, float] = (0.9, 0.999),
                   eps: float = 1e-8, num_layers: int = 24,
                   layer_decay_rate: float = 0.9,
                   steps_per_epoch: int = 1000, max_epochs: int = 100,
                   power: float = 0.9, min_lr: float = 0.0,
                   warmup_epochs: int = 10, warmup_ratio: float = 0.1,
                   grad_accum_steps: int = 1, freeze_backbone: bool = False,
                   twin_frozen_stages: int = 0,
                   schedule: Optional[Callable[[int], float]] = None,
                   factored_second_moment: bool = False) -> LayerDecayAdamW:
    """The JAX package's make_optimizer on `model`'s parameters: one group
    per (lr scale, weight decay), the schedule (`schedule(updates made)`,
    the poly / warmup one when None), grad accumulation, Adam's second
    moment or the factored one."""
    if schedule is None:
        schedule = poly_schedule_with_exp_warmup(
            base_lr, steps_per_epoch, max_epochs, power, min_lr,
            warmup_epochs, warmup_ratio)
    named = list(model.named_parameters())
    scales = layer_decay_scales(named, num_layers, layer_decay_rate)
    masks = []
    if freeze_backbone:
        masks.append(freeze_backbone_mask(named))
    if twin_frozen_stages > 0:
        masks.append(twin_convnext_freeze_mask(named, twin_frozen_stages))
    decay = weight_decay_mask(named)
    # weights that hold two JAX kernels as halves of dim 0, as their
    # modules declare them
    halved = {id(p) for m in model.modules() if hasattr(m, "fused_halves")
              for p in m.fused_halves()}
    groups: Dict[Tuple[float, float, bool], dict] = {}
    for n, p in named:
        s = scales[n]
        for m in masks:
            s *= m[n]
        wd = weight_decay if decay[n] else 0.0
        halves = factored_second_moment and id(p) in halved
        group = groups.setdefault((s, wd, halves), dict(
            params=[], names=[], lr_scale=s, weight_decay=wd))
        if halves:
            group["factored_halves"] = True
        group["params"].append(p)
        group["names"].append(n)
    return LayerDecayAdamW(list(groups.values()), schedule, betas, eps,
                           grad_accum_steps, factored_second_moment)
