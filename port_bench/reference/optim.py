"""The reference's optimizer: layer-decay AdamW with gradient
accumulation, as the configuration states it.

- A parameter's learning rate is lr(t) x decay ** (L - 1 - id), L =
  num_layers + 2; id 0 for the patch and position embeddings and the twin
  ConvNeXt, n + 1 for ViT block n, L - 1 for every other parameter.
- Weight decay on every parameter but the 1-D ones and biases (the twin
  ConvNeXt keeps it on those) and the fusion neck (none at all), decoupled:
  p -= lr x scale x (adam direction + wd x p).
- lr(t), t the updates made: mmcv's poly policy by epoch, (base - min) x
  (1 - epoch / max_epochs) ** power + min, times the exponential warmup
  ratio ** (1 - t / (warmup_epochs x steps_per_epoch)); in float32.
- Adam's first moment is kept in bfloat16 and the second in float32;
  their bias corrections in float32.
- The gradient of an update is the mean over `grad_accum` micro-batches.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch


def layer_id(name: str, num_layers: int) -> int:
    if "pos_embed" in name or "patch_embed" in name or "twin_conv" in name:
        return 0
    m = re.search(r"(?:^|\.)blocks\.(\d+)\.", name)
    return int(m.group(1)) + 1 if m else num_layers + 1


def decays(name: str, p: torch.Tensor) -> bool:
    if "twin_conv" in name:
        return True
    if "smart_fusion" in name:
        return False
    return not (p.dim() <= 1 or name.endswith(".bias"))


def learning_rate(t: int, cfg: dict, steps_per_epoch: int) -> float:
    f32 = np.float32
    warm = cfg["warmup_epochs"] * steps_per_epoch
    progress = f32(np.floor(f32(t) / f32(steps_per_epoch))
                   / f32(cfg["max_epochs"]))
    coeff = f32(np.power(np.clip(f32(1) - progress, f32(0), f32(1)),
                         f32(cfg["power"])))
    lr = f32(f32(cfg["base_lr"] - cfg["min_lr"]) * coeff + f32(cfg["min_lr"]))
    if warm > 0 and t < warm:
        frac = np.clip(f32(f32(t) / f32(warm)), f32(0), f32(1))
        lr = f32(lr * f32(np.power(f32(cfg["warmup_ratio"]), f32(1) - frac)))
    return float(lr)


class AdamW:
    """update(params, grads_sum) applies one update from gradients summed
    over `accum` micro-batches."""

    def __init__(self, cfg: dict, accum: int, steps_per_epoch: int):
        self.cfg, self.accum, self.spe = cfg, accum, steps_per_epoch
        self.t = 0
        self.mu: Dict[str, torch.Tensor] = {}
        self.nu: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def update(self, named_params, grads: Dict[str, torch.Tensor]) -> None:
        cfg = self.cfg
        lr = learning_rate(self.t, cfg, self.spe)
        self.t += 1
        b1, b2 = cfg["betas"]
        f32 = np.float32
        bc1 = float(f32(1) - f32(b1) ** f32(self.t))
        bc2 = float(f32(1) - f32(b2) ** f32(self.t))
        b1_bf16 = torch.tensor(b1, dtype=torch.bfloat16).item()
        L = cfg["num_layers"] + 2
        for name, p in named_params:
            g = grads[name] / self.accum
            mu = (1 - b1) * g + (self.mu[name].float() * b1_bf16
                                 if name in self.mu else 0.0)
            nu = (1 - b2) * (g * g) + (b2 * self.nu[name] if name in self.nu
                                     else 0.0)
            u = (mu / bc1) / ((nu / bc2).sqrt() + cfg.get("eps", 1e-8))
            if decays(name, p):
                u = u + cfg["weight_decay"] * p
            scale = cfg["layer_decay_rate"] ** (
                L - 1 - layer_id(name, cfg["num_layers"]))
            p.sub_(u * scale * lr)
            self.mu[name] = mu.to(torch.bfloat16)
            self.nu[name] = nu
