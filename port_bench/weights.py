"""Weights drawn from a run's seed, on the card, in one draw.

The state dict has the reference checkpoint's names and shapes, read from
the plain reference built on `meta`, and is handed to the program and to
the reference alike. One normal draw of every floating value, then an
affine per tensor:

- a product's weight (linear, convolution, transposed convolution):
  N(0, 1 / fan_in), fan_in the inputs summed into one output;
- a norm's gain, a channel attention's temperature and the two blend
  scalars of the fusion neck: 1 + N(0, 0.05^2);
- a BatchNorm's running mean N(0, 0.05^2), its running variance
  0.5 + |N(0, 0.05^2)|, its batch count 0;
- everything else (biases, position embeddings, rel-pos tables, layer
  scales, gates): N(0, 0.05^2).

So activations stay of order one through the depth, as a trained
network's do, and every path carries signal.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from .reference import model as ref_model

STD = 0.05
GAIN_NAMES = ("attn.scale", "scale1", "scale2")


def _kinds(model: nn.Module) -> Dict[str, str]:
    kinds = {}
    for mname, m in model.named_modules():
        prefix = mname + "." if mname else ""
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            kinds[prefix + "weight"] = "fan_in"
        elif isinstance(m, nn.ConvTranspose2d):
            kinds[prefix + "weight"] = "fan_in_t"
        elif isinstance(m, ref_model.NORM_TYPES):
            kinds[prefix + "weight"] = "gain"
            if isinstance(m, nn.BatchNorm2d):
                kinds[prefix + "running_mean"] = "small"
                kinds[prefix + "running_var"] = "var"
                kinds[prefix + "num_batches_tracked"] = "count"
    return kinds


def draw_state_dict(model_cfg: dict, seed: int, device, dtype=torch.float32
                    ) -> Dict[str, torch.Tensor]:
    """The state dict for `seed`, its floating tensors in `dtype` (values
    drawn in float32 and rounded once)."""
    meta = ref_model.build(model_cfg, "meta")
    shapes = {k: tuple(v.shape) for k, v in meta.state_dict().items()}
    kinds = _kinds(meta)
    floating = [k for k in shapes if kinds.get(k) != "count"]
    sizes = [math.prod(shapes[k]) for k in floating]
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out: Dict[str, torch.Tensor] = {}
    with torch.no_grad():
        for k, view in zip(floating, flat.split(sizes)):
            kind = kinds.get(k, "gain" if k.endswith(GAIN_NAMES) else "small")
            shape = shapes[k]
            if kind == "fan_in":
                view.mul_(math.prod(shape[1:]) ** -0.5)
            elif kind == "fan_in_t":
                view.mul_(shape[0] ** -0.5)
            elif kind == "gain":
                view.mul_(STD).add_(1.0)
            elif kind == "var":
                view.mul_(STD).abs_().add_(0.5)
            else:
                view.mul_(STD)
        flat = flat.to(dtype)
        for k, view in zip(floating, flat.split(sizes)):
            out[k] = view.view(shapes[k])
    for k, kind in kinds.items():
        if kind == "count":
            out[k] = torch.zeros((), dtype=torch.long, device=device)
    return {k: out[k] for k in shapes}
