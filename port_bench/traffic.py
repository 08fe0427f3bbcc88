"""The one generator of every traffic mix: it reads a mix's parameters
(port_bench/traffic/<name>.json) and the configuration's input geometry,
and draws the run's inputs from its seed.

Parameters of a mix:

- `kind`: the module under port_bench/kinds/ that drives the mix:
  "predict" (a closed loop of requests through the inference engine, one
  client) or "train" (micro-steps through the train step);
- `batch`: images a request, or samples a micro-step;
- `pool`: distinct requests (or micro-batches) drawn; request i sends
  pool entry order[i], `order` a seeded shuffle of the pool repeated;
- `ignore_share` (train): the share of label pixels set to the ignore
  index;
- `sample` (predict): requests of the window whose answers are checked,
  drawn from the seed among those completed.

Frames are smooth fields: a normal draw at 1/32 of the frame's size
resized bilinearly to it, plus a quarter of a full-size normal draw, per
channel; labels are the argmax of `classes` such fields at 1/64 of the
size, so that classes come in regions, with `ignore_share` of the
pixels set to 255.
"""
from __future__ import annotations

import json
import random
from pathlib import Path
from typing import Dict, List

import torch
import torch.nn.functional as F

from .reference.model import fold_in

IGNORE_INDEX = 255


def load_mix(root: Path, name: str) -> dict:
    mix = json.loads((root / "traffic" / f"{name}.json").read_text())
    kind = str(mix.get("kind"))
    if not (kind.isidentifier()
            and (root / "kinds" / f"{kind}.py").is_file()):
        raise ValueError(f"traffic {name}: no kind {kind!r} under kinds/")
    return mix


def _smooth(g, n, chans, hw, coarse, device) -> torch.Tensor:
    H, W = hw
    low = torch.randn((n, chans, max(H // coarse, 1), max(W // coarse, 1)),
                      generator=g, device=device)
    fine = torch.randn((n, chans, H, W), generator=g, device=device)
    return F.interpolate(low, size=(H, W), mode="bilinear",
                         align_corners=False) + 0.25 * fine


def frames(seed: int, n: int, chans: int, hw, device) -> torch.Tensor:
    """(n, H, W, chans) float32 frames for `seed`, on `device`."""
    g = torch.Generator(device=device).manual_seed(fold_in(seed, 1))
    return _smooth(g, n, chans, hw, 32, device).permute(0, 2, 3, 1) \
        .contiguous()


def labels(seed: int, n: int, classes: int, hw, ignore_share: float,
           device) -> torch.Tensor:
    """(n, H, W) int64 labels for `seed`, on `device`."""
    g = torch.Generator(device=device).manual_seed(fold_in(seed, 2))
    lab = _smooth(g, n, classes, hw, 64, device).argmax(1)
    drop = torch.rand(lab.shape, generator=g, device=device) < ignore_share
    return torch.where(drop, IGNORE_INDEX, lab)


def order(seed: int, pool: int, count: int) -> List[int]:
    """Pool entries of requests 0..count-1: seeded shuffles of the pool,
    one after another."""
    rng = random.Random(fold_in(seed, 3))
    out: List[int] = []
    while len(out) < count:
        block = list(range(pool))
        rng.shuffle(block)
        out.extend(block)
    return out[:count]


def requests(mix: dict, geometry: dict, seed: int, device) -> List[torch.Tensor]:
    """The pool of a predict mix: `pool` tensors (batch, H, W, C) float32
    on the host (pageable, as a client hands frames over)."""
    n = mix["pool"] * mix["batch"]
    imgs = frames(seed, n, geometry["channels"], geometry["frame_hw"], device)
    return [t.cpu() for t in imgs.view(mix["pool"], mix["batch"],
                                        *imgs.shape[1:])]


def micro_batches(mix: dict, geometry: dict, classes: int, seed: int,
                  device) -> Dict[str, torch.Tensor]:
    """The pool of a train mix on the card: 'img' (pool, batch, H, W, C)
    float32 and 'gt' (pool, batch, H, W) int64."""
    n = mix["pool"] * mix["batch"]
    hw = geometry["frame_hw"]
    imgs = frames(seed, n, geometry["channels"], hw, device)
    gts = labels(seed, n, classes, hw, mix["ignore_share"], device)
    return dict(img=imgs.view(mix["pool"], mix["batch"], *imgs.shape[1:]),
                gt=gts.view(mix["pool"], mix["batch"], *gts.shape[1:]))


class Reservoir:
    """A seeded uniform sample of `k` of the items offered (Algorithm R)."""

    def __init__(self, k: int, seed: int):
        self.k, self.n = k, 0
        self.rng = random.Random(fold_in(seed, 4))
        self.items: list = []

    def offer(self, item) -> None:
        self.n += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = self.rng.randrange(self.n)
        if j < self.k:
            self.items[j] = item
