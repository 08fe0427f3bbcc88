"""Match costs and the Hungarian assignment: the counterpart of
multimodal_sam_adapter_tpu/models/mask2former/matching.py.

The costs are dense (Q, G) matrices in float32. The assignment itself is
scipy's `linear_sum_assignment` on the host, the solver the reference and
the JAX package (through `jax.pure_callback`) use; no gradient flows
through it. `SOLVES` counts the calls and their host milliseconds.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

# calls, images solved, host ms of the device -> host copies (the wait for
# the device included) and of the solves themselves
SOLVES: Dict[str, float] = {"calls": 0, "images": 0, "copy_ms": 0.0,
                            "solve_ms": 0.0}


def classification_cost(cls_logits: torch.Tensor, gt_labels: torch.Tensor,
                        weight: float = 1.0) -> torch.Tensor:
    """-(softmax probability of the gt class): (Q, K + 1) x (G,) -> (Q, G)."""
    return -cls_logits.float().softmax(-1)[:, gt_labels] * weight


def mask_bce_cost(mask_logits: torch.Tensor, gt_masks: torch.Tensor,
                  weight: float = 1.0,
                  point_weights: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Per-point BCE between (Q, N) mask logits and (G, N) binary masks,
    averaged over the points; `point_weights` (N,) weighs each point (0:
    an ignored pixel) and the average is over their sum."""
    m = mask_logits.float()
    pos, neg = F.softplus(-m), F.softplus(m)
    if point_weights is None:
        denom = float(m.shape[-1])
    else:
        v = point_weights.float()
        pos, neg = pos * v, neg * v
        denom = v.sum().clamp_min(1e-6)
    cost = pos @ gt_masks.float().T + neg @ (1.0 - gt_masks.float()).T
    return cost / denom * weight


def dice_cost(mask_logits: torch.Tensor, gt_masks: torch.Tensor,
              weight: float = 1.0, eps: float = 1e-3,
              point_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """1 - (2 sum p g + eps) / (sum p + sum g + eps), p = sigmoid; with
    `point_weights` v: 2 sum v p g over sum v p + sum v g."""
    p = mask_logits.float().sigmoid()
    g = gt_masks.float()
    if point_weights is None:
        num = 2.0 * p @ g.T
        den = p.sum(-1)[:, None] + g.sum(-1)[None, :]
    else:
        v = point_weights.float()
        num = 2.0 * (p * v) @ g.T
        den = (p * v).sum(-1)[:, None] + (g * v).sum(-1)[None, :]
    return (1.0 - (num + eps) / (den + eps)) * weight


def hungarian_assign(cost: torch.Tensor, valid_gt: torch.Tensor
                     ) -> torch.Tensor:
    """The assignment of (..., Q, G) costs, gt slots where `valid_gt`
    (..., G), of the same leading shape, is False excluded (their cost
    set to 1e9). Returns (..., Q) int64 on cost's device: the gt index of
    each query, -1 for none.

    Solved on the host, on a detached float64 copy: each call is one
    device -> host copy that waits for the device, as the JAX package's
    pure_callback is."""
    from scipy.optimize import linear_sum_assignment

    t0 = time.perf_counter()
    c = cost.detach().to("cpu", torch.float64).numpy()
    v = valid_gt.detach().to("cpu").numpy().astype(bool)
    t1 = time.perf_counter()
    lead = c.shape[:-2]
    c = c.reshape((-1,) + c.shape[-2:]).copy()
    v = v.reshape(-1, v.shape[-1])
    out = np.full(c.shape[:2], -1, np.int64)
    for i in range(c.shape[0]):
        c[i][:, ~v[i]] = 1e9
        rows, cols = linear_sum_assignment(c[i])
        keep = v[i][cols]
        out[i, rows[keep]] = cols[keep]
    SOLVES["calls"] += 1
    SOLVES["images"] += c.shape[0]
    SOLVES["copy_ms"] += (t1 - t0) * 1e3
    SOLVES["solve_ms"] += (time.perf_counter() - t1) * 1e3
    return torch.from_numpy(out.reshape(lead + out.shape[1:])).to(
        cost.device)
