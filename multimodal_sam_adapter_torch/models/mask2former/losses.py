"""The Mask2Former training loss: the counterpart of
multimodal_sam_adapter_tpu/models/mask2former/losses.py (the reference's
mask2former_head.py:230-340 and point_sample.py).

- The matching costs are taken on `num_points` uniform random points,
  bilinearly sampled from the predicted masks and from the full-resolution
  gt masks;
- the mask losses sample `oversample_ratio * num_points` random points a
  query, keep the `importance_sample_ratio * num_points` most uncertain
  (-|logit|), and add fresh random points for the rest;
- the gt is a semantic map: one gt slot a class, valid where the class is
  present. Points whose bilinear mass falls on `ignore_index` pixels are
  weighed down by that mass in the costs and the mask losses.

The random points come in through `draws` (`PointDraws`, one an image),
drawn by `draw_points` from an explicit torch.Generator. Everything here
runs in float32 with autocast off.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .matching import (classification_cost, dice_cost, hungarian_assign,
                       mask_bce_cost)


class PointDraws(NamedTuple):
    """One image's random points, (x, y) in [0, 1)^2."""
    match: torch.Tensor    # (P, 2): the matching costs' points
    over: torch.Tensor     # (Q, oversample * P, 2): the loss's candidates
    extra: torch.Tensor    # (Q, P - importance * P, 2): fresh points


def _counts(num_points: int, oversample_ratio: float,
            importance_sample_ratio: float) -> Tuple[int, int, int]:
    n_unc = int(importance_sample_ratio * num_points)
    return int(num_points * oversample_ratio), n_unc, num_points - n_unc


def draw_points(generator: torch.Generator, num_queries: int,
                num_points: int = 12544, oversample_ratio: float = 3.0,
                importance_sample_ratio: float = 0.75) -> PointDraws:
    """One image's draws from `generator`, on its device, in the order
    match, over, extra (as the JAX package splits its key: k_match, then
    k_loss into the candidates and the fresh points)."""
    n_sampled, _, n_rand = _counts(num_points, oversample_ratio,
                                   importance_sample_ratio)
    kw = dict(generator=generator, device=generator.device)
    return PointDraws(torch.rand((num_points, 2), **kw),
                      torch.rand((num_queries, n_sampled, 2), **kw),
                      torch.rand((num_queries, n_rand, 2), **kw))


def _float32(fn):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        dev = next(a for a in args if torch.is_tensor(a)).device.type
        with torch.autocast(dev, enabled=False):
            return fn(*args, **kwargs)
    return run


def point_sample(masks: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """mmcv's point_sample: bilinear samples at (x, y) in [0, 1]^2,
    align_corners=False, zero padding. masks (N, h, w); coords (P, 2)
    shared or (N, P, 2). Returns (N, P) float32."""
    N, h, w = masks.shape
    if coords.dim() == 2:
        coords = coords[None].expand(N, -1, -1)
    x = coords[..., 0].float() * w - 0.5
    y = coords[..., 1].float() * h - 0.5
    x0, y0 = x.floor(), y.floor()
    tx, ty = x - x0, y - y0
    x0i, y0i = x0.long(), y0.long()
    flat = masks.reshape(N, h * w)

    def corner(yy, xx):
        inb = ((yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)).float()
        idx = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
        return flat.gather(1, idx).float() * inb

    return (corner(y0i, x0i) * (1 - ty) * (1 - tx)
            + corner(y0i, x0i + 1) * (1 - ty) * tx
            + corner(y0i + 1, x0i) * ty * (1 - tx)
            + corner(y0i + 1, x0i + 1) * ty * tx)


@torch.no_grad()
def uncertain_point_coords(mask_logits: torch.Tensor, over: torch.Tensor,
                           extra: torch.Tensor, num_points: int,
                           importance_sample_ratio: float = 0.75
                           ) -> torch.Tensor:
    """get_uncertain_point_coords_with_randomness: of each mask's
    candidate points `over` (N, n_sampled, 2), the
    importance_sample_ratio * num_points with the highest uncertainty
    (-|sampled logit|), then the fresh points `extra`. Returns
    (N, num_points, 2); the kept points come in torch.topk's order (the
    sums over them do not depend on it)."""
    n_unc = int(importance_sample_ratio * num_points)
    uncertainty = -point_sample(mask_logits, over).abs()
    top = uncertainty.topk(n_unc, dim=1).indices
    picked = over.gather(1, top[..., None].expand(-1, -1, 2))
    return torch.cat([picked, extra], dim=1) if extra.shape[1] else picked


def semantic_to_masks(gt_seg: torch.Tensor, num_classes: int,
                      ignore_index: int = 255):
    """(H, W) labels -> (K, H, W) binary masks, (K,) labels, (K,) valid
    (the class is present), (H, W) pixel weights (0 where ignored)."""
    classes = torch.arange(num_classes, device=gt_seg.device)
    masks = (gt_seg[None] == classes[:, None, None]).float()
    valid = masks.sum((1, 2)) > 0
    return masks, classes, valid, (gt_seg != ignore_index).float()


def _bilinear_corners(gt_seg: torch.Tensor, coords: torch.Tensor):
    """The four bilinear corners of each point: (labels (..., 4) int64,
    weights (..., 4) float32), zero weight for corners off the map."""
    H, W = gt_seg.shape
    x = coords[..., 0].float() * W - 0.5
    y = coords[..., 1].float() * H - 0.5
    x0, y0 = x.floor(), y.floor()
    tx, ty = x - x0, y - y0
    x0i, y0i = x0.long(), y0.long()
    flat = gt_seg.reshape(-1).long()
    labs, ws = [], []
    for dy, dx, wgt in ((0, 0, (1 - ty) * (1 - tx)), (0, 1, (1 - ty) * tx),
                        (1, 0, ty * (1 - tx)), (1, 1, ty * tx)):
        yy, xx = y0i + dy, x0i + dx
        inb = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        idx = yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)
        labs.append(flat[idx.reshape(-1)].reshape(yy.shape))
        ws.append(wgt * inb.float())
    return torch.stack(labs, -1), torch.stack(ws, -1)


def sample_semantic_points(gt_seg: torch.Tensor, coords: torch.Tensor,
                           num_classes: int, ignore_index: int = 255):
    """Every class's full-resolution binary mask sampled at coords (P, 2):
    the corner weights whose label is the class, summed. Returns (g (K, P),
    valid weight (P,) = 1 - the mass on ignored pixels)."""
    labs, ws = _bilinear_corners(gt_seg, coords)
    onehot = (labs[..., None] == torch.arange(
        num_classes, device=labs.device)).float()
    g = torch.einsum("pj,pjk->kp", ws, onehot)
    return g, 1.0 - (ws * (labs == ignore_index)).sum(-1)


def sample_semantic_points_for_classes(gt_seg: torch.Tensor,
                                       coords: torch.Tensor,
                                       class_ids: torch.Tensor,
                                       ignore_index: int = 255):
    """coords (Q, P, 2), one class a query -> (g (Q, P), valid (Q, P))."""
    labs, ws = _bilinear_corners(gt_seg, coords)
    g = (ws * (labs == class_ids[:, None, None])).sum(-1)
    return g, 1.0 - (ws * (labs == ignore_index)).sum(-1)


def _present(gt: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(K,) bool: the classes with a pixel in gt (ignored pixels and labels
    out of range count for none)."""
    flat = gt.reshape(-1).long()
    inb = (flat >= 0) & (flat < num_classes)
    return torch.bincount(flat[inb], minlength=num_classes) > 0


@_float32
def match_costs(cls_logits: torch.Tensor, mask_logits: torch.Tensor,
                gt_seg: torch.Tensor, match_coords: torch.Tensor,
                num_classes: int, ignore_index: int = 255,
                cls_weight: float = 2.0, mask_weight: float = 5.0,
                dice_weight: float = 5.0) -> torch.Tensor:
    """One image's (Q, K) matching cost on the points `match_coords`."""
    m_pts = point_sample(mask_logits, match_coords)
    g_pts, v_pts = sample_semantic_points(gt_seg, match_coords, num_classes,
                                          ignore_index)
    labels = torch.arange(num_classes, device=cls_logits.device)
    return (classification_cost(cls_logits, labels, cls_weight)
            + mask_bce_cost(m_pts, g_pts, mask_weight, point_weights=v_pts)
            + dice_cost(m_pts, g_pts, dice_weight, point_weights=v_pts))


@torch.no_grad()
def match_queries(cls_logits: torch.Tensor, mask_logits: torch.Tensor,
                  gt_seg: torch.Tensor, draws: Sequence[PointDraws],
                  num_classes: int, ignore_index: int = 255,
                  cls_weight: float = 2.0, mask_weight: float = 5.0,
                  dice_weight: float = 5.0) -> torch.Tensor:
    """The Hungarian assignment of the batch: (B, Q) int64, each query's
    gt class or -1. One host solve (one device -> host copy) for the
    batch."""
    cost = torch.stack([
        match_costs(c, m, g, d.match, num_classes, ignore_index, cls_weight,
                    mask_weight, dice_weight)
        for c, m, g, d in zip(cls_logits, mask_logits, gt_seg, draws)])
    valid = torch.stack([_present(g, num_classes) for g in gt_seg])
    return hungarian_assign(cost, valid)


@_float32
def mask2former_loss(cls_logits: torch.Tensor, mask_logits: torch.Tensor,
                     gt_seg: torch.Tensor, draws: Sequence[PointDraws],
                     num_classes: int, ignore_index: int = 255,
                     num_points: int = 12544, oversample_ratio: float = 3.0,
                     importance_sample_ratio: float = 0.75,
                     cls_weight: float = 2.0, mask_weight: float = 5.0,
                     dice_weight: float = 5.0,
                     no_object_weight: float = 0.1,
                     assign: Optional[torch.Tensor] = None) -> torch.Tensor:
    """cls_logits (B, Q, K + 1), mask_logits (B, Q, h, w), gt_seg (B, H, W)
    integer labels, draws: one PointDraws an image; `assign` (B, Q): the
    assignment to use, or None to match (`match_queries`). Returns the
    mean over the images of 2 CE + 5 BCE + 5 dice (the weights)."""
    if assign is None:
        assign = match_queries(cls_logits, mask_logits, gt_seg, draws,
                               num_classes, ignore_index, cls_weight,
                               mask_weight, dice_weight)
    losses = []
    for cls_l, mask_l, gt, d, a in zip(cls_logits, mask_logits, gt_seg,
                                       draws, assign):
        tgt = torch.where(a >= 0, a, num_classes)
        logp = cls_l.float().log_softmax(-1)
        w_cls = torch.where(tgt == num_classes, no_object_weight, 1.0)
        loss_cls = -(logp.gather(1, tgt[:, None])[:, 0] * w_cls)
        loss_cls = loss_cls.sum() / w_cls.sum().clamp_min(1.0)

        matched = (a >= 0).float()
        n_matched = matched.sum().clamp_min(1.0)
        coords = uncertain_point_coords(mask_l, d.over, d.extra, num_points,
                                        importance_sample_ratio)
        pm = point_sample(mask_l, coords)
        gm, vm = sample_semantic_points_for_classes(gt, coords,
                                                    a.clamp_min(0),
                                                    ignore_index)
        vsum = vm.sum(-1).clamp_min(1e-6)
        bce = F.softplus(-pm) * gm + F.softplus(pm) * (1 - gm)
        bce = ((bce * vm).sum(-1) / vsum * matched).sum() / n_matched
        p = pm.sigmoid()
        num = 2 * (vm * p * gm).sum(-1)
        den = (vm * p).sum(-1) + (vm * gm).sum(-1)
        dice = ((1 - (num + 1e-3) / (den + 1e-3)) * matched).sum() / (
            n_matched)
        losses.append(cls_weight * loss_cls + mask_weight * bce
                      + dice_weight * dice)
    return torch.stack(losses).mean()
