"""Segmentation losses over NHWC logits: the counterpart of
multimodal_sam_adapter_tpu/models/losses.py, with the same semantics.

`ohem_cross_entropy` is the training loss of every shipped config, a
PIDNet-style OHEM (the reference's ohem_cross_entropy_loss.py): keep the
pixels whose probability of the true class is below max(thresh, the k-th
smallest such probability), k = min(min_kept, n_valid - 1), and average
their cross entropy. Plain CE, Dice and Focal are registered but unused by
the shipped configs. Every loss runs in float32, whatever the logits'
dtype.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def _flatten(logits: torch.Tensor, labels: torch.Tensor):
    """logits (B, H, W, C) or (N, C); labels (B, H, W) or (N,) ->
    (N, C) float32 logits and (N,) int64 labels."""
    C = logits.shape[-1]
    return logits.reshape(-1, C).float(), labels.reshape(-1).long()


def _class_weight(class_weight, device) -> Optional[torch.Tensor]:
    if class_weight is None:
        return None
    return torch.as_tensor(class_weight, dtype=torch.float32, device=device)


def ohem_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = 255, thresh: float = 0.7,
                       min_kept: int = 100_000, loss_weight: float = 1.0,
                       class_weight: Optional[Sequence[float]] = None,
                       per_sample: bool = False) -> torch.Tensor:
    """OHEM cross entropy over NHWC logits and (B, H, W) integer labels.

    per_sample: the threshold's scope. False: one threshold over the whole
    batch; True: one per sample, then the mean of the per-sample means
    (the reference's per-rank scope at samples_per_gpu=1, which the train
    step uses; PARITY.md). A sample with no valid pixel counts 0."""
    B = logits.shape[0] if (per_sample and logits.dim() >= 3) else 1
    logits, labels = _flatten(logits, labels)
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0)
    logp_t = torch.log_softmax(logits, dim=-1).gather(1, safe[:, None])[:, 0]
    pixel_losses = -logp_t
    cw = _class_weight(class_weight, logits.device)
    if cw is not None:
        pixel_losses = pixel_losses * cw[safe]
    N = pixel_losses.numel() // B
    valid = valid.view(B, N)
    pixel_losses = pixel_losses.view(B, N)
    with torch.no_grad():
        # the k-th smallest true-class probability among a row's valid
        # pixels (invalid ones sort to +inf and never set the threshold)
        prob_t = logp_t.detach().exp().view(B, N)
        sorted_probs = torch.where(valid, prob_t, torch.inf).sort(dim=1)[0]
        n_valid = valid.sum(dim=1)
        k = (n_valid - 1).clamp(min=0, max=min_kept)
        threshold = sorted_probs.gather(1, k[:, None])[:, 0].clamp(min=thresh)
        keep = valid & (prob_t < threshold[:, None])
        n_keep = keep.sum(dim=1).clamp(min=1)
    row_loss = torch.where(keep, pixel_losses, 0.0).sum(dim=1) / n_keep
    row_loss = torch.where(n_valid > 0, row_loss, 0.0)
    return loss_weight * row_loss.mean()


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = 255, loss_weight: float = 1.0,
                       class_weight: Optional[Sequence[float]] = None
                       ) -> torch.Tensor:
    """Mean cross entropy over the valid pixels (weighted by their class
    weights, when given)."""
    logits, labels = _flatten(logits, labels)
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0)
    nll = -torch.log_softmax(logits, dim=-1).gather(1, safe[:, None])[:, 0]
    cw = _class_weight(class_weight, logits.device)
    if cw is not None:
        nll = nll * cw[safe]
        denom = torch.where(valid, cw[safe], 0.0).sum()
    else:
        denom = valid.sum().clamp(min=1)
    return loss_weight * torch.where(valid, nll, 0.0).sum() / denom


def dice_loss(logits: torch.Tensor, labels: torch.Tensor,
              ignore_index: int = 255, smooth: float = 1.0,
              exponent: float = 2.0, loss_weight: float = 1.0
              ) -> torch.Tensor:
    """1 - Dice of the softmax against the one-hot labels, per class over
    the valid pixels, averaged over the classes."""
    logits, labels = _flatten(logits, labels)
    C = logits.shape[-1]
    valid = (labels != ignore_index)[:, None]
    probs = torch.softmax(logits, dim=-1) * valid
    onehot = F.one_hot(torch.where(valid[:, 0], labels, 0), C).float()
    onehot = onehot * valid
    num = 2.0 * (probs * onehot).sum(dim=0) + smooth
    den = (probs ** exponent + onehot ** exponent).sum(dim=0) + smooth
    return loss_weight * (1.0 - num / den).mean()


def focal_loss(logits: torch.Tensor, labels: torch.Tensor,
               ignore_index: int = 255, gamma: float = 2.0,
               alpha: float = 0.25, loss_weight: float = 1.0
               ) -> torch.Tensor:
    """Sigmoid focal loss against the one-hot labels, summed over classes
    and averaged over the valid pixels."""
    logits, labels = _flatten(logits, labels)
    C = logits.shape[-1]
    valid = labels != ignore_index
    onehot = F.one_hot(torch.where(valid, labels, 0), C).float()
    p = torch.sigmoid(logits)
    ce = (logits.clamp(min=0) - logits * onehot
          + torch.log1p(torch.exp(-logits.abs())))
    p_t = p * onehot + (1 - p) * (1 - onehot)
    a_t = alpha * onehot + (1 - alpha) * (1 - onehot)
    fl = a_t * (1 - p_t) ** gamma * ce * valid[:, None]
    return loss_weight * fl.sum() / valid.sum().clamp(min=1)
