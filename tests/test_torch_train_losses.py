"""The port's losses (models/losses.py) against the JAX package's, value
and gradient with respect to the logits, float32 on the CPU.

Inputs from a seeded numpy generator: NHWC logits large enough that some
pixels' true-class probability passes OHEM's threshold, labels with
ignored (255) pixels and one sample whose pixels are all ignored. OHEM's
cases: n_valid below min_kept (k = n_valid - 1) and above it (the k-th
smallest probability sets the threshold), the threshold per sample and
over the batch, with and without class weights.

Tolerance: rtol 1e-5 / atol 1e-6 (float32, one formulation).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sam_adapter_torch.models import losses as tl
from multimodal_sam_adapter_tpu.models import losses as jl

B, H, W, C = 3, 6, 7, 5
CLASS_WEIGHT = (0.5, 1.0, 2.0, 1.5, 0.8)
TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, H, W, C)) * 3).astype(np.float32)
    labels = rng.integers(0, C, (B, H, W)).astype(np.int32)
    labels[rng.random((B, H, W)) < 0.2] = 255
    labels[1] = 255                           # a sample with no valid pixel
    return logits, labels


def _both(jfn, tfn, kw, seed=0):
    logits, labels = _inputs(seed)
    want, want_g = jax.value_and_grad(
        lambda x: jfn(x, jnp.asarray(labels), **kw))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = tfn(x, torch.from_numpy(labels), **kw)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), **TOL)
    return got.item()


@pytest.mark.parametrize("kw", [
    dict(per_sample=True),                               # n_valid < min_kept
    dict(per_sample=False),
    dict(per_sample=True, min_kept=10, thresh=0.05),     # k-th prob rules
    dict(per_sample=False, min_kept=10, thresh=0.05),
    dict(per_sample=True, class_weight=CLASS_WEIGHT),
    dict(per_sample=False, min_kept=20, thresh=0.3, class_weight=CLASS_WEIGHT,
         loss_weight=0.7),
], ids=["per_sample", "batch", "per_sample_kth", "batch_kth",
        "per_sample_weighted", "batch_kth_weighted"])
def test_ohem_cross_entropy_matches_jax(kw):
    loss = _both(jl.ohem_cross_entropy, tl.ohem_cross_entropy, kw)
    assert loss > 0


def test_ohem_threshold_by_hand():
    """The kept pixels, counted by hand. n_valid < min_kept: k = n_valid -
    1, the row's largest valid probability, so the threshold is max(that,
    0.7) and every valid pixel but the most confident is kept. min_kept 10
    and thresh 0.05: the 11th smallest probability sets the threshold. The
    all-ignore sample counts 0 in the per-sample mean."""
    logits, labels = _inputs(0)
    x, y = torch.from_numpy(logits), torch.from_numpy(labels).long()
    valid = (y != 255).flatten(1)
    lp = torch.log_softmax(x, -1).gather(
        -1, torch.where(y != 255, y, 0)[..., None]).flatten(1)
    p = lp.exp()
    for min_kept, thresh in ((100_000, 0.7), (10, 0.05)):
        rows = []
        for b in range(B):
            pv = p[b][valid[b]].sort()[0]
            if not len(pv):
                rows.append(torch.zeros(()))
                continue
            t = max(pv[min(min_kept, len(pv) - 1)].item(), thresh)
            keep = valid[b] & (p[b] < t)
            rows.append(-lp[b][keep].mean())
        got = tl.ohem_cross_entropy(x, y, thresh=thresh, min_kept=min_kept,
                                    per_sample=True)
        torch.testing.assert_close(got, torch.stack(rows).mean())


@pytest.mark.parametrize("kw", [dict(), dict(class_weight=CLASS_WEIGHT),
                                dict(loss_weight=0.4)],
                         ids=["plain", "weighted", "loss_weight"])
def test_cross_entropy_matches_jax(kw):
    _both(jl.cross_entropy_loss, tl.cross_entropy_loss, kw)


@pytest.mark.parametrize("kw", [dict(), dict(smooth=0.5, exponent=1.0)],
                         ids=["default", "smooth_exponent"])
def test_dice_matches_jax(kw):
    _both(jl.dice_loss, tl.dice_loss, kw, seed=1)


@pytest.mark.parametrize("kw", [dict(), dict(gamma=1.0, alpha=0.6)],
                         ids=["default", "gamma_alpha"])
def test_focal_matches_jax(kw):
    _both(jl.focal_loss, tl.focal_loss, kw, seed=2)


def test_losses_of_an_all_ignored_batch_are_zero():
    logits = torch.randn(2, 4, 4, C, requires_grad=True)
    labels = torch.full((2, 4, 4), 255)
    for fn in (tl.ohem_cross_entropy, tl.cross_entropy_loss, tl.focal_loss):
        loss = fn(logits, labels)
        assert loss.item() == 0.0
        (g,) = torch.autograd.grad(loss, logits)
        assert torch.isfinite(g).all() and g.abs().max() == 0
