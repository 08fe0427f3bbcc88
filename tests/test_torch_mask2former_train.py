"""The Mask2Former training loss of the whole segmentor against the JAX
package's, float32 on the CPU, at deliver_tiny_m2f's geometry: the loss
of `EncoderDecoder.loss` (the mean over the 3 predictions) and its
gradient for every parameter. Drop path and dropout at 0, as
tests/test_torch_train_parity.py has them.

JAX draws each prediction's points from `make_rng("dropout")`; the test
hands both packages the same points instead: JAX's `mask2former_loss` is
called with the key fold_in(BASE, i) for prediction i (a wrapper set in
place of the module's function while the test runs), and the port's
segmentor takes the points JAX draws from that key
(tests/test_torch_mask2former_loss.py:jax_draws) in place of its own
`draw_points`. Nothing in either package changes.

The cross-attention masks and the assignments are held by margins, on
the port's own predictions and costs (within 1e-6 x max of JAX's): every
resized mask logit clears MASK_MARGIN x max|logit|, and every optimal
assignment wins by ASSIGN_MARGIN.

Tolerances: loss rtol 1e-4; per parameter, max |g_port - g_jax| <= 1e-3 x
max |g_jax| + 1e-6 (tests/test_torch_train_parity.py's).

Marked slow: JAX's compile of the loss and its gradient takes ~80 s of
the file's ~90 s on this CPU. The head-level loss and gradient parity
(tests/test_torch_mask2former_loss.py) runs in tier-1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_sam_adapter_torch.models.segmentor as tseg
from multimodal_sam_adapter_torch.configs.registry import get_config
from multimodal_sam_adapter_torch.engine.convert import state_dict_from_jax
from multimodal_sam_adapter_torch.models.mask2former import losses as tl
from multimodal_sam_adapter_torch.models.segmentor import build_segmentor
from multimodal_sam_adapter_torch.nn.layers import set_dropout_key
from multimodal_sam_adapter_torch.utils.interpolate import resize_bilinear
from multimodal_sam_adapter_tpu.models.mask2former import losses as jl
from multimodal_sam_adapter_tpu.models.segmentor import (
    EncoderDecoder as JaxEncoderDecoder)
from tests._torch_parity import randomize
from tests.test_torch_mask2former import MASK_MARGIN
from tests.test_torch_mask2former_loss import (ASSIGN_MARGIN,
                                               assignment_margin, jax_draws)

pytestmark = pytest.mark.slow

MODEL = get_config("deliver_tiny_m2f")["model"]
BACKBONE = dict(MODEL["backbone"], drop_path_rate=0.0,
                conv_drop_path_rate=0.0, drop_rate=0.0, with_cp=True)
CFG = dict(MODEL, backbone=BACKBONE, dropout_ratio=0.0)
HEAD = CFG["head"]
IDX = BACKBONE["interaction_indexes"]
NCLS, Q = CFG["num_classes"], HEAD["num_queries"]
PREDS = 1 + HEAD["num_decoder_layers"]
B, S = 2, BACKBONE["img_size"]
BASE = jax.random.PRNGKey(11)
P = 12544        # the loss's default points


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gains_around_one(tree):
    """The head's LayerNorm and GroupNorm gains to 1 + N(0, std): gains
    around 0 shrink every query alike, and the queries' costs and masks
    would no longer tell them apart (no margin)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _gains_around_one(v)
        elif k == "scale":
            tree[k] = v + 1.0


@pytest.fixture(scope="module")
def both():
    jm = JaxEncoderDecoder(num_classes=NCLS, head_channels=CFG[
        "head_channels"], dropout_ratio=0.0, backbone_cfg=BACKBONE,
        head_type="mask2former", head_cfg=HEAD)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, S, S, 6)), train=False))
    variables = randomize(shapes, 7, std=0.1)
    _gains_around_one(variables["params"]["decode_head"])
    rng = np.random.default_rng(0)
    img = (rng.standard_normal((B, S, S, 6)) * 0.5).astype(np.float32)
    gt = rng.integers(0, 6, (B, S, S)).astype(np.int32)
    gt[rng.random((B, S, S)) < 0.1] = 255

    real = jl.mask2former_loss
    calls = []

    def keyed(cls_l, mask_l, gt_seg, rng, **kw):
        key = jax.random.fold_in(BASE, len(calls))
        calls.append(key)
        return real(cls_l, mask_l, gt_seg, key, **kw)

    def loss_fn(params, stats):
        (loss, _), upd = jm.apply(
            {"params": params, "batch_stats": stats}, jnp.asarray(img),
            jnp.asarray(gt), method=jm.loss, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(1)})
        return loss, upd["batch_stats"]

    jl.mask2former_loss = keyed
    try:
        with jax.default_matmul_precision("highest"):
            (loss, stats), grads = jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True))(variables["params"],
                                        variables["batch_stats"])
    finally:
        jl.mask2former_loss = real
    assert len(calls) == PREDS
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    want = state_dict_from_jax(
        {"params": to_np(grads), "batch_stats": to_np(stats)}, IDX)

    draws = [jax_draws(jax.random.fold_in(BASE, i), P, Q, B)
             for i in range(PREDS)]
    queue = [d for per_pred in draws for d in per_pred]
    model = build_segmentor(CFG, "cpu", state_dict=state_dict_from_jax(
        variables, IDX)).train()
    seen = []
    hook = model.decode_head.register_forward_hook(
        lambda m, a, out: seen.append(out))
    real_draw = tseg.draw_points
    tseg.draw_points = lambda g, q: queue.pop(0)
    try:
        set_dropout_key(model, 0)
        got, _ = model.loss(torch.from_numpy(img), torch.from_numpy(gt))
        got.backward()
    finally:
        tseg.draw_points = real_draw
        hook.remove()
    assert not queue
    return dict(loss=(got.item(), float(loss)), model=model, want=want,
                preds=seen[0], draws=draws, gt=gt)


def test_margins_hold_on_the_port_predictions(both):
    """No mask bit and no assignment within round-off of flipping."""
    model = both["model"]
    all_cls, all_masks = both["preds"]
    mems = [(2, 2), (4, 4), (8, 8)]
    for i in range(HEAD["num_decoder_layers"]):
        m = resize_bilinear(all_masks[i].detach(), mems[i % 3])
        assert (m.abs().min() / m.abs().max()).item() >= MASK_MARGIN, i
    gt = torch.from_numpy(both["gt"])
    for i, (c, m) in enumerate(zip(all_cls, all_masks)):
        for b in range(B):
            cost = tl.match_costs(c[b].detach(), m[b].detach(), gt[b],
                                  both["draws"][i][b].match, NCLS).numpy()
            valid = np.bincount(both["gt"][b][both["gt"][b] < NCLS],
                                minlength=NCLS) > 0
            assert assignment_margin(cost, valid) > ASSIGN_MARGIN, (i, b)
    assigned = model.decode_head.record["assign"]
    assert all((a >= 0).sum() == B * 6 for a in assigned)


def test_loss_matches_jax(both):
    got, want = both["loss"]
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_every_parameter_gradient_matches_jax(both):
    model, want = both["model"], both["want"]
    n = 0
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        w = want[name].numpy()
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= 1e-3 * np.abs(w).max() + 1e-6, (name, err,
                                                      np.abs(w).max())
        n += 1
    assert n == sum(1 for k in want if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked")))
