"""Port parity: the Mask2Former matching and loss
(models/mask2former/matching.py, losses.py) against the JAX package's,
float32 on the CPU.

JAX draws its points inside `mask2former_loss` (`split(rng, B)`, then
`k_match` / `k_loss`, then `k_loss` into the candidates and the fresh
points); the port takes them through its `draws` argument. The tests make
the same splits with jax.random and hand the port JAX's points, so the
two losses see the same coordinates.

Tolerances: rtol 1e-4 for the loss, 1e-3 x max|g| for its gradients (the
repo's loss tolerances); 1e-5 for the costs and samples (float32 sums in
another order). The assignment is an argmin over costs that differ in
round-off: assignments are held equal only where the optimum wins by
`ASSIGN_MARGIN` over every other assignment, and the test asserts that
margin. torch.topk and jax.lax.top_k may order the kept points
differently: only the kept set is held.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from multimodal_sam_adapter_torch.models.mask2former import losses as tl
from multimodal_sam_adapter_torch.models.mask2former import matching as tm
from multimodal_sam_adapter_tpu.models.mask2former import losses as jl
from multimodal_sam_adapter_tpu.models.mask2former import matching as jmt

B, Q, K, h, H, P = 2, 8, 5, 16, 64, 256
ASSIGN_MARGIN = 1e-3
LOSS_RTOL = 1e-4
GRAD_RTOL_OF_MAX = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed=0):
    """Class and mask logits, and a label map with an ignored band and,
    in image 1, class 3 absent."""
    rng = np.random.default_rng(seed)
    cls = rng.standard_normal((B, Q, K + 1)).astype(np.float32)
    masks = (rng.standard_normal((B, Q, h, h)) * 2).astype(np.float32)
    gt = rng.integers(0, K, (B, H, H)).astype(np.int32)
    gt[:, :8] = 255
    gt[1][gt[1] == 3] = 0
    return cls, masks, gt


def jax_draws(key, num_points=P, n_queries=Q, batch=B):
    """The port's PointDraws of each image, drawn by JAX's own splits."""
    n_unc = int(0.75 * num_points)
    out = []
    for k in jax.random.split(key, batch):
        k_match, k_loss = jax.random.split(k)
        k1, k2 = jax.random.split(k_loss)
        out.append(tl.PointDraws(
            _t(jax.random.uniform(k_match, (num_points, 2))),
            _t(jax.random.uniform(k1, (n_queries, 3 * num_points, 2))),
            _t(jax.random.uniform(k2, (n_queries, num_points - n_unc, 2)))))
    return out


def assignment_margin(cost, valid):
    """How much more than the optimum the best assignment with another
    result costs (invalid columns at 1e9, as hungarian_assign sets them):
    each optimal pair of a valid column forbidden in turn, the rest solved
    again. (Pairs of invalid columns are not part of the result.) The
    totals are kept as (pairs on invalid columns, sum over valid ones), so
    that the 1e9 entries cost no precision."""
    valid = np.asarray(valid)
    c = np.asarray(cost, np.float64).copy()
    c[:, ~valid] = 1e9

    def total(d, rows, cols):
        on = valid[cols] & (d[rows, cols] < 1e9)
        return (~on).sum(), d[rows[on], cols[on]].sum()

    rows, cols = linear_sum_assignment(c)
    n_best, best = total(c, rows, cols)
    margin = np.inf
    for r, cc in zip(rows, cols):
        if not valid[cc]:
            continue
        d = c.copy()
        d[r, cc] = 1e12
        rr, ccs = linear_sum_assignment(d)
        n, alt = total(d, rr, ccs)
        margin = min(margin, np.inf if n > n_best else alt - best)
    return margin


def test_costs_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((Q, K + 1)).astype(np.float32)
    pred = rng.standard_normal((Q, 64)).astype(np.float32) * 2
    gt = (rng.random((K, 64)) > 0.5).astype(np.float32)
    w = rng.random(64).astype(np.float32)
    w[:5] = 0
    labels = np.array([0, 2, 4, 1])
    np.testing.assert_allclose(
        tm.classification_cost(_t(logits), _t(labels), 2.0).numpy(),
        np.asarray(jmt.classification_cost(jnp.asarray(logits),
                                           jnp.asarray(labels), 2.0)),
        rtol=1e-5, atol=1e-6)
    for pw in (None, w):
        kw = {} if pw is None else dict(point_weights=_t(pw))
        jkw = {} if pw is None else dict(point_weights=jnp.asarray(pw))
        np.testing.assert_allclose(
            tm.mask_bce_cost(_t(pred), _t(gt), 5.0, **kw).numpy(),
            np.asarray(jmt.mask_bce_cost(jnp.asarray(pred), jnp.asarray(gt),
                                         5.0, **jkw)), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            tm.dice_cost(_t(pred), _t(gt), 5.0, **kw).numpy(),
            np.asarray(jmt.dice_cost(jnp.asarray(pred), jnp.asarray(gt),
                                     5.0, **jkw)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(10, 6), (4, 7), (6, 6)])
def test_hungarian_assign_matches_jax_with_padded_columns(shape):
    """Rectangular either way: more queries than gt slots, fewer, equal;
    padded (invalid) slots are never assigned; batched calls solve each
    image alone."""
    rng = np.random.default_rng(shape[0] * 10 + shape[1])
    costs = rng.random((3,) + shape).astype(np.float32)
    valid = rng.random((3, shape[1])) > 0.3
    valid[:, 0] = True
    before = dict(tm.SOLVES)
    got = tm.hungarian_assign(_t(costs), _t(valid)).numpy()
    assert tm.SOLVES["calls"] == before["calls"] + 1
    assert tm.SOLVES["images"] == before["images"] + 3
    assert got.shape == (3, shape[0]) and got.dtype == np.int64
    for c, v, g in zip(costs, valid, got):
        assert assignment_margin(c, v) > ASSIGN_MARGIN
        want = np.asarray(jmt.hungarian_assign(jnp.asarray(c),
                                               jnp.asarray(v)))
        np.testing.assert_array_equal(g, want)
        assert set(g[g >= 0]) <= set(np.flatnonzero(v))
        assert len(set(g[g >= 0])) == (g >= 0).sum()
    one = tm.hungarian_assign(_t(costs[0]), _t(valid[0])).numpy()
    np.testing.assert_array_equal(one, got[0])


def test_point_sample_matches_jax():
    rng = np.random.default_rng(2)
    masks = rng.standard_normal((3, 9, 13)).astype(np.float32)
    shared = rng.random((50, 2)).astype(np.float32)
    per = rng.random((3, 40, 2)).astype(np.float32)
    per[0, :4] = [[0.0, 0.0], [1.0, 1.0], [0.99, 0.01], [0.5, 1.0]]
    for coords in (shared, per):
        np.testing.assert_allclose(
            tl.point_sample(_t(masks), _t(coords)).numpy(),
            np.asarray(jl.point_sample(jnp.asarray(masks),
                                       jnp.asarray(coords))),
            rtol=1e-5, atol=1e-6)


def test_semantic_points_match_jax():
    rng = np.random.default_rng(3)
    gt = rng.integers(0, K, (H, H + 8)).astype(np.int32)
    gt[rng.random(gt.shape) < 0.1] = 255
    coords = rng.random((300, 2)).astype(np.float32)
    g, v = tl.sample_semantic_points(_t(gt), _t(coords), K)
    jg, jv = jl.sample_semantic_points(jnp.asarray(gt), jnp.asarray(coords),
                                       K)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-6)
    qc = rng.random((Q, 120, 2)).astype(np.float32)
    ids = rng.integers(0, K, Q)
    g, v = tl.sample_semantic_points_for_classes(_t(gt), _t(qc), _t(ids))
    jg, jv = jl.sample_semantic_points_for_classes(
        jnp.asarray(gt), jnp.asarray(qc), jnp.asarray(ids))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-6)
    masks, classes, valid, weight = tl.semantic_to_masks(_t(gt), K)
    jm, jc, jvalid, jw = jl.semantic_to_masks(jnp.asarray(gt), K)
    for a, b in ((masks, jm), (classes, jc), (valid, jvalid), (weight, jw)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_uncertain_point_coords_keep_jax_set():
    """Given JAX's candidates and fresh points, the port keeps the same
    set of candidates (the cut clears a margin) and appends the same
    fresh points."""
    rng = np.random.default_rng(4)
    masks = rng.standard_normal((Q, h, h)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    n_unc = int(0.75 * P)
    over = np.asarray(jax.random.uniform(k1, (Q, 3 * P, 2)))
    extra = np.asarray(jax.random.uniform(k2, (Q, P - n_unc, 2)))
    want = np.asarray(jl.uncertain_point_coords(key, jnp.asarray(masks), P))
    got = tl.uncertain_point_coords(_t(masks), _t(over), _t(extra), P)
    assert got.shape == want.shape == (Q, P, 2)
    np.testing.assert_array_equal(got[:, n_unc:].numpy(), extra)
    np.testing.assert_array_equal(want[:, n_unc:], extra)
    unc = np.sort(-np.abs(np.asarray(jl.point_sample(
        jnp.asarray(masks), jnp.asarray(over)))), axis=1)[:, ::-1]
    # the cut clears ten times the round-off of the sampled logits (~1e-7)
    assert (unc[:, n_unc - 1] - unc[:, n_unc]).min() > 1e-6
    for a, b in zip(got[:, :n_unc].numpy(), want[:, :n_unc]):
        np.testing.assert_array_equal(a[np.lexsort(a.T)], b[np.lexsort(b.T)])


@pytest.fixture(scope="module")
def loss_case():
    """The JAX loss and its gradients (jitted) and the port's, given
    JAX's draws."""
    cls, masks, gt = _inputs()
    key = jax.random.PRNGKey(7)
    f = jax.jit(jax.value_and_grad(
        lambda c, m: jl.mask2former_loss(c, m, jnp.asarray(gt), key,
                                         num_classes=K, num_points=P),
        argnums=(0, 1)))
    want, (g_cls, g_masks) = f(jnp.asarray(cls), jnp.asarray(masks))
    draws = jax_draws(key)
    c = _t(cls).requires_grad_()
    m = _t(masks).requires_grad_()
    got = tl.mask2former_loss(c, m, _t(gt), draws, K, num_points=P)
    got.backward()
    return dict(cls=cls, masks=masks, gt=gt, key=key, draws=draws,
                want=float(want), got=float(got.detach()),
                g_cls=(c.grad.numpy(), np.asarray(g_cls)),
                g_masks=(m.grad.numpy(), np.asarray(g_masks)))


def test_matching_assigns_as_jax_where_the_optimum_clears_the_margin(
        loss_case):
    cls, masks, gt = (loss_case[k] for k in ("cls", "masks", "gt"))
    draws = loss_case["draws"]
    got = tl.match_queries(_t(cls), _t(masks), _t(gt), draws, K).numpy()
    for b in range(B):
        coords = jnp.asarray(draws[b].match.numpy())
        m_pts = jl.point_sample(jnp.asarray(masks[b]), coords)
        g_pts, v_pts = jl.sample_semantic_points(jnp.asarray(gt[b]), coords,
                                                 K)
        cost = np.asarray(
            jmt.classification_cost(jnp.asarray(cls[b]), jnp.arange(K), 2.0)
            + jmt.mask_bce_cost(m_pts, g_pts, 5.0, point_weights=v_pts)
            + jmt.dice_cost(m_pts, g_pts, 5.0, point_weights=v_pts))
        valid = np.bincount(gt[b][gt[b] < K], minlength=K) > 0
        port_cost = tl.match_costs(_t(cls[b]), _t(masks[b]), _t(gt[b]),
                                   draws[b].match, K).numpy()
        np.testing.assert_allclose(port_cost, cost, rtol=1e-5, atol=1e-5)
        assert assignment_margin(cost, valid) > ASSIGN_MARGIN
        want = np.asarray(jmt.hungarian_assign(jnp.asarray(cost),
                                               jnp.asarray(valid)))
        np.testing.assert_array_equal(got[b], want)
    assert not np.isin(3, got[1])        # class 3 is absent from image 1
    assert (got >= 0).sum() == 2 * K - 1


def test_loss_matches_jax(loss_case):
    assert loss_case["got"] == pytest.approx(loss_case["want"],
                                             rel=LOSS_RTOL)


@pytest.mark.parametrize("which", ["g_cls", "g_masks"])
def test_loss_gradients_match_jax(loss_case, which):
    got, want = loss_case[which]
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=GRAD_RTOL_OF_MAX * np.abs(want).max())


def test_loss_takes_a_given_assignment(loss_case):
    """The assignment handed in is the one used: JAX's own gives JAX's
    loss; nothing matched leaves the no-object CE alone."""
    cls, masks, gt = (_t(loss_case[k]) for k in ("cls", "masks", "gt"))
    draws = loss_case["draws"]
    assign = tl.match_queries(cls, masks, gt, draws, K)
    got = tl.mask2former_loss(cls, masks, gt, draws, K, num_points=P,
                              assign=assign)
    assert float(got) == pytest.approx(loss_case["want"], rel=LOSS_RTOL)
    none = torch.full_like(assign, -1)
    got = tl.mask2former_loss(cls, masks, gt, draws, K, num_points=P,
                              assign=none)
    # every query's target is no-object, of weight 0.1; the weights' sum
    # 0.1 Q is clamped to at least 1
    ce = -(0.1 * cls.log_softmax(-1)[..., K]).sum(-1) / max(0.1 * Q, 1.0)
    assert float(got) == pytest.approx(float(2.0 * ce.mean()), rel=1e-5)


def test_draw_points_from_a_generator():
    g = torch.Generator().manual_seed(5)
    d = tl.draw_points(g, Q, P)
    assert d.match.shape == (P, 2) and d.over.shape == (Q, 3 * P, 2)
    assert d.extra.shape == (Q, P - int(0.75 * P), 2)
    again = tl.draw_points(torch.Generator().manual_seed(5), Q, P)
    for a, b in zip(d, again):
        assert torch.equal(a, b)
    for t in d:
        assert 0 <= float(t.min()) and float(t.max()) < 1


def test_loss_is_float32_under_autocast(loss_case):
    cls, masks, gt = (_t(loss_case[k]) for k in ("cls", "masks", "gt"))
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = tl.mask2former_loss(cls.bfloat16(), masks.bfloat16(), gt,
                                  loss_case["draws"], K, num_points=P)
    assert got.dtype == torch.float32
    want = tl.mask2former_loss(cls.bfloat16().float(),
                               masks.bfloat16().float(), gt,
                               loss_case["draws"], K, num_points=P)
    assert float(got) == pytest.approx(float(want), rel=1e-6)
