"""The backward of each kernel's autograd Function against the JAX
package's custom_vjp, float32 on the CPU.

The Functions' forwards are routed to the plain versions (the kernels run
only on the card), so what is held here is the Function's own backward:
K1's, K3/K4's and K5's recompute of the plain version, and K2's banded
recompute. The JAX side runs its Pallas forward in interpret mode (K1,
K3/K4) or calls the backward it defines directly (K2's _dense_flash_bwd,
K5's VJP of _reference_delta).

Tolerance: rtol 1e-4 with an absolute floor of 1e-5 x the largest
gradient: both are float32 autodiff of one formulation, in different
summation orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sam_adapter_torch.ops import (convnext_block as tcb,
                                              flash_attention as tfa,
                                              msda_cuda as tmsda,
                                              window_attention as twa)
from multimodal_sam_adapter_tpu.ops.convnext_block import _reference_delta
from multimodal_sam_adapter_tpu.ops.flash_attention import _dense_flash_bwd
from multimodal_sam_adapter_tpu.ops.msda_pallas import (
    make_ms_deform_attn_flat)
from multimodal_sam_adapter_tpu.ops.window_attention import (
    window_attention_laneblock)


@pytest.fixture
def plain_forward(monkeypatch):
    """Each Function's forward runs the plain version in place of its
    kernel; its backward is untouched."""
    monkeypatch.setattr(twa, "window_attention_kernel",
                        twa.window_attention_plain)
    monkeypatch.setattr(tfa, "flash_attention_kernel",
                        tfa.flash_attention_plain)
    monkeypatch.setattr(tmsda, "ms_deform_attn_cuda",
                        tmsda.ms_deform_attn_plain)
    monkeypatch.setattr(tcb, "convnext_delta_kernel",
                        tcb.convnext_delta_plain)


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _leaves(*arrays):
    return [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.detach().numpy(), want, rtol=1e-4,
        atol=1e-5 * max(float(np.abs(want).max()), 1e-30))


@pytest.mark.parametrize("rows", ["own", "resized"])
def test_window_attention_function_matches_the_jax_vjp(rows, plain_forward):
    """K1: qkv (windows, ws^2, 3 heads d) and both rel-pos tables, the
    tables of the window's own 2 ws - 1 rows or of another length (resized
    on use, in the backward too)."""
    ws, windows, heads, d = 7, 3, 4, 16
    n_rows = 2 * ws - 1 if rows == "own" else 2 * ws + 5
    rng = np.random.default_rng(0)
    qkv = _randn(rng, windows, ws * ws, 3 * heads * d)
    rph, rpw = (_randn(rng, n_rows, d, scale=0.5) for _ in range(2))
    g = _randn(rng, windows, ws * ws, heads * d)
    scale = d ** -0.5

    out, vjp = jax.vjp(
        lambda a, b, c: window_attention_laneblock(
            a, b, c, ws, scale, num_heads=heads, interpret=True),
        jnp.asarray(qkv), jnp.asarray(rph), jnp.asarray(rpw))
    want = vjp(jnp.asarray(g))

    t = _leaves(qkv, rph, rpw)
    got = twa.WindowAttentionFunction.apply(*t, ws, heads, scale)
    got.backward(torch.from_numpy(g))
    _close(got, out)
    for leaf, w in zip(t, want):
        _close(leaf.grad, w)


def test_flash_attention_backward_matches_dense_flash_bwd(plain_forward,
                                                          monkeypatch):
    """K2 on a 12 x 16 grid: N = 192, so both backwards take bands of 64
    query rows, three of them. The rel-pos tables: H's of the grid's own
    23 rows, W's of 27 (resized to 31 on use)."""
    H, W, B, heads, d = 12, 16, 2, 2, 16
    N, C = H * W, heads * d
    assert next(c for c in tfa.BACKWARD_BANDS if N % c == 0) == 64
    rng = np.random.default_rng(1)
    qkv = _randn(rng, B, N, 3 * C)
    rph, rpw = _randn(rng, 2 * H - 1, d, scale=0.5), _randn(rng, 27, d,
                                                            scale=0.5)
    g = _randn(rng, B, N, C)
    scale = d ** -0.5

    def per_head(t):   # (B, N, heads d) -> (B heads, N, d)
        return t.reshape(B, N, heads, d).transpose(0, 2, 1, 3).reshape(
            B * heads, N, d)

    q, k, v = (per_head(qkv[..., i * C:(i + 1) * C]) for i in range(3))
    with jax.default_matmul_precision("highest"):
        dq, dq2, dk, dv, drph, drpw = _dense_flash_bwd(
            *map(jnp.asarray, (q, k, v, rph, rpw, per_head(g))), (H, W),
            scale)
    want = np.concatenate([
        np.asarray(t).reshape(B, heads, N, d).transpose(0, 2, 1, 3).reshape(
            B, N, C) for t in (dq + dq2, dk, dv)], axis=-1)

    bands = []
    band_attention = tfa.band_attention
    monkeypatch.setattr(tfa, "band_attention", lambda q, *a: (
        bands.append(q.shape[1]), band_attention(q, *a))[1])
    t = _leaves(qkv, rph, rpw)
    out = tfa.FlashAttentionFunction.apply(*t, (H, W), heads, scale)
    out.backward(torch.from_numpy(g))
    assert bands == [64, 64, 64]
    _close(t[0].grad, want)
    _close(t[1].grad, drph)
    _close(t[2].grad, drpw)


def test_flash_attention_banded_backward_equals_unbanded():
    """The port's banded backward against the plain version's autodiff
    (the whole (B heads, N, N) score matrix at once)."""
    H, W, B, heads, d = 12, 16, 1, 2, 16
    rng = np.random.default_rng(2)
    qkv = _randn(rng, B, H * W, 3 * heads * d)
    rph, rpw = (_randn(rng, 2 * s - 1, d, scale=0.5) for s in (H, W))
    g = torch.from_numpy(_randn(rng, B, H * W, heads * d))
    t = _leaves(qkv, rph, rpw)
    tfa.flash_attention_plain(*t, (H, W), heads, d ** -0.5).backward(g)
    got = tfa.flash_attention_backward(
        *(torch.from_numpy(a) for a in (qkv, rph, rpw)), g, (H, W), heads,
        d ** -0.5)
    for a, leaf in zip(got, t):
        _close(a, leaf.grad.numpy())


@pytest.mark.parametrize("levels", [3, 1])
@pytest.mark.parametrize("ref_grad", [False, True])
def test_msda_function_matches_the_jax_vjp(levels, ref_grad, plain_forward):
    """K3 (the injector's 3 levels) and K4 (the extractor's 1) on the raw
    projections. The reference points get a gradient only when they
    require one; then it equals JAX's (taken through its ref_T layout)."""
    shapes = ((8, 8), (4, 4), (2, 2)) if levels == 3 else ((6, 5),)
    B, M, D, P, Lq = 2, 2, 8, 2, 19
    L, S = len(shapes), sum(h * w for h, w in shapes)
    rng = np.random.default_rng(3 + levels)
    value = _randn(rng, B, S, M * D)
    offs = _randn(rng, B, Lq, M * L * P * 2, scale=2.0)
    logits = _randn(rng, B, Lq, M * L * P)
    ref = rng.uniform(size=(1, Lq, L, 2)).astype(np.float32)
    g = _randn(rng, B, Lq, M * D)
    ref_T = ref.transpose(0, 2, 3, 1).reshape(1, L * 2, Lq)

    fn = make_ms_deform_attn_flat(shapes, M, P, interpret=True)
    out, vjp = jax.vjp(fn, *map(jnp.asarray, (value, offs, logits, ref_T)))
    dv, doffs, dlogits, dref_T = vjp(jnp.asarray(g))

    t = _leaves(value, offs, logits)
    r = torch.from_numpy(ref).requires_grad_(ref_grad)
    got = tmsda.MSDeformAttnFunction.apply(t[0], r, t[1], t[2], shapes, M,
                                           P)
    got.backward(torch.from_numpy(g))
    _close(got, out)
    for leaf, w in zip(t, (dv, doffs, dlogits)):
        _close(leaf.grad, w)
    if ref_grad:
        _close(r.grad, np.asarray(dref_T).reshape(1, L, 2, Lq)
               .transpose(0, 3, 1, 2))
    else:
        assert r.grad is None


def test_convnext_delta_function_matches_the_vjp_of_reference_delta(
        plain_forward):
    """K5's delta: x (B, H, W, C) and the nine parameters, against the VJP
    of the JAX package's _reference_delta (its custom_vjp's backward),
    taken through the torch layouts (dw (C, 1, 7, 7), Linear weights
    (out, in))."""
    B, H, W, C = 2, 9, 11, 16
    HID = 4 * C
    rng = np.random.default_rng(5)
    x = _randn(rng, B, H, W, C)
    jp = dict(dw=_randn(rng, 7, 7, 1, C, scale=0.1),
              dw_b=_randn(rng, C, scale=0.1),
              ln_g=1 + _randn(rng, C, scale=0.1),
              ln_b=_randn(rng, C, scale=0.1),
              w1=_randn(rng, C, HID, scale=0.1),
              b1=_randn(rng, HID, scale=0.1),
              w2=_randn(rng, HID, C, scale=0.1),
              b2=_randn(rng, C, scale=0.1), gamma=_randn(rng, C, scale=0.5))
    g = _randn(rng, B, H, W, C)
    names = list(jp)
    with jax.default_matmul_precision("highest"):
        out, vjp = jax.vjp(lambda *a: _reference_delta(*a),
                           jnp.asarray(x), *(jnp.asarray(jp[n])
                                             for n in names))
        want = vjp(jnp.asarray(g))

    to_torch = dict(dw=lambda a: a.transpose(3, 2, 0, 1),
                    w1=lambda a: a.T, w2=lambda a: a.T)
    same = lambda a: a  # noqa: E731
    t = _leaves(x, *(np.ascontiguousarray(to_torch.get(n, same)(jp[n]))
                     for n in names))
    got = tcb.ConvNextDeltaFunction.apply(*t, 1e-6)
    got.backward(torch.from_numpy(g))
    _close(got, out)
    _close(t[0].grad, want[0])
    for n, leaf, w in zip(names, t[1:], want[1:]):
        _close(leaf.grad, to_torch.get(n, same)(np.asarray(w)))
