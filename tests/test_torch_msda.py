"""Port parity: the plain version of K3/K4 (multi-scale deformable attention
sampling) and the MSDeformAttention module against the JAX package on the
CPU, for 3 levels (the injectors) and 1 level (the extractors).

Tolerance 1e-4 relative / 1e-5 absolute, the JAX package's own MSDA bar:
float32 bilinear sampling and weighted sums in another order. The sampling
offsets are wide enough that samples land outside the grids (the zero
padding path).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sam_adapter_torch.engine.convert import msda as msda_pairs
from multimodal_sam_adapter_torch.models.init import init_weights_
from multimodal_sam_adapter_torch.ops.msda import (
    MSDeformAttention, msda_directional_bias_init)
from multimodal_sam_adapter_torch.ops.msda_cuda import (
    ms_deform_attn, ms_deform_attn_core_pytorch)
from multimodal_sam_adapter_tpu.ops import msda as jmsda
from tests._torch_parity import load, randomize
from tests.test_msda import make_inputs

TOL = dict(rtol=1e-4, atol=1e-5)
LEVELS = {
    "L3": ((16, 16), (8, 8), (4, 4)),
    "L1": ((8, 8),),
}


@pytest.mark.parametrize("levels", sorted(LEVELS))
def test_plain_core_matches_jax_ms_deform_attn(levels):
    shapes = LEVELS[levels]
    rng = np.random.default_rng(0)
    value, loc, att = make_inputs(rng, 2, 4, 8, 37, 4, shapes)
    want = np.asarray(jmsda.ms_deform_attn(
        jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(att)))
    got = ms_deform_attn_core_pytorch(
        torch.from_numpy(value), shapes, torch.from_numpy(loc),
        torch.from_numpy(att))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _flat_inputs(shapes, B=2, M=4, D=8, P=3, Lq=37, seed=3):
    rng = np.random.default_rng(seed)
    L = len(shapes)
    S = sum(h * w for h, w in shapes)
    value = rng.standard_normal((B, S, M * D)).astype(np.float32)
    offs = (rng.standard_normal((B, Lq, M * L * P * 2)) * 2).astype(
        np.float32)
    logits = rng.standard_normal((B, Lq, M * L * P)).astype(np.float32)
    ref = rng.uniform(size=(1, Lq, L, 2)).astype(np.float32)
    return value, offs, logits, ref


def _jax_oracle(value, offs, logits, ref, shapes, M, P):
    """The JAX module's XLA path from the flat projections (msda.py:414-456)."""
    B, S, MD = value.shape
    Lq, L = offs.shape[1], len(shapes)
    att = jax.nn.softmax(jnp.asarray(logits).reshape(B, Lq, M, L * P), -1)
    att = att.reshape(B, Lq, M, L, P)
    nm = jnp.asarray([[w, h] for h, w in shapes], jnp.float32)
    loc = (jnp.asarray(ref)[:, :, None, :, None, :]
           + jnp.asarray(offs).reshape(B, Lq, M, L, P, 2)
           / nm[None, None, None, :, None, :])
    return np.asarray(jmsda.ms_deform_attn(
        jnp.asarray(value).reshape(B, S, M, MD // M), shapes, loc, att))


@pytest.mark.parametrize("levels", sorted(LEVELS))
def test_wrapper_from_flat_projections_matches_jax(levels):
    shapes = LEVELS[levels]
    value, offs, logits, ref = _flat_inputs(shapes)
    want = _jax_oracle(value, offs, logits, ref, shapes, 4, 3)
    got = ms_deform_attn(torch.from_numpy(value), shapes,
                         torch.from_numpy(ref), torch.from_numpy(offs),
                         torch.from_numpy(logits), 4, 3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.slow
@pytest.mark.parametrize("levels", sorted(LEVELS))
def test_wrapper_matches_pallas_digit_kernel(levels):
    """Against the TPU kernels themselves (interpret mode): K3 for 3 levels,
    K4 for 1 level."""
    from multimodal_sam_adapter_tpu.ops.msda_pallas import (
        make_ms_deform_attn_flat)

    shapes = ((10, 14), (6, 8), (4, 4)) if levels == "L3" else ((10, 14),)
    value, offs, logits, ref = _flat_inputs(shapes, B=2, M=4, D=8, P=3)
    L, Lq = len(shapes), offs.shape[1]
    ref_T = ref.transpose(0, 2, 3, 1).reshape(1, L * 2, Lq)
    fn = make_ms_deform_attn_flat(shapes, 4, 3, interpret=True)
    want = np.asarray(fn(jnp.asarray(value), jnp.asarray(offs),
                         jnp.asarray(logits), jnp.asarray(ref_T)))
    got = ms_deform_attn(torch.from_numpy(value), shapes,
                         torch.from_numpy(ref), torch.from_numpy(offs),
                         torch.from_numpy(logits), 4, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("levels", sorted(LEVELS))
def test_module_matches_jax(levels):
    shapes = LEVELS[levels]
    L, C, M, P = len(shapes), 32, 4, 4
    S = sum(h * w for h, w in shapes)
    rng = np.random.default_rng(7)
    Lq = 50
    q = rng.standard_normal((2, Lq, C)).astype(np.float32)
    feat = rng.standard_normal((2, S, C)).astype(np.float32)
    ref = rng.uniform(size=(1, Lq, L, 2)).astype(np.float32)
    jm = jmsda.MSDeformAttention(d_model=C, n_levels=L, n_heads=M,
                                 n_points=P, ratio=0.5, impl="xla")
    args = (jnp.asarray(q), jnp.asarray(ref), jnp.asarray(feat), shapes)
    # std 0.5: offsets of a few level pixels, some samples off the grid
    v = randomize(jm.init(jax.random.PRNGKey(0), *args), 11, std=0.5)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jm.apply(v, *args))
    tm = load(MSDeformAttention(C, L, M, P, 0.5), msda_pairs(v["params"], "m"))
    with torch.no_grad():
        got = tm(torch.from_numpy(q), torch.from_numpy(ref),
                 torch.from_numpy(feat), shapes).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_reset_parameters_is_the_jax_init():
    """Zero offset / attention-weight kernels and the directional offset
    bias, as the JAX module initializes them."""
    jm = jmsda.MSDeformAttention(d_model=16, n_levels=3, n_heads=4,
                                 n_points=2, ratio=0.5, impl="xla")
    shapes = ((4, 4), (2, 2), (2, 2))
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 5, 16)),
                jnp.zeros((1, 5, 3, 2)), jnp.zeros((1, 24, 16)), shapes)
    tm = MSDeformAttention(16, 3, 4, 2, 0.5)
    init_weights_(tm, {}, torch.Generator().manual_seed(0))
    p = v["params"]
    for name in ("sampling_offsets", "attention_weights"):
        np.testing.assert_array_equal(
            getattr(tm, name).weight.detach().numpy(),
            np.asarray(p[name]["kernel"]).T)
        np.testing.assert_allclose(getattr(tm, name).bias.detach().numpy(),
                                   np.asarray(p[name]["bias"]), atol=1e-7)
    np.testing.assert_allclose(msda_directional_bias_init(4, 3, 2),
                               np.asarray(p["sampling_offsets"]["bias"]))
    assert tm.value_proj.weight.abs().sum() > 0
