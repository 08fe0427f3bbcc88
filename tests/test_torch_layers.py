"""Port parity: nn/layers.py and utils/interpolate.py against the JAX
package, on the same numpy inputs, float32 on the CPU.

Tolerances: the two sides compute the same float32 formulas in another
order (flax takes LayerNorm moments as E[x^2] - E[x]^2 via matmuls, torch
by Welford), so agreement is to a few float32 ulps of O(1) values: 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sam_adapter_torch.nn import layers as tl
from multimodal_sam_adapter_torch.utils import interpolate as ti
from multimodal_sam_adapter_tpu.nn import layers as jl
from multimodal_sam_adapter_tpu.utils import interpolate as ji
from tests._torch_parity import load, nchw, nhwc, randomize

TOL = dict(rtol=1e-5, atol=1e-5)
# torch computes a resize's source coordinates in float32, the JAX package
# in float64: at coordinates near 100 the float32 ulp (~8e-6) moves the
# tap weights by that much, times tap differences of O(1)
RESIZE_TOL = dict(rtol=1e-4, atol=1e-4)


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            + 0.3).astype(np.float32)


def _jax(module, x, seed=1, **kw):
    v = randomize(module.init(jax.random.PRNGKey(0), jnp.asarray(x), **kw),
                  seed)
    return v, np.asarray(module.apply(v, jnp.asarray(x), **kw))


def test_layernorm_matches_flax():
    x = _x((2, 5, 7, 48))
    v, want = _jax(jl.LayerNorm(eps=1e-6), x)
    ln = torch.nn.LayerNorm(48, eps=1e-6)
    p = v["params"]["ln"]
    load(ln, [("m.weight", p["scale"]), ("m.bias", p["bias"])])
    np.testing.assert_allclose(ln(torch.from_numpy(x)).detach().numpy(),
                               want, **TOL)


def test_layernorm2d_is_the_trailing_axis_layernorm_of_nhwc():
    x = _x((2, 5, 7, 48), seed=2)
    v, want = _jax(jl.LayerNorm(eps=1e-6), x)
    p = v["params"]["ln"]
    ln2d = load(tl.LayerNorm2d(48),
                [("m.weight", p["scale"]), ("m.bias", p["bias"])])
    np.testing.assert_allclose(nhwc(ln2d(nchw(x))), want, **TOL)


def test_bias_free_layernorm_matches_flax():
    x = _x((3, 10, 24), seed=3)
    v, want = _jax(jl.BiasFreeLayerNorm(), x)
    m = load(tl.BiasFreeLayerNorm(24), [("m.weight",
                                         v["params"]["scale"])])
    np.testing.assert_allclose(m(torch.from_numpy(x)).detach().numpy(),
                               want, **TOL)


@pytest.mark.parametrize("norm,act", [("bn", "relu"), ("gn", "relu"),
                                      (None, "gelu"), ("bn", None)])
def test_conv_norm_act_matches_flax(norm, act):
    x = _x((2, 9, 9, 16), seed=4)
    jm = jl.ConvNormAct(features=32, kernel_size=(3, 3), padding=1,
                        norm=norm, act=act, gn_groups=8)
    v, want = _jax(jm, x, train=False)
    p, s = v["params"], v.get("batch_stats", {})
    pairs = [("m.conv.weight", p["conv"]["kernel"].transpose(3, 2, 0, 1))]
    if norm is None:
        pairs.append(("m.conv.bias", p["conv"]["bias"]))
    elif norm == "bn":
        bn, st = p["norm"]["bn"], s["norm"]["bn"]
        pairs += [("m.bn.weight", bn["scale"]), ("m.bn.bias", bn["bias"]),
                  ("m.bn.running_mean", st["mean"]),
                  ("m.bn.running_var", st["var"]),
                  ("m.bn.num_batches_tracked", np.asarray(0))]
    else:
        gn = p["norm"]["gn"]
        pairs += [("m.gn.weight", gn["scale"]), ("m.gn.bias", gn["bias"])]
    m = load(tl.ConvNormAct(16, 32, 3, padding=1, norm=norm, act=act,
                            gn_groups=8), pairs)
    with torch.no_grad():
        np.testing.assert_allclose(nhwc(m(nchw(x))), want, **TOL)


def test_gelu_is_exact_erf_like_the_f32_jax_path():
    x = _x((1000,), seed=5, scale=3.0)
    np.testing.assert_allclose(tl.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jl.gelu(jnp.asarray(x))), **TOL)


def test_h_swish_scale_scale2_and_droppath_in_eval():
    x, y = _x((4, 6), seed=6), _x((4, 6), seed=7)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_allclose(tl.h_swish(tx).numpy(),
                               np.asarray(jl.h_swish(jnp.asarray(x))), **TOL)
    v, want = _jax(jl.Scale(0.5), x)
    s = load(tl.Scale(), [("m.scale", v["params"]["scale"])])
    np.testing.assert_allclose(s(tx).detach().numpy(), want, **TOL)
    j2 = jl.Scale2()
    v2 = randomize(j2.init(jax.random.PRNGKey(0), jnp.asarray(x),
                           jnp.asarray(y)), 8)
    want2 = np.asarray(j2.apply(v2, jnp.asarray(x), jnp.asarray(y)))
    s2 = load(tl.Scale2(), [("m.scale1", v2["params"]["scale1"]),
                            ("m.scale2", v2["params"]["scale2"])])
    np.testing.assert_allclose(s2(tx, ty).detach().numpy(), want2, **TOL)
    dp = tl.DropPath(0.3).eval()
    assert dp(tx) is tx


@pytest.mark.parametrize("src,dst", [((16, 16), (64, 64)),
                                     ((16, 16), (8, 8)),
                                     ((12, 20), (30, 7))])
def test_resize_bilinear_and_bicubic_match_jax(src, dst):
    x = _x((2, *src, 5), seed=9)
    for t_fn, j_fn in ((ti.resize_bilinear, ji.resize_bilinear),
                       (ti.resize_bicubic, ji.resize_bicubic)):
        want = np.asarray(j_fn(jnp.asarray(x), dst))
        np.testing.assert_allclose(nhwc(t_fn(nchw(x), dst)), want,
                                   **RESIZE_TOL)


@pytest.mark.parametrize("src,dst", [(27, 27), (127, 63), (13, 31)])
def test_interp_linear_1d_matches_jax(src, dst):
    table = _x((src, 16), seed=10)
    want = np.asarray(ji.interp_linear_1d(jnp.asarray(table), dst))
    got = ti.interp_linear_1d(torch.from_numpy(table), dst).numpy()
    np.testing.assert_allclose(got, want, **RESIZE_TOL)
