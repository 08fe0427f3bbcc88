"""K5 on the CPU: the port's plain fused ConvNeXt block against the JAX
package's Pallas kernel (interpret mode) and its XLA composition, and the
channels-last twin ConvNeXt against the JAX TwinConvNeXt.

The port's block returns x + delta (the kernel adds the shortcut in its
epilogue); the JAX functions return the pre-residual delta, so the
comparison adds x to theirs. Weights are drawn with numpy from a seed and
moved to torch's layouts: the depthwise kernel (7, 7, 1, C) HWIO -> (C, 1,
7, 7), the dense kernels (C, HID) -> the Linear weight (HID, C).

Tolerances: the block at 1e-4 (float32, sums in another order; the Pallas
kernel's erf is a polynomial good to 1.5e-7); the trunk at rtol 1e-3 /
atol 2e-4, the full-model bar.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sam_adapter_torch.engine import convert
from multimodal_sam_adapter_torch.models.twin_convnext import TwinConvNeXt
from multimodal_sam_adapter_torch.ops import kernels
from multimodal_sam_adapter_torch.ops.convnext_block import (
    convnext_block, convnext_block_plain)
from multimodal_sam_adapter_tpu.models import twin_convnext as jtwin
from multimodal_sam_adapter_tpu.ops.convnext_block import (
    _reference_delta, convnext_block_fused_fwd)
from tests._torch_parity import load, nchw, nhwc, randomize

TOL = dict(rtol=1e-4, atol=1e-4)


def _block_inputs(B, H, C, seed):
    r = np.random.default_rng(seed)
    hid = 4 * C

    def n(*shape, s=1.0):
        return (r.standard_normal(shape) * s).astype(np.float32)

    x = n(B, H, H, C)
    p = dict(dw=n(7, 7, 1, C, s=0.1), dw_b=n(C, s=0.1),
             ln_g=1 + n(C, s=0.1), ln_b=n(C, s=0.1),
             w1=n(C, hid, s=C ** -0.5), b1=n(hid, s=0.1),
             w2=n(hid, C, s=hid ** -0.5), b2=n(C, s=0.1), gamma=n(C, s=0.5))
    return x, p


def _torch_args(x, p):
    t = torch.from_numpy
    return (t(x), t(np.ascontiguousarray(p["dw"].transpose(3, 2, 0, 1))),
            t(p["dw_b"]), t(p["ln_g"]), t(p["ln_b"]),
            t(np.ascontiguousarray(p["w1"].T)), t(p["b1"]),
            t(np.ascontiguousarray(p["w2"].T)), t(p["b2"]), t(p["gamma"]))


@pytest.mark.parametrize("C,H", [(16, 8), (16, 16), (40, 8), (40, 16),
                                 (13, 8)])
def test_plain_block_matches_pallas_kernel_and_reference(C, H):
    x, p = _block_inputs(2, H, C, seed=C + H)
    got = convnext_block_plain(*_torch_args(x, p)).numpy()
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    with jax.default_matmul_precision("highest"):
        fused = np.asarray(convnext_block_fused_fwd(
            jnp.asarray(x), **jp, interpret=True))
        ref = np.asarray(_reference_delta(jnp.asarray(x), **jp))
    np.testing.assert_allclose(got, x + fused, **TOL)
    np.testing.assert_allclose(got, x + ref, **TOL)


def test_cpu_tensor_takes_the_plain_version_without_a_launch():
    x, p = _block_inputs(1, 8, 16, seed=0)
    args = _torch_args(x, p)
    kernels.reset_launches()
    got = convnext_block(*args)
    assert kernels.LAUNCHES["convnext_block"] == 0
    torch.testing.assert_close(got, convnext_block_plain(*args))


@pytest.mark.parametrize("hw", [(64, 64), (96, 32)])
def test_channels_last_twin_convnext_matches_jax(hw):
    """Atto trunk; 96 x 32 gives stage maps of 24 x 8 ... 3 x 1."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    y = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    jm = jtwin.TwinConvNeXt(arch="atto")
    v = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                          jnp.asarray(y)), 2)
    with jax.default_matmul_precision("highest"):
        want = jm.apply(v, jnp.asarray(x), jnp.asarray(y))
    p = v["params"]
    tm = load(TwinConvNeXt("atto"),
              [*convert.convnext_branch(p["branch_x"], "m", "x"),
               *convert.convnext_branch(p["branch_y"], "m", "y")])
    with torch.no_grad():
        got = tm(nchw(x), nchw(y))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == (2, w.shape[3], w.shape[1], w.shape[2])
        np.testing.assert_allclose(nhwc(g), np.asarray(w), rtol=1e-3,
                                   atol=2e-4)
