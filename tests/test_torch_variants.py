"""The JAX package's kernel variants against the port's plain K1 / K2 /
MSDA, on the CPU: each variant's Pallas kernel runs in interpret mode, and
the port's kernel of its family (window attention, global attention,
deformable attention sampling) serves it, since the port's plain versions
are what chip_smoke.py holds those CUDA kernels against.

- K1a window_attention_packed (qkvt (3, windows*heads, N, d) -> packed)
- K1b window_attention_fused (separate q, k, v (windows*heads, N, d))
- K2a flash_attention_rel_pos_diff (qkvt (3, batch*heads, N, d))
- K3a-K3d make_ms_deform_attn variants digit / onehot / gather / loads

The layout adapters (head split / merge) live here. Tolerance 1e-4
relative / 1e-5 absolute, the kernels' own parity bar: float32 attention
and bilinear sampling summed in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sam_adapter_torch.ops.flash_attention import (
    flash_attention_plain)
from multimodal_sam_adapter_torch.ops.msda_cuda import (
    ms_deform_attn_core_pytorch)
from multimodal_sam_adapter_torch.ops.window_attention import (
    window_attention_plain)
from multimodal_sam_adapter_tpu.ops import flash_attention as jflash
from multimodal_sam_adapter_tpu.ops import msda_pallas
from multimodal_sam_adapter_tpu.ops import window_attention as jwin
from tests.test_msda import make_inputs

TOL = dict(rtol=1e-4, atol=1e-5)


def _heads_to_qkv(q, k, v, heads):
    """(nb*heads, N, d) x 3 (head-minor) -> the raw (nb, N, 3*heads*d)
    projection the port's kernels read (feature s*C + h*d + dd)."""
    B, N, d = q.shape
    t = np.stack([q, k, v]).reshape(3, B // heads, heads, N, d)
    return np.ascontiguousarray(
        t.transpose(1, 3, 0, 2, 4).reshape(B // heads, N, 3 * heads * d))


def _packed_to_heads(o, heads):
    """(nb, N, heads*d) -> (nb*heads, N, d)."""
    nb, N, C = o.shape
    return o.reshape(nb, N, heads, C // heads).transpose(0, 2, 1, 3).reshape(
        nb * heads, N, C // heads)


def _attention_inputs(hw, nb, heads, d, seed):
    r = np.random.default_rng(seed)
    N = hw[0] * hw[1]
    q, k, v = (r.standard_normal((nb * heads, N, d)).astype(np.float32)
               for _ in range(3))
    rph = r.standard_normal((2 * hw[0] - 1, d)).astype(np.float32) * 0.5
    rpw = r.standard_normal((2 * hw[1] - 1, d)).astype(np.float32) * 0.5
    return q, k, v, rph, rpw


def _k1(variant):
    ws, windows, heads, d = 7, 3, 4, 32
    q, k, v, rph, rpw = _attention_inputs((ws, ws), windows, heads, d, 3)
    scale = d ** -0.5
    got = window_attention_plain(
        torch.from_numpy(_heads_to_qkv(q, k, v, heads)),
        torch.from_numpy(rph), torch.from_numpy(rpw), ws, heads,
        scale).numpy()
    if variant == "K1a":
        want = jwin.window_attention_packed(
            jnp.stack([q, k, v]), rph, rpw, ws, scale, num_heads=heads,
            group=2, interpret=True)
        return got, np.asarray(want)
    want = jwin.window_attention_fused(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), rph, rpw, ws, scale,
        group=2, interpret=True)
    return _packed_to_heads(got, heads), np.asarray(want)


def _k2():
    hw, nb, heads, d = (8, 6), 2, 2, 32
    q, k, v, rph, rpw = _attention_inputs(hw, nb, heads, d, 5)
    scale = d ** -0.5
    got = flash_attention_plain(
        torch.from_numpy(_heads_to_qkv(q, k, v, heads)),
        torch.from_numpy(rph), torch.from_numpy(rpw), hw, heads,
        scale).numpy()
    want = jflash.flash_attention_rel_pos_diff(
        jnp.stack([q, k, v]), rph, rpw, hw, scale, block_q=16,
        block_k_rows=2, interpret=True)
    return _packed_to_heads(got, heads), np.asarray(want)


def _k3(variant):
    shapes = ((10, 7), (5, 4))
    value, loc, att = make_inputs(np.random.default_rng(7), 1, 2, 32, 37, 2,
                                  shapes)
    got = ms_deform_attn_core_pytorch(
        torch.from_numpy(value), shapes, torch.from_numpy(loc),
        torch.from_numpy(att)).numpy()
    fn = msda_pallas.make_ms_deform_attn(shapes, variant=variant,
                                         interpret=True)
    return got, np.asarray(fn(jnp.asarray(value), jnp.asarray(loc),
                              jnp.asarray(att)))


VARIANTS = {
    "K1a_window_attention_packed": lambda: _k1("K1a"),
    "K1b_window_attention_fused": lambda: _k1("K1b"),
    "K2a_flash_attention_rel_pos": _k2,
    "K3a_msda_digit": lambda: _k3("digit"),
    "K3b_msda_onehot": lambda: _k3("onehot"),
    "K3c_msda_gather": lambda: _k3("gather"),
    "K3d_msda_loads": lambda: _k3("loads"),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_port_family_kernel_serves_variant(variant):
    with jax.default_matmul_precision("highest"):
        got, want = VARIANTS[variant]()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
