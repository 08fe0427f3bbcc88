"""Port parity: ops/attention.py, the plain versions of K1 (windowed) and K2
(global) attention, and ViTBlock, against the JAX package on the CPU.

K1 and K2 are held against the JAX package's Pallas kernels run in
interpret mode, at the shapes of tests/test_window_attention.py and
tests/test_flash_attention.py. Tolerance 1e-4 relative / 1e-5 absolute (the
kernels' own parity bar): float32 softmax attention whose two sides sum in
another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sam_adapter_torch.models.sam_vit import ViTBlock
from multimodal_sam_adapter_torch.ops import attention as ta
from multimodal_sam_adapter_torch.ops.flash_attention import flash_attention
from multimodal_sam_adapter_torch.ops.window_attention import (
    window_attention)
from multimodal_sam_adapter_torch.engine.convert import vit_block
from multimodal_sam_adapter_tpu.models import sam_vit as jvit
from multimodal_sam_adapter_tpu.ops import attention as ja
from tests._torch_parity import load, randomize

TOL = dict(rtol=1e-4, atol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def test_window_partition_roundtrip_matches_jax():
    x = _rng(0).standard_normal((2, 10, 10, 8)).astype(np.float32)
    jw, jpad = ja.window_partition(jnp.asarray(x), 7)
    tw, tpad = ta.window_partition(torch.from_numpy(x), 7)
    assert tpad == jpad == (14, 14)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    back = ta.window_unpartition(tw, 7, tpad, (10, 10))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("q,k,rows", [(14, 14, 27), (64, 64, 127),
                                      (32, 32, 127), (7, 14, 27)])
def test_get_rel_pos_matches_jax(q, k, rows):
    table = _rng(1).standard_normal((rows, 16)).astype(np.float32)
    want = np.asarray(ja.get_rel_pos(q, k, jnp.asarray(table)))
    got = ta.get_rel_pos(q, k, torch.from_numpy(table)).numpy()
    # a resized table: torch's float32 source coordinates, see
    # tests/test_torch_layers.py
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_attention_with_decomposed_rel_pos_matches_jax():
    r = _rng(2)
    B, H, W, d = 3, 6, 5, 16
    q, k, v = (r.standard_normal((B, H * W, d)).astype(np.float32)
               for _ in range(3))
    rph = r.standard_normal((2 * H - 1, d)).astype(np.float32) * 0.5
    rpw = r.standard_normal((2 * W - 1, d)).astype(np.float32) * 0.5
    want = np.asarray(ja.attention_with_decomposed_rel_pos(
        *map(jnp.asarray, (q, k, v, rph, rpw)), (H, W), d ** -0.5))
    got = ta.attention_with_decomposed_rel_pos(
        *map(torch.from_numpy, (q, k, v, rph, rpw)), (H, W), d ** -0.5)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("ws,windows,heads,group", [(7, 3, 4, 2),
                                                    (14, 2, 16, 2)])
def test_k1_plain_matches_pallas_laneblock_kernel(ws, windows, heads, group):
    from multimodal_sam_adapter_tpu.ops.window_attention import (
        window_attention_laneblock)

    r = _rng(5)
    d, N = 32, ws * ws
    qkv = r.standard_normal((windows, N, 3 * heads * d)).astype(np.float32)
    rph = r.standard_normal((2 * ws - 1, d)).astype(np.float32) * 0.5
    rpw = r.standard_normal((2 * ws - 1, d)).astype(np.float32) * 0.5
    want = np.asarray(window_attention_laneblock(
        jnp.asarray(qkv), jnp.asarray(rph), jnp.asarray(rpw), ws,
        d ** -0.5, num_heads=heads, group=group, interpret=True))
    got = window_attention(*map(torch.from_numpy, (qkv, rph, rpw)), ws,
                           heads, d ** -0.5)
    assert got.shape == (windows, N, heads * d)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("blk_q,blk_kr", [(16, 8), (16, 2)])
def test_k2_plain_matches_pallas_lane_flash_kernel(blk_q, blk_kr):
    from multimodal_sam_adapter_tpu.ops.flash_attention import (
        flash_attention_lane)

    r = _rng(1)
    B, H, W, M, d = 1, 8, 8, 8, 32
    N = H * W
    qkv = r.standard_normal((B, N, 3 * M * d)).astype(np.float32)
    rph = r.standard_normal((2 * H - 1, d)).astype(np.float32) * 0.5
    rpw = r.standard_normal((2 * W - 1, d)).astype(np.float32) * 0.5
    jq = jnp.asarray(qkv)
    want = np.asarray(flash_attention_lane(
        jq, jq[:, :, :M * d], jnp.asarray(rph), jnp.asarray(rpw), (H, W),
        d ** -0.5, num_heads=M, block_q=blk_q, block_k_rows=blk_kr,
        interpret=True))
    got = flash_attention(*map(torch.from_numpy, (qkv, rph, rpw)), (H, W), M,
                          d ** -0.5)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("window,grid,input_size", [
    (7, (10, 10), (7, 7)),     # windowed, 10x10 zero-padded to 14x14
    (0, (8, 8), (8, 8)),       # global
    (0, (8, 8), (16, 16)),     # global, tables resized from 31 to 15 rows
])
def test_vit_block_matches_jax(window, grid, input_size):
    dim, heads = 64, 4
    H, W = grid
    x = _rng(3).standard_normal((2, H * W, dim)).astype(np.float32)
    jm = jvit.ViTBlock(dim=dim, num_heads=heads, window_size=window,
                       input_size=input_size)
    v = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), H, W), 4,
                  std=0.1)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jm.apply(v, jnp.asarray(x), H, W))
    tm = load(ViTBlock(dim, heads, window_size=window, input_size=input_size),
              vit_block(v["params"], "m"))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), H, W).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
