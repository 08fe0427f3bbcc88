"""3xTF32, the float32 attention core of K1 and K2 on the card, modelled on
the CPU (csrc/rel_pos_attention_f32.cuh).

The kernel walks the keys in tiles of R whole grid rows (`f32_key_tiles`)
with an online softmax on exp2, its rel terms from the float32 tables by
float32 FMAs, and both products in 3xTF32 on .tf32 wgmma: S = Q K^T with
Q's and K's TF32 halves (big = tf32(x), small = tf32(x - big); a k8 step
adds a_big b_small + a_small b_big, then a_big b_big), and each tile's
P V with P's and V's halves, in a fresh accumulator added into O on the
CUDA cores. V^T holds each octet of keys in the order 0, 2, 4, 6, 1, 3, 5,
7, so that a thread's accumulator columns 2 t4, 2 t4 + 1 are its A
fragment's k positions t4, t4 + 4. `kernel_model` repeats that arithmetic
with torch float32 matmuls of the halves (a product of two TF32 values is
exact in float32), optionally adding each k8 product into its accumulator
by truncation, as the tensor cores do.

At small sizes (a 14x14 window, an 8x8 grid, a 10x10 grid with a resized
table, a 3x40 grid with one row a tile; head dims 16 and 64):

- the model lies within the float32 tolerance of the kernels
  (kernel_checks.TOLERANCES: 1e-4 + 1e-4 |want|) of the plain float32
  attention and of the JAX package's K1 / K2 (their Pallas kernels in
  interpret mode, as tests/test_torch_attention.py runs them); with
  truncating accumulators, within half of it;
- a one-pass TF32 mutant (a_big b_big alone) misses that tolerance;
- the key order of V^T and of P's fragments agree, the tiles cover every
  key once, and the plan's constants are the kernel source's.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sam_adapter_torch.ops import attention as ta
from multimodal_sam_adapter_torch.ops.flash_attention import (
    flash_attention_plain)
from multimodal_sam_adapter_torch.ops.window_attention import (
    window_attention_plain)
from tests._torch_tf32 import TOL, product, within

CSRC = (Path(__file__).resolve().parents[1] / "multimodal_sam_adapter_torch"
        / "csrc" / "rel_pos_attention_f32.cuh").read_text()
LOG2E = 1.4426950408889634
SEED = 19
# (name, kind, grid, table rows or None, heads, head dim, windows | batch)
CASES = [
    ("window14_d64", "window", (14, 14), None, 2, 64, 2),
    ("window14_d16", "window", (14, 14), None, 2, 16, 2),
    ("grid8_d64", "global", (8, 8), None, 2, 64, 1),
    ("grid8_d16", "global", (8, 8), None, 8, 16, 1),
    ("grid10_resized_d64", "global", (10, 10), 31, 2, 64, 1),
    ("grid10_resized_d16", "global", (10, 10), 31, 8, 16, 1),
    ("grid3x40_one_row_d64", "global", (3, 40), None, 2, 64, 1),
]
JAX_CASES = [c for c in CASES if c[0] != "grid3x40_one_row_d64"]


def inputs(case):
    """qkv (nb, N, 3 heads d) and the two rel-pos tables, float32, from
    numpy's generator seeded with SEED and the case's name."""
    name, _, (H, W), rows, heads, d, nb = case
    rng = np.random.default_rng([SEED, len(name), H, W, d])
    qkv = rng.standard_normal((nb, H * W, 3 * heads * d)).astype(np.float32)
    rph = (rng.standard_normal((rows or 2 * H - 1, d)) * 0.5).astype(
        np.float32)
    rpw = (rng.standard_normal((rows or 2 * W - 1, d)) * 0.5).astype(
        np.float32)
    return qkv, rph, rpw


def octet_order(keys: int) -> torch.Tensor:
    """The key at each k position of V^T (split_tile): each octet in the
    order 0, 2, 4, 6, 1, 3, 5, 7."""
    p = torch.arange(keys)
    r = p % 8
    return p - r + torch.where(r < 4, 2 * r, 2 * (r - 4) + 1)


def kernel_model(qkv, rph, rpw, hw, heads, scale, passes=3, truncate=False):
    """The float32 kernel's arithmetic on (nb, N, 3C) qkv over an hw grid,
    in torch float32 on the CPU: returns (nb, N, C)."""
    H, W = hw
    q, k, v = ta.split_heads(qkv, heads)
    BM, N, d = q.shape
    R, n_tiles = ta.f32_key_tiles(hw)
    BK, LD = ta.F32_TILE_KEYS, ta.F32_REL_LD
    th, tw = ta.rel_table_f32(rph, H), ta.rel_table_f32(rpw, W)
    qh, qw = torch.arange(N) // W, torch.arange(N) % W
    # prologue: q against the table row of each (query, key row / column),
    # in log2 units; rel_h's rows past H are -inf
    rel_h = torch.full((BM, N, LD), -torch.inf)
    rel_h[..., :H] = (q @ th.T)[:, torch.arange(N)[:, None],
                                qh[:, None] - torch.arange(H) + H - 1]
    rel_h[..., :H] *= LOG2E
    rel_w = (q @ tw.T)[:, torch.arange(N)[:, None],
                       qw[:, None] - torch.arange(W) + W - 1] * LOG2E
    c = torch.arange(BK)
    kr = c // W
    rw = torch.where(c < R * W, rel_w[..., c % W], -torch.inf)
    scale_log2 = (torch.tensor(scale, dtype=torch.float32)
                  * torch.tensor(LOG2E, dtype=torch.float32)).double()
    order = octet_order(BK)
    m = torch.full((BM, N), -torch.inf)
    lsum = torch.zeros(BM, N)
    o = torch.zeros(BM, N, d)
    for t in range(n_tiles):
        k0 = t * R * W
        n = min(BK, N - k0)
        kt, vt = torch.zeros(BM, BK, d), torch.zeros(BM, BK, d)
        kt[:, :n], vt[:, :n] = k[:, k0:k0 + n], v[:, k0:k0 + n]
        s = product(q, kt, passes, truncate)
        bias = rel_h[..., torch.clamp(t * R + kr, max=LD - 1)] + rw
        s = (s.double() * scale_log2 + bias.double()).float()   # fmaf
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        lsum = lsum * corr + p.sum(-1)
        pv = product(p[..., order], vt[:, order].transpose(1, 2), passes,
                     truncate)
        o = (o.double() * corr[..., None].double() + pv.double()).float()
        m = m_new
    return ta.merge_heads(o / lsum[..., None], heads)


def plain(case, qkv, rph, rpw):
    _, kind, hw, _, heads, d, _ = case
    args = tuple(map(torch.from_numpy, (qkv, rph, rpw)))
    if kind == "window":
        return window_attention_plain(*args, hw[0], heads, d ** -0.5)
    return flash_attention_plain(*args, hw, heads, d ** -0.5)


def model(case, qkv, rph, rpw, **kw):
    _, _, hw, _, heads, d, _ = case
    return kernel_model(*map(torch.from_numpy, (qkv, rph, rpw)), hw, heads,
                        d ** -0.5, **kw)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_model_matches_the_plain_float32_attention(case):
    qkv, rph, rpw = inputs(case)
    want = plain(case, qkv, rph, rpw)
    got = model(case, qkv, rph, rpw)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("case", [CASES[0], CASES[2], CASES[4], CASES[6]],
                         ids=lambda c: c[0])
def test_truncating_accumulators_keep_half_the_tolerance(case):
    """Each tile's products in a fresh accumulator that adds by truncation
    (24 k8 products at K = 64): within half the tolerance, so the
    tensor cores' rounding needs no more than the fresh accumulators."""
    qkv, rph, rpw = inputs(case)
    want = plain(case, qkv, rph, rpw)
    assert within(model(case, qkv, rph, rpw, truncate=True), want, 0.5)


def test_one_accumulator_over_many_tiles_loses_the_margin():
    """P V summed in one truncating accumulator over 4096 keys (K2's
    64^2 grid), as a bf16 kernel sums it, against the fresh accumulator of
    each 64-key tile added in float32: at the tolerance's scale the
    first's error grows with the keys, the second's does not."""
    g = torch.Generator().manual_seed(SEED)
    keys, d = 4096, 64
    p = torch.rand((64, keys), generator=g)   # softmax weights, max 1
    v = torch.randn((d, keys), generator=g)
    want = p.double() @ v.double().T
    one = product(p, v, truncate=True)
    tiles = torch.zeros(64, d)
    for k0 in range(0, keys, 64):
        tiles = (tiles.double() + product(
            p[:, k0:k0 + 64], v[:, k0:k0 + 64], truncate=True).double()
        ).float()
    # relative to the sum of the terms' magnitudes (what the output is
    # divided by: the softmax denominator over |v| ~ 1)
    norm = p.double().sum(-1, keepdim=True)
    err_one = ((one.double() - want).abs() / norm).max().item()
    err_tiles = ((tiles.double() - want).abs() / norm).max().item()
    assert err_tiles < 0.1 * TOL["rtol"]
    assert err_one > 4 * err_tiles


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_one_tf32_pass_misses_the_float32_tolerance(case):
    qkv, rph, rpw = inputs(case)
    want = plain(case, qkv, rph, rpw)
    assert not within(model(case, qkv, rph, rpw, passes=1), want)
    assert within(model(case, qkv, rph, rpw), want)


@pytest.fixture(scope="module")
def jax_outputs():
    """Each JAX case's output from the JAX package's K1 (window_attention_
    laneblock) or K2 (flash_attention_lane), interpret mode."""
    from multimodal_sam_adapter_tpu.ops.flash_attention import (
        flash_attention_lane)
    from multimodal_sam_adapter_tpu.ops.window_attention import (
        window_attention_laneblock)

    out = {}
    for case in JAX_CASES:
        name, kind, (H, W), _, heads, d, _ = case
        qkv, rph, rpw = inputs(case)
        jq, jh, jw = map(jnp.asarray, (qkv, rph, rpw))
        if kind == "window":
            o = window_attention_laneblock(jq, jh, jw, H, d ** -0.5,
                                           num_heads=heads, group=2,
                                           interpret=True)
        else:
            o = flash_attention_lane(jq, jq[:, :, :heads * d], jh, jw, (H, W),
                                     d ** -0.5, num_heads=heads,
                                     block_q=H * W // 2, block_k_rows=2,
                                     interpret=True)
        out[name] = np.asarray(o)
    return out


@pytest.mark.parametrize("case", JAX_CASES, ids=[c[0] for c in JAX_CASES])
def test_model_matches_the_jax_kernels(case, jax_outputs):
    qkv, rph, rpw = inputs(case)
    want = jax_outputs[case[0]]
    got = model(case, qkv, rph, rpw).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_v_transpose_order_is_the_p_fragment_order():
    """split_tile writes unit w of V^T (head-dim column n, octet a, half
    hh) from keys 8a + hh + 2i to positions 8a + 4hh + i; the consumer
    packs accumulator column 8j + 2 t4 + (e >> 1) as fragment e of k step
    j, whose k position is t4 + 4 (e >> 1). Both put key c at the same
    k position, the one `octet_order` gives."""
    keys = ta.F32_TILE_KEYS
    order = octet_order(keys)
    v_pos, p_pos = {}, {}
    for w in range(16):   # (a, hh) of one head-dim column
        a, hh = w >> 1, w & 1
        for i in range(4):
            v_pos[8 * a + hh + 2 * i] = 8 * a + 4 * hh + i
    for j in range(keys // 8):
        for t4 in range(4):
            for e in range(4):
                p_pos[8 * j + 2 * t4 + (e >> 1)] = 8 * j + t4 + 4 * (e >> 1)
    assert v_pos == p_pos
    assert sorted(v_pos) == list(range(keys))
    assert all(order[pos].item() == key for key, pos in v_pos.items())


@pytest.mark.parametrize("hw", [(64, 64), (50, 50), (14, 14), (10, 10),
                                (8, 8), (3, 40), (61, 5), (1, 1), (7, 64)])
def test_key_tiles_cover_every_key_once(hw):
    H, W = hw
    R, n = ta.f32_key_tiles(hw)
    assert 1 <= R <= H and R * W <= ta.F32_TILE_KEYS
    assert (n - 1) * R < H <= n * R
    # column c < R W of tile t: key t R W + c, grid row t R + c // W (rows
    # past H masked by rel_h's -inf, read at min(row, F32_REL_LD - 1))
    keys = [t * R * W + c for t in range(n) for c in range(R * W)
            if t * R + c // W < H]
    assert sorted(keys) == list(range(H * W))
    assert all(min(t * R + c // W, ta.F32_REL_LD - 1) >= H
               for t in range(n) for c in range(R * W)
               if t * R + c // W >= H)
    assert (R == 1) == (W > ta.F32_TILE_KEYS // 2 or H == 1)


@pytest.mark.parametrize("hw", [(65, 8), (8, 65), (0, 4)])
def test_key_tiles_refuse_a_grid_they_cannot_hold(hw):
    with pytest.raises(ValueError):
        ta.f32_key_tiles(hw)


def test_plan_constants_match_the_kernel_source():
    for name, value in (("kF32BlockQ", ta.F32_BLOCK_Q),
                        ("kF32TileKeys", ta.F32_TILE_KEYS),
                        ("kF32MaxSide", ta.F32_MAX_SIDE),
                        ("kF32RelLd", ta.F32_REL_LD),
                        ("kF32SmemMax", ta.F32_SMEM_MAX)):
        got = re.search(rf"constexpr int {name} = (\d+);", CSRC)
        assert got is not None and int(got.group(1)) == value, name
    # the rel rows hold a grid side and the -inf column
    assert ta.F32_REL_LD == ta.F32_MAX_SIDE + 1


def smem_bytes(d: int) -> int:
    """Shared memory of a float32 block at head width d, as the kernel's
    F32Layout lays it out: Q, two raw V slots, two stages of K's and V^T's
    TF32 halves, rel_h, rel_w (in stage 1 past K's big half where it
    fits), eight barrier slots and the 1024-byte alignment slack."""
    tile = ta.F32_TILE_KEYS * d * 4
    stage = 4 * tile
    rel = ta.F32_BLOCK_Q * ta.F32_REL_LD * 4
    bars_at = ta.F32_BLOCK_Q * d * 4 + 2 * tile + 2 * stage + rel + (
        0 if stage - tile >= rel else rel)
    return bars_at + 8 * 8 + 1024


@pytest.mark.parametrize("d", [16, 32, 64])
def test_shared_memory_fits_a_block(d):
    """F32Layout's bytes fit the 227 KB a block may take; at d = 64 only
    because rel_w lives in ready stage 1, past the slot of K's big half
    (which tile 1's load writes), until its rows are in registers (rel_w's
    33 KB beside it would not fit)."""
    need = smem_bytes(d)
    assert need <= ta.F32_SMEM_MAX
    rel = ta.F32_BLOCK_Q * ta.F32_REL_LD * 4
    tile = ta.F32_TILE_KEYS * d * 4
    assert (4 * tile - tile >= rel) == (d == 64)
    if d == 64:
        assert need == 230976 and need + rel > ta.F32_SMEM_MAX


def test_a_float32_table_of_the_grids_length_is_passed_as_is():
    t = torch.randn(27, 64)
    assert ta.rel_table_f32(t, 14).data_ptr() == t.data_ptr()
    resized = ta.rel_table_f32(torch.randn(127, 64), 50)
    assert resized.shape == (99, 64) and resized.is_contiguous()
    assert ta.rel_table_f32(t.to(torch.bfloat16), 14).dtype == torch.float32
