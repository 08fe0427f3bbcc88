"""The Python side of the bf16 attention kernels (K1, K2), on the CPU: the
tile plan their wrappers hand the kernels, the tables they read, and the
bounds and yardstick that `chip_smoke.py` reports beside their times.

- `window_keys_per_tile` / `global_key_tiles`: every key of a window or a
  grid lands in exactly one tile slot; `window_expansion`: K1's bias rows
  (split into bf16 hi + lo, divided by the scale, slot 15 the mask) times
  its 0/1 tiles give every key's bias to 3e-4 and mask the padding keys
  (`emulate_window_scores`); `emulate_global_tiles` walks K2's
  tiles as the kernel does (two grid rows a tile, columns past 2W masked,
  the rel_w terms fixed per column, only rel_h per tile, online softmax)
  and must give the plain version's output (float32, 1e-5).
- `rel_table_parts`: a bf16 table of the grid's own length is passed as
  is; any other is resized in float32 and split into bf16 (hi, lo) that
  sum to it within 2^-16 relative, the resized rows being get_rel_pos's.
- `kernel_checks.work` / `bound_ms` at the flagship shapes (meta tensors:
  nothing allocated), and `library_case` computing the plain function.
"""
import math

import numpy as np
import pytest
import torch

import kernel_checks as kc
from multimodal_sam_adapter_torch.ops.attention import (
    attention_with_decomposed_rel_pos, get_rel_pos, merge_heads,
    rel_pos_bias_terms, rel_table_parts, resized_rel_table, split_heads)
from multimodal_sam_adapter_torch.ops.flash_attention import (
    GLOBAL_TILE_KEYS, GLOBAL_TILE_ROWS, global_key_tiles)
from multimodal_sam_adapter_torch.ops.window_attention import (
    EXPANSION_SLOTS, WINDOW_TILES, window_expansion, window_keys_per_tile)


@pytest.mark.parametrize("ws", range(1, 15))
def test_window_tile_holds_the_whole_window(ws):
    bk = window_keys_per_tile(ws)
    assert bk in WINDOW_TILES and bk % 16 == 0 and ws * ws <= bk
    smaller = [t for t in WINDOW_TILES if t < bk]
    assert all(ws * ws > t for t in smaller)
    if ws == 14:   # SAM: 196 keys, 12 of them padding
        assert bk == 208


def test_window_tile_refuses_a_window_it_cannot_hold():
    with pytest.raises(ValueError):
        window_keys_per_tile(15)


@pytest.mark.parametrize("hw,tiles", [((64, 64), 32), ((50, 50), 25),
                                      ((10, 12), 5), ((5, 4), 3),
                                      ((1, 64), 1), ((4, 4), 2)])
def test_global_tiles_cover_every_key_once(hw, tiles):
    H, W = hw
    assert global_key_tiles(hw) == tiles
    # the kernel's key slots: tile t, column c < 2W -> key 2 t W + c
    assert GLOBAL_TILE_ROWS * W <= GLOBAL_TILE_KEYS
    keys = [GLOBAL_TILE_ROWS * t * W + c for t in range(tiles)
            for c in range(GLOBAL_TILE_ROWS * W)]
    keys = [k for k in keys if k < H * W]
    assert sorted(keys) == list(range(H * W))


@pytest.mark.parametrize("hw", [(65, 8), (8, 65), (0, 4)])
def test_global_tiles_refuse_a_grid_they_cannot_hold(hw):
    with pytest.raises(ValueError):
        global_key_tiles(hw)


def _hi_lo(x):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def emulate_window_scores(q, k, rph, rpw, ws, scale):
    """K1's scores of one window in log2 units, as the kernel forms them:
    s = (q.k + A_h E_h^T + A_w E_w^T) * scale * log2(e), the A rows being a
    query's rel terms / scale in bf16 hi + lo parts, slot 15 of A_h the
    mask. q, k: (N, d) with N = ws^2."""
    log2e = 1.4426950408889634
    bk = window_keys_per_tile(ws)
    e = window_expansion(ws, bk)
    rel_h, rel_w = rel_pos_bias_terms(q[None], rph, rpw, (ws, ws), (ws, ws))
    N = ws * ws
    a_h = torch.zeros(N, EXPANSION_SLOTS)
    a_w = torch.zeros(N, EXPANSION_SLOTS)
    a_h[:, :ws] = rel_h.reshape(N, ws) / scale
    a_w[:, :ws] = rel_w.reshape(N, ws) / scale
    a_h[:, EXPANSION_SLOTS - 1] = -10000.0 / (scale * log2e)
    kt = torch.zeros(bk, q.shape[1])
    kt[:N] = k
    s = q @ kt.T
    for a, tile in ((a_h, e[0]), (a_w, e[1])):
        for part in _hi_lo(a):
            s = s + part @ tile.T
    return s * scale * log2e


@pytest.mark.parametrize("ws", [14, 7, 2])
def test_window_expansion_adds_every_bias_and_masks_the_padding(ws):
    g = torch.Generator().manual_seed(3)
    d = 64
    N = ws * ws
    q, k = (torch.randn((N, d), generator=g) for _ in range(2))
    rph = torch.randn((2 * ws - 1, d), generator=g) * 0.5
    rpw = torch.randn((2 * ws - 1, d), generator=g) * 0.5
    got = emulate_window_scores(q, k, rph, rpw, ws, d ** -0.5)
    rel_h, rel_w = rel_pos_bias_terms(q[None], rph, rpw, (ws, ws), (ws, ws))
    want = (q @ k.T * d ** -0.5 + (rel_h[..., :, None] + rel_w[..., None, :])
            .reshape(N, N)) * 1.4426950408889634
    # hi + lo keep 16 bits of a bias row |a| ~ 50: 50 x 2^-16 x scale x
    # log2(e) ~ 1.4e-4 in log2 units, a relative 1e-4 on a softmax weight
    torch.testing.assert_close(got[:, :N], want, rtol=1e-4, atol=3e-4)
    assert bool((got[:, N:] < -9000).all())
    assert window_expansion(ws, window_keys_per_tile(ws)).sum() == 2 * N + (
        window_keys_per_tile(ws) - N)


@pytest.mark.parametrize("ws,keys", [(16, 256), (9, 64)])
def test_window_expansion_refuses_what_it_cannot_hold(ws, keys):
    with pytest.raises(ValueError):
        window_expansion(ws, keys)


def emulate_global_tiles(q, k, v, th, tw, hw, scale):
    """K2's tile walk in float32 torch: q, k, v (BM, N, d); th, tw the
    resized (2H - 1, d), (2W - 1, d) tables."""
    H, W = hw
    BM, N, d = q.shape
    # the prologue: q against every table row, moved to key cells
    qt_h = q @ th.T                                     # (BM, N, 2H - 1)
    qt_w = q @ tw.T
    qh = torch.arange(N) // W
    qw = torch.arange(N) % W
    kh = torch.arange(H)
    kw = torch.arange(W)
    rel_h = qt_h[:, torch.arange(N)[:, None], (qh[:, None] - kh + H - 1)]
    rel_w = qt_w[:, torch.arange(N)[:, None], (qw[:, None] - kw + W - 1)]
    # each column's kw is fixed for the whole walk
    c = torch.arange(GLOBAL_TILE_KEYS)
    upper = c >= W
    col_w = torch.where(c < 2 * W, rel_w[..., (c - W * upper) % W],
                        torch.tensor(-math.inf))
    m = torch.full((BM, N), -math.inf)
    lsum = torch.zeros(BM, N)
    o = torch.zeros(BM, N, d)
    for t in range(global_key_tiles(hw)):
        k0 = GLOBAL_TILE_ROWS * t * W
        kt = torch.zeros(BM, GLOBAL_TILE_KEYS, d)
        vt = torch.zeros(BM, GLOBAL_TILE_KEYS, d)
        n = min(GLOBAL_TILE_KEYS, N - k0)
        kt[:, :n], vt[:, :n] = k[:, k0:k0 + n], v[:, k0:k0 + n]
        lo = rel_h[..., 2 * t]
        hi = (rel_h[..., 2 * t + 1] if 2 * t + 1 < H
              else torch.full_like(lo, -math.inf))
        s = (q @ kt.transpose(1, 2)) * scale + torch.where(
            upper, hi[..., None], lo[..., None]) + col_w
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        lsum = lsum * corr + p.sum(-1)
        o = o * corr[..., None] + p @ vt
        m = m_new
    return o / lsum[..., None]


@pytest.mark.parametrize("hw,rows", [((6, 5), None), ((5, 7), 21),
                                     ((4, 4), None), ((3, 8), 9)])
def test_global_tile_walk_matches_plain(hw, rows):
    g = torch.Generator().manual_seed(0)
    H, W = hw
    BM, d = 3, 16
    q, k, v = (torch.randn((BM, H * W, d), generator=g) for _ in range(3))
    rph = torch.randn((rows or 2 * H - 1, d), generator=g) * 0.5
    rpw = torch.randn((rows or 2 * W - 1, d), generator=g) * 0.5
    want = attention_with_decomposed_rel_pos(q, k, v, rph, rpw, hw,
                                             d ** -0.5)
    got = emulate_global_tiles(q, k, v, resized_rel_table(rph, H),
                               resized_rel_table(rpw, W), hw, d ** -0.5)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_a_bf16_table_of_the_grids_length_is_passed_as_is():
    t = torch.randn(27, 64).to(torch.bfloat16)
    parts = rel_table_parts(t, 14)
    assert parts.shape == (1, 27, 64) and parts.dtype == torch.bfloat16
    assert parts.data_ptr() == t.data_ptr()


@pytest.mark.parametrize("rows,size,dtype", [
    (127, 50, torch.bfloat16), (127, 50, torch.float32),
    (27, 14, torch.float32), (27, 7, torch.bfloat16)])
def test_other_tables_come_as_hi_lo_parts_of_the_resized_table(rows, size,
                                                               dtype):
    g = torch.Generator().manual_seed(1)
    t = (torch.randn((rows, 64), generator=g) * 0.5).to(dtype)
    parts = rel_table_parts(t, size)
    assert parts.shape == (2, 2 * size - 1, 64)
    assert parts.dtype == torch.bfloat16
    want = resized_rel_table(t.float(), size)
    got = parts[0].float() + parts[1].float()
    err = (got - want).abs().max().item()
    assert err <= 2.0 ** -16 * want.abs().max().item()
    # the resized rows are the ones get_rel_pos gathers: row qh - kh + G - 1
    gathered = get_rel_pos(size, size, t.float())
    idx = torch.arange(size)[:, None] - torch.arange(size)[None] + size - 1
    torch.testing.assert_close(gathered, want[idx], rtol=0, atol=0)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_attention_bounds_at_the_flagship_shapes():
    d = kc.EMBED // kc.HEADS
    k1 = (_meta(25, 196, 3 * kc.EMBED), _meta(27, d), _meta(27, d),
          kc.WINDOW, kc.HEADS, d ** -0.5)
    ms, by = kc.bound_ms("window_attention", k1, _meta(25, 196, kc.EMBED))
    # 40.1 MB of qkv and output at 3.35 TB/s
    w = kc.work("window_attention", k1, _meta(25, 196, kc.EMBED))
    assert w["bytes"] == pytest.approx(40.1e6, rel=2e-3)
    assert by == "bytes" and ms == pytest.approx(w["bytes"] / 3.35e9)
    k2 = (_meta(1, 4096, 3 * kc.EMBED), _meta(127, d), _meta(127, d),
          (64, 64), kc.HEADS, d ** -0.5)
    ms, by = kc.bound_ms("flash_attention", k2, _meta(1, 4096, kc.EMBED))
    w = kc.work("flash_attention", k2, _meta(1, 4096, kc.EMBED))
    # 69.8 GFLOP of products on the tensor cores
    assert w["tensor_ops"] == pytest.approx(69.8e9, rel=2e-3)
    assert by == "operations" and ms == pytest.approx(
        w["tensor_ops"] / 989e9)
    # float32: the same products on the CUDA cores
    ms32, _ = kc.bound_ms("flash_attention", k2,
                          _meta(1, 4096, kc.EMBED, dtype=torch.float32))
    assert ms32 > 10 * ms


def test_bounds_of_the_other_kernels_at_the_flagship_shapes():
    E = kc.EMBED
    c2 = _meta(1, 128 * 128, E).transpose(1, 2).reshape(1, E, 128, 128)
    k6 = (c2, _meta(E, E, 2, 2), _meta(1, E, 256, 256),
          _meta(1, E, 256, 256), _meta(E, dtype=torch.float32),
          _meta(E, dtype=torch.float32))
    ms, by = kc.bound_ms("pixel_shuffle_up_bn", k6, _meta(1, E, 256, 256))
    assert by == "operations" and ms == pytest.approx(0.139, rel=0.01)
    x = _meta(1, 64, 64, 384)
    k5 = (x, _meta(384, 1, 7, 7), *(_meta(384) for _ in range(3)),
          _meta(1536, 384), _meta(1536), _meta(384, 1536),
          _meta(384), _meta(384))
    ms, by = kc.bound_ms("convnext_block", k5, x)
    assert by == "operations" and ms == pytest.approx(
        2 * 2 * 4096 * 384 * 1536 / 989e9)
    S = sum(h * w for h, w in kc.PYRAMID)
    k3 = (_meta(1, S, 512), kc.PYRAMID,
          _meta(1, 4096, 3, 2, dtype=torch.float32),
          _meta(1, 4096, 16 * 3 * 4 * 2), _meta(1, 4096, 16 * 3 * 4), 16, 4)
    ms, by = kc.bound_ms("msda_multi_level", k3, _meta(1, 4096, 512))
    assert by == "bytes" and 0.008 < ms < 0.011


@pytest.mark.parametrize("name,kw", [
    ("window_attention", dict(grid=20)),
    ("flash_attention", dict(grid=9, table_rows=21))])
def test_library_case_computes_the_plain_function(name, kw):
    g = torch.Generator().manual_seed(2)
    fn, args = kc.attention_case(name, torch.float32, g, **kw)
    want = fn(*args)
    lfn, largs = kc.library_case(name, args)
    q, k, v, bias, _ = largs
    B, N, C = want.shape
    assert all(t.is_contiguous() and t.shape == (B, kc.HEADS, N, C //
                                                 kc.HEADS) for t in (q, k, v))
    assert bias.shape == (B, kc.HEADS, N, N)
    got = merge_heads(lfn(*largs).reshape(B * kc.HEADS, N, -1), kc.HEADS)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    # the bias is from the unscaled q: the same terms the plain version adds
    qs = split_heads(args[0], kc.HEADS)[0]
    hw = (args[3], args[3]) if isinstance(args[3], int) else args[3]
    rel_h, rel_w = rel_pos_bias_terms(qs, args[1], args[2], hw, hw)
    np.testing.assert_allclose(
        bias.reshape(B * kc.HEADS, N, N)[:, 0, :hw[1]].numpy(),
        (rel_h[:, 0, 0, 0, None] + rel_w[:, 0, 0, :]).numpy(), rtol=1e-5,
        atol=1e-5)
