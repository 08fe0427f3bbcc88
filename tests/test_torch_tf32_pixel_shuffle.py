"""3xTF32, K6's float32 f1 assembly on the card, modelled on the CPU
(csrc/pixel_shuffle.cu: pixel_shuffle_split_kernel, then
pixel_shuffle_tf32_kernel).

The kernel computes f1 = (depth_to_space(c2 @ W) + c1 + x1) * scale +
shift, product column n = o * 4 + dy * 2 + dx being channel o of output
pixel (2h + dy, 2w + dx). .tf32 wgmma has no transpose, so a first launch
writes the weight (C x 4O, MN-major) K-major as its TF32 halves, w_split
(2, 4O, C) = [big, small] (cvt.rna). Each consumer thread splits its A
(c2) fragment in registers; a k8 step adds a_big b_small + a_small b_big,
then a_big b_big into a fresh accumulator for each 32-k stage of the ring,
and the CUDA cores add each stage's accumulator into the tile's float32
sum. The epilogue adds c1 and x1 and applies the affine in float32, each
thread's accumulator pairs (the two dx phases of one channel and output
row) going to their interleaved output pixels. `kernel_model` repeats that
arithmetic in torch (tests/_torch_tf32.py: a product of two TF32 values is
exact in float32), adding each k8 product into its accumulator by
truncation, as the tensor cores do.

On numpy-seeded inputs (C in {32, 96, 256}, a ragged width W = 133: a
128-pixel row tile and one of 5, batch 2):

- the model lies within the float32 tolerance of the kernels
  (kernel_checks.TOLERANCES: 1e-4 + 1e-4 |want|) of the plain float32
  version and of the JAX package's Pallas kernel (interpret mode, as
  tests/test_torch_pixel_shuffle.py runs it);
- a one-pass TF32 mutant (a_big b_big alone) misses that tolerance, and
  one truncating accumulator over the whole reduction errs in proportion
  to C (30x the staged error at C = 1024), where the staged does not;
- w_split's order, the A fragment's reads from the swizzled tile, the
  epilogue's map from accumulator registers to output pixels, the grouped
  tile walk (every product element once at ragged W), the plan's
  constants and its shared memory are the kernel source's.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sam_adapter_torch.ops import pixel_shuffle as ps
from multimodal_sam_adapter_tpu.ops.pixel_shuffle import (
    pixel_shuffle_up_bn as jax_pixel_shuffle_up_bn)
from tests._torch_parity import nchw, nhwc
from tests._torch_tf32 import TOL, product, split, within

CSRC = (Path(ps.__file__).resolve().parent.parent / "csrc" /
        "pixel_shuffle.cu").read_text()
SEED = 20
SMEM_LIMIT = 232448
# (C, O) on a 3 x 133 c2 grid at batch 2
CASES = [(32, 64), (96, 64), (256, 32)]
B, H, W = 2, 3, 133


def _ids(cases):
    return [f"C{c}_O{o}" for c, o in cases]


def inputs(C: int, O: int):
    """c2 (B, H, W, C), weight (C, O, 2, 2) ~ 1/sqrt(C), c1 and x1 (B, 2H,
    2W, O), scale and shift (O,), float32 numpy, seeded with SEED, C, O."""
    r = np.random.default_rng([SEED, C, O])
    c2 = r.standard_normal((B, H, W, C)).astype(np.float32)
    weight = (r.standard_normal((C, O, 2, 2)) * C ** -0.5).astype(np.float32)
    c1 = r.standard_normal((B, 2 * H, 2 * W, O)).astype(np.float32)
    x1 = r.standard_normal((B, 2 * H, 2 * W, O)).astype(np.float32)
    scale = (1 + 0.5 * r.standard_normal(O)).astype(np.float32)
    shift = r.standard_normal(O).astype(np.float32)
    return c2, weight, c1, x1, scale, shift


def port_args(c2, weight, c1, x1, scale, shift):
    """The port's operands: NCHW maps, torch's (C, O, 2, 2) weight."""
    return (nchw(c2), torch.from_numpy(weight), nchw(c1), nchw(x1),
            torch.from_numpy(scale), torch.from_numpy(shift))


def split_weight(weight: torch.Tensor) -> torch.Tensor:
    """pixel_shuffle_split_kernel: the weight (C, O, 2, 2), row-major C x
    4O, transposed to K-major (4O, C) and split: (2, 4O, C)."""
    big, small = split(weight.reshape(weight.shape[0], -1).T.contiguous())
    return torch.stack([big, small])


def kernel_model(c2, weight, c1, x1, scale, shift, passes=3, truncate=True,
                 stage=ps.F32_DEPTH):
    """The float32 kernel's arithmetic on the port's operands: returns
    (B, O, 2H, 2W). Each `stage` of the reduction is a fresh accumulator
    (the ring's 32 k; stage=C: one accumulator over all of it), added into
    the float32 sum."""
    Bn, C, Hn, Wn = c2.shape
    O = weight.shape[1]
    a = c2.permute(0, 2, 3, 1).reshape(-1, C)       # pixel rows of C
    big, small = split_weight(weight)   # B's halves, as w_split holds them
    acc = torch.zeros(a.shape[0], 4 * O)
    for k0 in range(0, C, stage):
        ks = slice(k0, k0 + stage)
        acc = acc + product(a[:, ks], (big[:, ks], small[:, ks]), passes,
                            truncate)
    # column n = o * 4 + dy * 2 + dx -> channel o of pixel (2h + dy, 2w + dx)
    y = acc.reshape(Bn, Hn, Wn, O, 2, 2).permute(0, 3, 1, 4, 2, 5).reshape(
        Bn, O, 2 * Hn, 2 * Wn)
    return ((y + c1) + x1) * scale[:, None, None] + shift[:, None, None]


@pytest.fixture(scope="module")
def jax_outputs():
    """Each case's f1 from the JAX package's Pallas kernel, interpret mode,
    as the port's NCHW."""
    out = {}
    for C, O in CASES:
        c2, weight, c1, x1, scale, shift = inputs(C, O)
        with jax.default_matmul_precision("highest"):
            o = jax_pixel_shuffle_up_bn(
                jnp.asarray(c2), jnp.asarray(weight.transpose(0, 2, 3, 1)),
                jnp.asarray(c1), jnp.asarray(x1), jnp.asarray(scale),
                jnp.asarray(shift), interpret=True)
        out[C, O] = nchw(np.asarray(o))
    return out


@pytest.mark.parametrize("C,O", CASES, ids=_ids(CASES))
def test_model_matches_the_plain_float32_version(C, O):
    args = port_args(*inputs(C, O))
    want = ps.pixel_shuffle_up_bn_plain(*args)
    got = kernel_model(*args)
    assert got.shape == want.shape == (B, O, 2 * H, 2 * W)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("C,O", CASES, ids=_ids(CASES))
def test_model_matches_the_jax_kernel(C, O, jax_outputs):
    got = kernel_model(*port_args(*inputs(C, O)))
    torch.testing.assert_close(got, jax_outputs[C, O], **TOL)


@pytest.mark.parametrize("C,O", CASES, ids=_ids(CASES))
def test_truncating_accumulators_keep_a_tenth_of_the_tolerance(C, O):
    """With a fresh accumulator a stage (12 truncating adds at most), the
    model is as close to the plain version as without truncation."""
    args = port_args(*inputs(C, O))
    want = ps.pixel_shuffle_up_bn_plain(*args)
    assert within(kernel_model(*args), want, 0.1)
    assert within(kernel_model(*args, truncate=False), want, 0.1)


@pytest.mark.parametrize("C,O", CASES, ids=_ids(CASES))
def test_one_tf32_pass_misses_the_float32_tolerance(C, O):
    args = port_args(*inputs(C, O))
    want = ps.pixel_shuffle_up_bn_plain(*args)
    assert not within(kernel_model(*args, passes=1), want)
    assert within(kernel_model(*args), want)


def _share(got, want):
    """The largest error as a share of the float32 tolerance."""
    bound = TOL["atol"] + TOL["rtol"] * want.abs()
    return ((got.double() - want).abs() / bound).max().item()


def test_one_accumulator_over_the_reduction_loses_the_margin():
    """The flagship's C = 1024 (and 256), 128 pixels x 128 columns: one
    truncating accumulator over all of C errs in proportion to C (~0.05 of
    the tolerance at 256, ~0.2 at 1024), a fresh one a 32-k stage stays
    at ~0.007 (the truncation of 12 adds), so the staged kernel keeps its
    margin at any C the port runs, the single accumulator would not."""
    shares = {}
    for C in (256, 1024):
        r = np.random.default_rng([SEED, C])
        a = torch.from_numpy(r.standard_normal((128, C)).astype(np.float32))
        b = torch.from_numpy((r.standard_normal((128, C)) * C ** -0.5)
                             .astype(np.float32))
        want = a.double() @ b.double().T
        staged = torch.zeros(128, 128)
        for k0 in range(0, C, ps.F32_DEPTH):
            staged = staged + product(a[:, k0:k0 + ps.F32_DEPTH],
                                      b[:, k0:k0 + ps.F32_DEPTH],
                                      truncate=True)
        shares[C] = (_share(product(a, b, truncate=True), want),
                     _share(staged, want))
    (one_256, staged_256), (one_1024, staged_1024) = shares[256], shares[1024]
    assert staged_256 < 0.02 and staged_1024 < 0.02
    assert one_1024 > 3 * one_256          # grows with the reduction
    assert one_1024 > 10 * staged_1024


def test_w_split_is_the_weight_k_major_in_tf32_halves():
    """w_split[h, n, k] is half h of weight[k, n // 4, (n // 2) % 2, n % 2]:
    column n = o * 4 + dy * 2 + dx, K innermost (what the B map's 3-d box
    reads); big holds 11 significant bits, big + small the value to
    2^-21."""
    C, O = 40, 32   # C not a multiple of the 32-k stage (TMA fills zeros)
    w = torch.from_numpy(np.random.default_rng([SEED, 0]).standard_normal(
        (C, O, 2, 2)).astype(np.float32))
    ws = split_weight(w)
    assert ws.shape == (2, 4 * O, C) == ps.pixel_shuffle_plan(
        1, 2, 2, C, O, (4 * O * 16, 16, 4, 1), (4 * O * 16, 16, 4, 1),
        torch.float32).scratch
    n = torch.arange(4 * O)
    for k in (0, 17, C - 1):
        want = w[k, n // 4, (n // 2) % 2, n % 2]
        torch.testing.assert_close(ws[0, :, k] + ws[1, :, k], want,
                                   rtol=2.0 ** -21, atol=0)
        assert torch.equal(ws[0, :, k], split(want)[0])
    assert ((ws.view(torch.int32) & 0x1FFF) == 0).all()


def test_a_fragment_reads_the_wgmma_layout():
    """TMA's 128-byte swizzle puts 16-byte unit u of A's row r (32 float32
    values) at unit u ^ (r % 8). The consumer thread (warp, g, t4) reads
    a_s[r * 32 + ((u ^ g) << 2) + t4], r = 16 warp + g + 8 (e & 1), u = 2 ks
    + (e >> 1), for fragment e of k8 step ks: .tf32 m64nNk8's A layout,
    a0 (g, t4), a1 (g + 8, t4), a2 (g, t4 + 4), a3 (g + 8, t4 + 4)."""
    rows = 64
    a = torch.arange(rows * 32).reshape(rows, 32)   # A[r][k] = 32 r + k
    tile = torch.empty(rows * 32, dtype=torch.long)
    for r in range(rows):
        for u in range(8):
            tile[r * 32 + ((u ^ (r % 8)) << 2):][:4] = a[r, 4 * u:4 * u + 4]
    banks = set()
    for warp in range(4):
        for lane in range(32):
            g, t4 = lane >> 2, lane & 3
            for ks in range(4):
                for e in range(4):
                    r = warp * 16 + g + 8 * (e & 1)
                    u = 2 * ks + (e >> 1)
                    got = tile[r * 32 + ((u ^ g) << 2) + t4].item()
                    row = warp * 16 + g + 8 * (e & 1)
                    col = 8 * ks + t4 + 4 * (e >> 1)
                    assert got == a[row, col].item()
            if warp == 0:   # ks = 0, e = 0: a warp's 32 loads, 32 banks
                banks.add(((g * 32 + ((0 ^ g) << 2) + t4) % 32))
    assert len(banks) == 32


def test_epilogue_registers_cover_the_tile_once():
    """Accumulator 4 j + 2 i + dx of thread (warp, g, t4) is pixel 16 warp
    + g + 8 i, column 8 j + 2 t4 + dx of a warpgroup's 64 x 128 tile; the
    epilogue takes it as channel 2 j + (t4 >> 1), phase (t4 & 1, dx),
    which is column n = o * 4 + dy * 2 + dx. Every (pixel, column) once."""
    seen = np.zeros((64, ps.TILE_N), dtype=np.int32)
    for warp in range(4):
        for lane in range(32):
            g, t4 = lane >> 2, lane & 3
            for reg in range(ps.TILE_N // 2):
                j, i, dx = reg // 4, (reg // 2) % 2, reg % 2
                m = 16 * warp + g + 8 * i
                n = 8 * j + 2 * t4 + dx
                seen[m, n] += 1
                ch, dy = 2 * j + (t4 >> 1), t4 & 1
                assert n == ch * 4 + dy * 2 + dx
    assert (seen == 1).all()


def f32_tile_coords(tile, Bn, Hn, Wn, O):
    """pixel_shuffle_tf32_kernel's walk: tile -> (column tile, image, c2
    row, first pixel), groups of F32_GROUP row tiles, rows fastest within a
    group."""
    n_cols = 4 * O // ps.TILE_N
    row_tiles = -(-Wn // ps.TILE_M)
    rows = Bn * Hn * row_tiles
    g0 = tile // (ps.F32_GROUP * n_cols) * ps.F32_GROUP
    in_group = min(ps.F32_GROUP, rows - g0)
    local = tile - g0 * n_cols
    r = g0 + local % in_group
    col = local // in_group
    return col, r // row_tiles // Hn, r // row_tiles % Hn, (
        r % row_tiles) * ps.TILE_M


# (B, H, W, E): the flagship, FMB's 100x100, `whole` mode's 128x228,
# slide's batch 3, the test widths, and this file's ragged 3 x 133
WALKS = ((1, 128, 128, 1024), (1, 100, 100, 1024), (1, 128, 228, 1024),
         (3, 128, 128, 1024), (2, 8, 8, 32), (2, 3, 133, 64),
         (1, 37, 5, 256))


@pytest.mark.parametrize("Bn,Hn,Wn,E", WALKS,
                         ids=["x".join(map(str, s)) for s in WALKS])
def test_grouped_walk_covers_every_product_element_once(Bn, Hn, Wn, E):
    # c1 and x1 channels-last: an odd W's NCHW rows (2W values) are no
    # multiple of 16 bytes, which the plan refuses
    cl = (4 * Hn * Wn * E, 1, 2 * Wn * E, E)
    plan = ps.pixel_shuffle_plan(Bn, Hn, Wn, E, E, cl, cl, torch.float32)
    assert plan.tiles == Bn * Hn * -(-Wn // ps.TILE_M) * (4 * E // ps.TILE_N)
    assert plan.grid == min(plan.tiles, ps.SMS)
    seen = np.zeros((Bn, Hn, Wn, 4 * E), dtype=np.int32)
    for block in range(plan.grid):   # the persistent walk
        for tile in range(block, plan.tiles, plan.grid):
            col, b, h, w0 = f32_tile_coords(tile, Bn, Hn, Wn, E)
            assert b < Bn and h < Hn and w0 < Wn
            n0 = col * ps.TILE_N   # TMA clips the pixels past W
            seen[b, h, w0:w0 + ps.TILE_M, n0:n0 + ps.TILE_N] += 1
    assert (seen == 1).all()


def test_tiles_in_flight_share_their_operands():
    """At the flagship, each wave of 132 tiles touches at most 2 groups of
    16 row tiles and 10 column slabs of w_split (1 MB each): ~16 MB of c2
    and w_split kept in L2, where N fastest spans all 32 slabs (33.5 MB)."""
    tiles = 128 * 32
    for w0 in range(0, tiles, ps.SMS):
        wave = [f32_tile_coords(t, 1, 128, 128, 1024)
                for t in range(w0, min(w0 + ps.SMS, tiles))]
        assert len({h for _, _, h, _ in wave}) <= 2 * ps.F32_GROUP
        assert len({c for c, _, _, _ in wave}) <= 10


def test_plan_constants_match_the_kernel_source():
    """The float32 constants the model and the walk above use (the tile's
    are held by tests/test_torch_pixel_shuffle_plan.py)."""
    for name, value in (("kPsF32Depth", ps.F32_DEPTH),
                        ("kPsF32Stages", ps.F32_STAGES),
                        ("kPsF32Group", ps.F32_GROUP)):
        got = re.search(rf"constexpr int {name} = (\d+);", CSRC)
        assert got is not None and int(got.group(1)) == value, name
    # a stage's 32 k are one 128-byte row: the swizzle and the k8 steps
    assert ps.F32_DEPTH * 4 == 128
    assert "WgmmaTf32<kPsTileN>::run" in CSRC


def test_shared_memory_fits_a_block():
    """PsF32Smem: A (128 pixels) and B's two halves (128 columns) of 32 k
    a stage, 4 stages, 1 KB of barriers, 1 KB of alignment slack; no c1,
    x1 or staging box (the epilogue reads L2 and writes from registers).
    A fifth stage would not fit, nor would bf16's three 64 KB boxes in
    float32 beside two stages."""
    stage = ps.TILE_M * ps.F32_DEPTH * 4 + 2 * ps.TILE_N * ps.F32_DEPTH * 4
    assert stage == 48 * 1024
    need = ps.F32_STAGES * stage + 1024 + 1024
    assert need == ps.f32_smem_bytes() == 198656 <= SMEM_LIMIT
    assert need + stage > SMEM_LIMIT
    assert 2 * stage + 3 * ps.TILE_M * ps.TILE_N * 4 > SMEM_LIMIT
    assert "static_assert(PsF32Smem::kBytes <= 232448" in CSRC
