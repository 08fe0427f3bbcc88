"""The Python side of K6's kernels, on the CPU: the launch plan that its
wrapper hands csrc/pixel_shuffle.cu (`pixel_shuffle_plan`), checked at every
shape the port runs K6 at.

- The bf16 tiles (128 pixels of one c2 row x 128 product columns; the
  kernel's tile walk emulated here) cover every (pixel, column) of the
  product exactly once, each within one c2 row, so that each tile's output
  is one box of 2 output rows; the persistent grid visits every tile once.
  (The float32 kernel's grouped walk: tests/test_torch_tf32_pixel_shuffle.py.)
- The instantiation chosen for each c1 / x1 layout pair, and the
  `ValueError` for an operand TMA cannot take, in both dtypes.
- Every plan's shared memory fits a block (227 KB), and the plan's
  constants are the kernel source's.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import kernel_checks as kc
from multimodal_sam_adapter_torch.ops import pixel_shuffle as ps

CSRC = (Path(ps.__file__).resolve().parent.parent / "csrc" /
        "pixel_shuffle.cu").read_text()
BF16 = torch.bfloat16

# (B, H, W, E): the flagship (1024^2: a 128x128 c2 grid), FMB's 800^2
# (100x100), `whole` mode's 1024x1824 (128x228), slide's batch of 3 crops,
# deliver_tiny's 64^2 (8x8, embed 32) and two odd test widths
SHAPES = ((1, 128, 128, 1024), (1, 100, 100, 1024), (1, 128, 228, 1024),
          (3, 128, 128, 1024), (1, 8, 8, 32), (2, 8, 8, 32), (2, 5, 12, 64))


def _ids(shapes):
    return ["x".join(map(str, s)) for s in shapes]


def _nchw(B, O, OH, OW):
    return (O * OH * OW, OH * OW, OW, 1)


def _channels_last(B, O, OH, OW):
    return (OH * OW * O, 1, OW * O, O)


def _plan(B, H, W, E, c1=_nchw, x1=_channels_last, dtype=BF16, sms=ps.SMS):
    shape = (B, E, 2 * H, 2 * W)
    return ps.pixel_shuffle_plan(B, H, W, E, E, c1(*shape), x1(*shape), dtype,
                                 sms)


def tile_coords(tile, B, H, W, O):
    """The kernel's walk: tile -> (column tile, image, c2 row, first pixel),
    column tiles fastest."""
    n_cols = 4 * O // ps.TILE_N
    row_tiles = -(-W // ps.TILE_M)
    col = tile % n_cols
    r = tile // n_cols
    w0 = (r % row_tiles) * ps.TILE_M
    r //= row_tiles
    return col, r // H, r % H, w0


@pytest.mark.parametrize("B,H,W,E", SHAPES, ids=_ids(SHAPES))
def test_row_tiles_cover_every_product_element_once(B, H, W, E):
    plan = _plan(B, H, W, E)
    assert (plan.tile_m, plan.tile_n) == (ps.TILE_M, ps.TILE_N)
    assert plan.tiles == B * H * -(-W // ps.TILE_M) * (4 * E // ps.TILE_N)
    assert plan.grid == min(plan.tiles, ps.SMS)
    seen = np.zeros((B, H, W, 4 * E), dtype=np.int32)
    visits = np.zeros(plan.tiles, dtype=np.int32)
    for block in range(plan.grid):   # the persistent walk
        for tile in range(block, plan.tiles, plan.grid):
            visits[tile] += 1
            col, b, h, w0 = tile_coords(tile, B, H, W, E)
            assert b < B and h < H and w0 < W
            # one c2 row; TMA clips the columns past W (a ragged row tile)
            n0 = col * ps.TILE_N
            seen[b, h, w0:w0 + ps.TILE_M, n0:n0 + ps.TILE_N] += 1
    assert (visits == 1).all()
    assert (seen == 1).all()


def test_tile_counts_at_the_ports_shapes():
    # 32 column tiles (1024 channels x 4 phases / 128) a row tile
    assert _plan(1, 128, 128, 1024).tiles == 128 * 32
    assert _plan(3, 128, 128, 1024).tiles == 3 * 128 * 32
    assert _plan(1, 100, 100, 1024).tiles == 100 * 32   # one ragged tile a row
    assert _plan(1, 128, 228, 1024).tiles == 128 * 2 * 32   # 128 + 100
    assert _plan(1, 8, 8, 32).tiles == 8   # one column tile, 8 of 128 pixels
    assert _plan(1, 8, 8, 32).grid == 8
    assert _plan(1, 128, 128, 1024, sms=114).grid == 114


@pytest.mark.parametrize("c1,x1,want", [
    (_nchw, _nchw, (ps.NCHW, ps.NCHW)),
    (_nchw, _channels_last, (ps.NCHW, ps.CHANNELS_LAST)),
    (_channels_last, _nchw, (ps.CHANNELS_LAST, ps.NCHW)),
    (_channels_last, _channels_last, (ps.CHANNELS_LAST, ps.CHANNELS_LAST)),
])
def test_instantiation_for_each_layout_pair(c1, x1, want):
    plan = _plan(1, 128, 128, 1024, c1=c1, x1=x1)
    assert (plan.c1_layout, plan.x1_layout) == want
    # the kernel source instantiates every pair, by c1_layout * 2 + x1_layout
    case = want[0] * 2 + want[1]
    names = {ps.NCHW: "kNchw", ps.CHANNELS_LAST: "kChannelsLast"}
    pat = (rf"(case {case}:|default:)\s*return msa::launch_bf16<"
           rf"msa::{names[want[0]]},\s*msa::{names[want[1]]}>")
    assert re.search(pat, CSRC)


def test_layouts_of_the_kernel_cases():
    """kernel_checks builds c1 and x1 as the forwards on the card hand them
    over (the flagship: both NCHW; slide's batch 3: x1 channels-last), and
    its cases reach every instantiation."""
    g = torch.Generator().manual_seed(0)
    want = {"flagship": (ps.NCHW, ps.NCHW), "fmb": (ps.NCHW, ps.NCHW),
            "batch3": (ps.NCHW, ps.CHANNELS_LAST),
            "whole_128x228": (ps.NCHW, ps.NCHW),
            "swapped_layouts": (ps.CHANNELS_LAST, ps.NCHW),
            "channels_last": (ps.CHANNELS_LAST, ps.CHANNELS_LAST),
            "tiny": (ps.NCHW, ps.CHANNELS_LAST)}
    for label, kw in (("flagship", {}),) + kc.PIXEL_SHUFFLE_RAGGED:
        kw = dict(kw)
        kw.pop("grid", None)
        kw.pop("E", None)
        for dtype in (BF16, torch.float32):
            _, (c2, w, c1, x1, _, _) = kc.pixel_shuffle_case(4, 32, dtype, g,
                                                             **kw)
            B, C, H, W = c2.shape
            plan = ps.pixel_shuffle_plan(B, H, W, C, w.shape[1],
                                         ps._strides(c1), ps._strides(x1),
                                         dtype)
            assert (plan.c1_layout, plan.x1_layout) == want[label], label
    assert set(want.values()) == {(a, b) for a in (0, 1) for b in (0, 1)}


@pytest.mark.parametrize("dtype,strides,match", [
    (BF16, (1024 * 256 * 6, 256 * 6, 6, 1), "multiples of 8"),   # OW = 6
    (BF16, (256 * 6 * 1024, 1, 6 * 1024, 1028), "multiples of 8"),
    (BF16, (1024 * 256 * 256, 256 * 256, 1, 256), "NCHW or channels-last"),
    (BF16, (2 * 1024 * 256 * 256, 2 * 256 * 256, 2 * 256, 2),
     "NCHW or channels"),
    # float32: 16 bytes are 4 values (OW = 2 and 1026 are not multiples)
    (torch.float32, (1024 * 256 * 2, 256 * 2, 2, 1), "multiples of 4"),
    (torch.float32, (256 * 6 * 1024, 1, 6 * 1024, 1026), "multiples of 4"),
    (torch.float32, (1024 * 256 * 256, 256 * 256, 1, 256),
     "NCHW or channels-last"),
    (torch.float32, (2 * 1024 * 256 * 256, 2 * 256 * 256, 2 * 256, 2),
     "NCHW or channels"),
])
def test_plan_refuses_operands_tma_cannot_take(dtype, strides, match):
    ok = _nchw(1, 1024, 256, 256)
    with pytest.raises(ValueError, match=match):
        ps.pixel_shuffle_plan(1, 128, 128, 1024, 1024, strides, ok, dtype)
    with pytest.raises(ValueError, match="x1"):
        ps.pixel_shuffle_plan(1, 128, 128, 1024, 1024, ok, strides, dtype)


def test_float32_takes_the_strides_bf16_refuses():
    """TMA's 16 bytes are 4 float32 values: OW = 4 and a channels-last
    pixel stride of 1028 are float32 operands the kernel takes."""
    for strides in ((1024 * 256 * 4, 256 * 4, 4, 1),
                    (256 * 6 * 1024, 1, 6 * 1024, 1028)):
        with pytest.raises(ValueError, match="multiples of 8"):
            ps.operand_layout("c1", strides, BF16)
        ok = _nchw(1, 1024, 256, 256)
        plan = ps.pixel_shuffle_plan(1, 128, 128, 1024, 1024, strides, ok,
                                     torch.float32)
        assert plan.c1_layout == ps.operand_layout("c1", strides,
                                                   torch.float32)


@pytest.mark.parametrize("C,O", [(12, 32), (32, 48), (0, 32)])
def test_plan_refuses_widths_the_kernels_cannot_take(C, O):
    shape = (1, O, 16, 16)
    with pytest.raises(ValueError):
        ps.pixel_shuffle_plan(1, 8, 8, C, O, _nchw(*shape), _nchw(*shape),
                              BF16)


def test_plan_refuses_other_dtypes():
    shape = (1, 32, 16, 16)
    with pytest.raises(TypeError):
        ps.pixel_shuffle_plan(1, 8, 8, 32, 32, _nchw(*shape), _nchw(*shape),
                              torch.float16)


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
@pytest.mark.parametrize("B,H,W,E", SHAPES, ids=_ids(SHAPES))
def test_every_plan_fits_shared_memory(B, H, W, E, dtype):
    plan = _plan(B, H, W, E, dtype=dtype)
    assert 0 < plan.smem_bytes <= ps.SMEM_LIMIT == 227 * 1024
    # both dtypes: the same tiles, persistent blocks, the layouts' pair
    assert (plan.tile_m, plan.tile_n) == (ps.TILE_M, ps.TILE_N)
    assert plan.tiles == B * H * -(-W // ps.TILE_M) * (4 * E // ps.TILE_N)
    assert plan.grid == min(plan.tiles, ps.SMS)
    assert (plan.c1_layout, plan.x1_layout) == (ps.NCHW, ps.CHANNELS_LAST)
    if dtype == torch.float32:   # the ring alone; w_split's halves
        assert plan.smem_bytes == ps.f32_smem_bytes() == 198656
        assert plan.scratch == (2, 4 * E, E)
    else:
        assert plan.smem_bytes == ps.bf16_smem_bytes()
        assert plan.scratch == ()


def test_plan_constants_match_the_kernel_source():
    for name, value in (("kPsTileM", ps.TILE_M), ("kPsTileN", ps.TILE_N),
                        ("kPsDepth", ps.DEPTH), ("kPsStages", ps.STAGES),
                        ("kPsF32Depth", ps.F32_DEPTH),
                        ("kPsF32Stages", ps.F32_STAGES),
                        ("kPsF32Group", ps.F32_GROUP)):
        got = re.search(rf"constexpr int {name} = (\d+);", CSRC)
        assert got is not None and int(got.group(1)) == value, name
    # both layouts end in 1 KB of barriers and 1 KB of alignment slack
    assert CSRC.count("kBytes = kBars + 1024 + 1024") == 2
    assert ps.bf16_smem_bytes() == 231424
    assert ps.f32_smem_bytes() == 198656


def test_batch_stride_of_a_single_image():
    """A view's size-1 batch may report any stride; the wrapper hands the
    kernel the image's span (a multiple of 16 bytes) instead."""
    c = torch.zeros(1, 100, 64)
    c2 = c[:, :64].transpose(1, 2).reshape(1, 64, 8, 8)
    assert ps._strides(c2)[0] == 64 * 64
    x = torch.zeros(3, 64, 8, 8)
    assert ps._strides(x) == x.stride()


def test_k6_bound_scales_with_the_batch():
    def meta(*shape, dtype=BF16):
        return torch.empty(shape, dtype=dtype, device="meta")

    def args(B):
        E = kc.EMBED
        c2 = meta(B, 128 * 128, E).transpose(1, 2).reshape(B, E, 128, 128)
        return (c2, meta(E, E, 2, 2), meta(B, E, 256, 256),
                meta(B, E, 256, 256), meta(E, dtype=torch.float32),
                meta(E, dtype=torch.float32)), meta(B, E, 256, 256)

    one, _ = kc.bound_ms("pixel_shuffle_up_bn", *args(1))
    three, by = kc.bound_ms("pixel_shuffle_up_bn", *args(3))
    assert by == "operations" and three == pytest.approx(3 * one)
