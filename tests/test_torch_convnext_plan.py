"""The Python side of K5's bf16 kernels, on the CPU: the launch plan that
its wrapper hands csrc/convnext_block.cu, the output buffer, and its bound.

- The prologue's tiles (tile_h x 8 pixels; the kernel's `block_tile` /
  `tile_pixel` index math emulated here) cover every pixel exactly once,
  give >= 132 blocks wherever the map has >= 132 x 8 pixels, and keep
  their float32 dwconv outputs within the tile's shared memory.
- fc1's and fc2's tile grids cover every (pixel, hidden unit) and (pixel,
  channel) element exactly once, at widths the C source instantiates; the
  scratch is (P, C) and (P, HID).
- `out=` and kernel_checks' guarded buffer on the plain path.
- `kernel_checks.work` / `bound_ms` at the four flagship stages (meta
  tensors: nothing allocated).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import kernel_checks as kc
from multimodal_sam_adapter_torch.ops import convnext_block as cb

CSRC = (Path(cb.__file__).resolve().parent.parent / "csrc" /
        "convnext_block.cu").read_text()

# (B, H, W, C): the four flagship stages, the ragged FMB and test widths,
# batch 3 (slide), the atto trunk of a 64^2 and a 96x32 test input, and
# the block tests' C = 16
SHAPES = (
    *((1, hw, hw, c) for hw, c in kc.CONVNEXT_STAGES),
    *((1, hw, hw, c) for hw, c in kc.CONVNEXT_RAGGED),
    (3, 25, 25, 768),
    (2, 16, 16, 40), (2, 8, 8, 80), (2, 4, 4, 160), (2, 2, 2, 320),
    (2, 24, 8, 40), (2, 12, 4, 80), (2, 6, 2, 160), (2, 3, 1, 320),
    (2, 8, 8, 16), (2, 16, 16, 16),
)


def _ids(shapes):
    return ["x".join(map(str, s)) for s in shapes]


def prologue_pixels(B, H, W, tile_h):
    """The flat pixel of every (block, tile row) the prologue stores, as
    the kernel's block_tile and tile_pixel compute it."""
    tw_n = -(-W // cb.PROLOGUE_TILE_W)
    th_n = -(-H // tile_h)
    t = np.arange(cb.prologue_blocks(B, H, W, tile_h))[:, None]
    p = np.arange(tile_h * cb.PROLOGUE_TILE_W)[None, :]
    b = t // (th_n * tw_n)
    r = t - b * th_n * tw_n
    h = (r // tw_n) * tile_h + p // cb.PROLOGUE_TILE_W
    w = (r % tw_n) * cb.PROLOGUE_TILE_W + p % cb.PROLOGUE_TILE_W
    inside = (h < H) & (w < W)
    return ((b * H + h) * W + w)[inside]


@pytest.mark.parametrize("B,H,W,C", SHAPES, ids=_ids(SHAPES))
def test_prologue_tiles_cover_every_pixel_once(B, H, W, C):
    plan = cb.convnext_block_plan(B, H, W, C, 4 * C)
    assert plan.tile_h in cb.PROLOGUE_TILE_ROWS
    assert plan.tile_h * cb.PROLOGUE_TILE_W * C <= cb.PROLOGUE_TILE_VALUES
    pix = prologue_pixels(B, H, W, plan.tile_h)
    np.testing.assert_array_equal(np.sort(pix), np.arange(B * H * W))
    if B * H * W >= cb.SMS * 8:
        assert cb.prologue_blocks(B, H, W, plan.tile_h) >= cb.SMS
    # the largest tile that fits and still gives SMS blocks
    larger = [t for t in cb.PROLOGUE_TILE_ROWS if t > plan.tile_h and
              t * cb.PROLOGUE_TILE_W * C <= cb.PROLOGUE_TILE_VALUES]
    assert all(cb.prologue_blocks(B, H, W, t) < cb.SMS for t in larger)


def _coverage(P, N, bn):
    nx, ny = cb.fc_grid(P, N, bn)
    seen = np.zeros((ny * cb.FC_ROWS, nx * bn), dtype=np.int32)
    for by in range(ny):
        for bx in range(nx):
            seen[by * cb.FC_ROWS:(by + 1) * cb.FC_ROWS,
                 bx * bn:(bx + 1) * bn] += 1
    # the kernel stores rows < P and columns < N only
    return seen[:P, :N], seen


@pytest.mark.parametrize("B,H,W,C", SHAPES, ids=_ids(SHAPES))
def test_gemm_tiles_cover_every_output_once(B, H, W, C):
    HID = 4 * C
    plan = cb.convnext_block_plan(B, H, W, C, HID)
    P = B * H * W
    for N, bn in ((HID, plan.fc1_bn), (C, plan.fc2_bn)):
        stored, grid = _coverage(P, N, bn)
        assert (stored == 1).all()
        assert (grid == 1).all()   # tiles do not overlap
    assert cb.scratch_shapes(B, H, W, C, HID) == ((P, C), (P, HID))


@pytest.mark.parametrize("B,H,W,C", SHAPES, ids=_ids(SHAPES))
def test_plan_widths_are_instantiated_by_the_kernels(B, H, W, C):
    plan = cb.convnext_block_plan(B, H, W, C, 4 * C)
    fc2 = {int(n) for n in re.findall(
        r"case (\d+): return launch_fc<kFc2Residual, \1>", CSRC)}
    rows = {int(n) for n in re.findall(
        r"case (\d+): return launch_prologue<\1>", CSRC)}
    fc1 = int(re.search(r"constexpr int kFc1Width = (\d+);", CSRC).group(1))
    assert fc2 == set(cb.FC2_WIDTHS) and rows == set(cb.PROLOGUE_TILE_ROWS)
    assert plan.fc1_bn == fc1 == cb.FC1_WIDTH
    assert plan.fc2_bn in fc2 and plan.tile_h in rows
    # one column tile where C fits one; else the widest tiles that still
    # make SMS / 2 of them (64-wide where none does)
    P = B * H * W
    if C <= max(cb.FC2_WIDTHS):
        assert plan.fc2_bn >= C and all(w < C for w in cb.FC2_WIDTHS
                                        if w < plan.fc2_bn)
    else:
        def tiles(w):
            return np.prod(cb.fc_grid(P, C, w))

        assert tiles(plan.fc2_bn) >= cb.SMS // 2 or plan.fc2_bn == 64
        assert all(tiles(w) < cb.SMS // 2 for w in cb.FC2_WIDTHS
                   if w > plan.fc2_bn)


def test_plan_constants_match_the_kernel_source():
    for name, value in (("kCbTileW", cb.PROLOGUE_TILE_W),
                        ("kCbTileValues", cb.PROLOGUE_TILE_VALUES),
                        ("kFcRows", cb.FC_ROWS),
                        ("kF32MaxC", cb.F32_MAX_C)):
        got = re.search(rf"constexpr int {name} = (\d+);", CSRC)
        assert got is not None and int(got.group(1)) == value, name


def test_plan_at_the_flagship_stages():
    want = {(256, 96): (8, 96), (128, 192): (8, 192), (64, 384): (2, 128),
            (32, 768): (1, 64)}
    for (hw, c), (tile_h, fc2_bn) in want.items():
        plan = cb.convnext_block_plan(1, hw, hw, c, 4 * c)
        assert (plan.tile_h, plan.fc1_bn, plan.fc2_bn) == (tile_h, 128,
                                                           fc2_bn)


@pytest.mark.parametrize("C,HID", [(12, 48), (16, 60), (4096, 16384)])
def test_plan_refuses_what_the_kernels_cannot_take(C, HID):
    with pytest.raises(ValueError):
        cb.convnext_block_plan(1, 8, 8, C, HID)


def _block_args(B, H, C, seed):
    g = torch.Generator().manual_seed(seed)
    _, args = kc.convnext_case(H, C, torch.float32, g, batch=B)
    return args


def test_out_buffer_takes_the_result():
    args = _block_args(2, 9, 16, 0)
    want = cb.convnext_block_plain(*args)
    out = torch.full_like(args[0], float("nan"))
    got = cb.convnext_block(*args, out=out)
    assert got is out
    torch.testing.assert_close(out, want, rtol=0, atol=0)


@pytest.mark.parametrize("B,H,C", [(1, 5, 16), (3, 4, 24)])
def test_guarded_buffer_holds_the_output_and_a_zero_tail(B, H, C):
    args = _block_args(B, H, C, 1)
    buf = kc.convnext_with_guard(*args)
    P = B * H * H
    assert buf.shape == (P + H, C)
    torch.testing.assert_close(buf[:P].view(B, H, H, C),
                               cb.convnext_block_plain(*args), rtol=0,
                               atol=0)
    assert (buf[P:] == 0).all()


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("hw,C", kc.CONVNEXT_STAGES)
def test_convnext_bound_at_each_stage(hw, C):
    x = _meta(1, hw, hw, C)
    hid = 4 * C
    args = (x, _meta(C, 1, 7, 7), *(_meta(C) for _ in range(3)),
            _meta(hid, C), _meta(hid), _meta(C, hid), _meta(C), _meta(C))
    w = kc.work("convnext_block", args, x)
    P = hw * hw
    # 9.7 GFLOP of products at every stage; bytes: x in and out, weights
    assert w["tensor_ops"] == 16.0 * P * C * C
    assert w["tensor_ops"] == pytest.approx(9.66e9, rel=2e-3)
    params = 49 * C + 5 * C + 2 * hid * C + hid
    assert w["bytes"] == 2.0 * (2 * P * C + params)
    ms, by = kc.bound_ms("convnext_block", args, x)
    # the products on the tensor cores or, at 256^2 x 96, the dwconv,
    # LayerNorm and GELU at the float32 rate (0.0131 ms)
    assert by == "operations" and ms == pytest.approx(
        max(w["tensor_ops"] / 989e9, w["other_ops"] / 67e9))
    assert (ms > w["tensor_ops"] / 989e9) == (hw == 256)
    # a guarded buffer as the output counts as x's shape
    guarded = _meta(P + hw, C)
    assert kc.work("convnext_block", args, guarded) == w
    ms32, _ = kc.bound_ms("convnext_block",
                          tuple(_meta(*a.shape, dtype=torch.float32)
                                for a in args),
                          _meta(1, hw, hw, C, dtype=torch.float32))
    assert ms32 > 10 * ms
