"""The Python side of K5's kernels, on the CPU: the launch plan that its
wrapper hands csrc/convnext_block.cu, in bf16 and float32, the output
buffer, and its bound.

- The prologue's tiles (tile_h x 8 pixels; the kernel's `block_tile` /
  `tile_pixel` index math emulated here) cover every pixel exactly once,
  give >= 132 blocks wherever the map has >= 132 x 8 pixels, and keep
  their float32 dwconv outputs within the tile's shared memory; the taps'
  slabs cover every channel once and fit beside the tile (float32's
  doubled taps: in slabs from C = 896).
- fc1's and fc2's tile grids cover every (pixel, hidden unit) and (pixel,
  channel) element exactly once, at widths the C source instantiates,
  with >= 2 ring stages in the shared memory; the scratch is (P, C) and
  (P, HID), and in float32 also the weights' TF32 halves (4, HID * C).
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


DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,W,C", SHAPES, ids=_ids(SHAPES))
def test_prologue_tiles_cover_every_pixel_once(B, H, W, C, dtype):
    plan = cb.convnext_block_plan(B, H, W, C, 4 * C, DTYPES[dtype])
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


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,W,C", SHAPES, ids=_ids(SHAPES))
def test_gemm_tiles_cover_every_output_once(B, H, W, C, dtype):
    HID = 4 * C
    plan = cb.convnext_block_plan(B, H, W, C, HID, DTYPES[dtype])
    P = B * H * W
    for N, bn in ((HID, plan.fc1_bn), (C, plan.fc2_bn)):
        stored, grid = _coverage(P, N, bn)
        assert (stored == 1).all()
        assert (grid == 1).all()   # tiles do not overlap
    assert cb.scratch_shapes(B, H, W, C, HID) == ((P, C), (P, HID))
    assert cb.scratch_shapes(B, H, W, C, HID, torch.float32) == (
        (P, C), (P, HID), (4, HID * C))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,W,C", SHAPES, ids=_ids(SHAPES))
def test_plan_widths_are_instantiated_by_the_kernels(B, H, W, C, dtype):
    dt = DTYPES[dtype]
    plan = cb.convnext_block_plan(B, H, W, C, 4 * C, dt)
    fc2 = {int(n) for n in re.findall(
        r"case (\d+): return launch_fc<T, kFc2Residual, \1>", CSRC)}
    bf16_only = {int(n) for n in re.findall(
        r"if \(bn == (\d+)\)\s+return launch_fc<T, kFc2Residual, \1>",
        CSRC)}
    rows = {int(n) for n in re.findall(
        r"case (\d+): return launch_prologue<T, \1>", CSRC)}
    fc1 = int(re.search(r"constexpr int kFc1Width = (\d+);", CSRC).group(1))
    assert fc2 == set(cb.FC2_WIDTHS_F32)
    assert fc2 | bf16_only == set(cb.FC2_WIDTHS)
    assert rows == set(cb.PROLOGUE_TILE_ROWS)
    widths = cb.fc2_widths(dt)
    assert widths == (cb.FC2_WIDTHS if dtype == "bf16" else cb.FC2_WIDTHS_F32)
    assert plan.fc1_bn == fc1 == cb.FC1_WIDTH
    assert plan.fc2_bn in widths and plan.tile_h in rows
    # one column tile where C fits one; else, of the widths dividing C
    # (all where none does), the widest whose tiles still number SMS / 2
    # (the narrowest where none does)
    P = B * H * W
    if C <= max(widths):
        assert plan.fc2_bn >= C and all(w < C for w in widths
                                        if w < plan.fc2_bn)
    else:
        def tiles(w):
            return np.prod(cb.fc_grid(P, C, w))

        whole = [w for w in widths if C % w == 0] or list(widths)
        assert plan.fc2_bn in whole
        assert tiles(plan.fc2_bn) >= cb.SMS // 2 or plan.fc2_bn == whole[0]
        assert all(tiles(w) < cb.SMS // 2 for w in whole
                   if w > plan.fc2_bn)


def test_plan_constants_match_the_kernel_source():
    for name, value in (("kCbTileW", cb.PROLOGUE_TILE_W),
                        ("kCbTileValues", cb.PROLOGUE_TILE_VALUES),
                        ("kFcRows", cb.FC_ROWS),
                        ("kCbSmemMax", cb.SMEM_MAX),
                        ("kFcRowBytes", cb.FC_ROW_BYTES),
                        ("kFcRingBytes", cb.FC_RING_BYTES),
                        ("kFcMaxStages", cb.FC_MAX_STAGES)):
        got = re.search(rf"constexpr int {name} = (\d+);", CSRC)
        assert got is not None and int(got.group(1)) == value, name


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plan_at_the_flagship_stages(dtype):
    # float32's fc2 at 128^2 x 192: two column tiles 96 wide
    want = {(256, 96): (8, 96), (128, 192): (8, 192 if dtype == "bf16"
                                                 else 96),
            (64, 384): (2, 128), (32, 768): (1, 64)}
    for (hw, c), (tile_h, fc2_bn) in want.items():
        plan = cb.convnext_block_plan(1, hw, hw, c, 4 * c, DTYPES[dtype])
        # every tap in one slab
        assert plan == (tile_h, 128, fc2_bn, c)


WIDE = ((1, 64, 64, 1016), (1, 32, 32, 1024), (1, 64, 64, 1024),
        (1, 32, 32, 1536), (1, 16, 16, 2048), (3, 25, 25, 768))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,W,C", SHAPES + WIDE, ids=_ids(SHAPES + WIDE))
def test_plan_fits_the_shared_memory(B, H, W, C, dtype):
    """The prologue's tile and one slab of taps fit a block's shared
    memory, the slabs (multiples of 8 channels: 16-byte cp.async of the
    taps) cover [0, C) once, and each GEMM the plan picks keeps >= 2 ring
    stages beside its staging tiles (float32: B's two TF32 halves a stage,
    no staging)."""
    dt = DTYPES[dtype]
    plan = cb.convnext_block_plan(B, H, W, C, 4 * C, dt)
    assert cb.prologue_smem(plan.tile_h, C, plan.tap_slab, dt) <= cb.SMEM_MAX
    assert plan.tap_slab % 8 == 0 and 0 < plan.tap_slab <= C
    starts = range(0, C, plan.tap_slab)
    covered = np.zeros(C, dtype=np.int32)
    for c0 in starts:
        covered[c0:c0 + plan.tap_slab] += 1
    assert (covered == 1).all()
    # the whole taps where they fit: one slab up to C = 1016 in float32
    # at one tile row, and for every C in bf16 up to 1784
    whole = cb.prologue_smem(plan.tile_h, C, C, dt) <= cb.SMEM_MAX
    assert (plan.tap_slab == C) == whole
    for fc1, bn in ((True, plan.fc1_bn), (False, plan.fc2_bn)):
        stages = cb.fc_stages(dt, fc1, bn)
        assert 2 <= stages <= cb.FC_MAX_STAGES
        stage = cb.FC_ROWS * cb.FC_ROW_BYTES + (
            2 if dt == torch.float32 else 1) * bn * cb.FC_ROW_BYTES
        assert stages * stage <= cb.FC_RING_BYTES < cb.SMEM_MAX - 1024


def test_fc_stages():
    """The ring's depth by dtype and width: bf16 as the kernel has had it
    (fc1 128 wide: 5), float32 with B's two halves a stage and no
    staging tiles."""
    got = {(str(dt).split(".")[1], fc1, bn): cb.fc_stages(dt, fc1, bn)
           for dt in DTYPES.values() for fc1, bn in
           [(True, 128)] + [(False, w) for w in cb.fc2_widths(dt)]}
    assert got == {
        ("bfloat16", True, 128): 5, ("bfloat16", False, 64): 7,
        ("bfloat16", False, 96): 6, ("bfloat16", False, 128): 4,
        ("bfloat16", False, 192): 3,
        ("float32", True, 128): 4, ("float32", False, 64): 6,
        ("float32", False, 96): 5, ("float32", False, 128): 4}


@pytest.mark.parametrize("C,HID", [(12, 48), (16, 60), (4096, 16384)])
def test_plan_refuses_what_the_kernels_cannot_take(C, HID):
    with pytest.raises(ValueError):
        cb.convnext_block_plan(1, 8, 8, C, HID)


def test_plan_refuses_other_dtypes():
    with pytest.raises(TypeError):
        cb.convnext_block_plan(1, 8, 8, 16, 64, torch.float16)


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
    # float32: the products at TF32's tensor-core rate (3xTF32 reaches a
    # third of it at most), the bytes doubled
    args32 = tuple(_meta(*a.shape, dtype=torch.float32) for a in args)
    x32 = _meta(1, hw, hw, C, dtype=torch.float32)
    w32 = kc.work("convnext_block", args32, x32)
    assert w32["bytes"] == 2 * w["bytes"]
    ms32, by32 = kc.bound_ms("convnext_block", args32, x32)
    assert by32 == "operations" and ms32 == pytest.approx(
        max(w32["tensor_ops"] / 494.7e9, w32["other_ops"] / 67e9))
    assert ms32 == pytest.approx(w["tensor_ops"] / 494.7e9)
    assert ms32 > w32["bytes"] / 3.35e9
