"""The launch plan of the K3/K4 kernel (ops/msda_cuda.py:msda_plan), on the
CPU: what each thread of the planned grid computes, as csrc/msda.cu maps
it (thread (lane, head in block, query in block), block (query block,
batch, head group)), and the CPU path's broadcast of the model's one-batch
reference points.
"""
import numpy as np
import pytest
import torch

import kernel_checks as kc
from multimodal_sam_adapter_torch.ops.msda_cuda import (
    BLOCK_THREADS, SMS, ms_deform_attn, msda_plan, pointer_alignment)

BF16, F32 = torch.bfloat16, torch.float32
# (B, Lq, M, D, L, P) of the flagship injector (K3) and extractor (K4)
K3 = (1, 64 * 64, 16, 32, 3, 4)
K4 = (1, 128 * 128 + 64 * 64 + 32 * 32, 16, 32, 1, 4)


def _covered(B, Lq, M, D, plan):
    """How many threads write each (batch, query, head, channel)."""
    qb, batch, groups = plan.grid
    assert batch == B
    tx, ty, tz = np.meshgrid(np.arange(plan.lanes),
                             np.arange(plan.heads_per_block),
                             np.arange(plan.queries_per_block),
                             indexing="ij")
    hits = np.zeros((B, Lq, M, D), dtype=np.int32)
    for bx in range(qb):
        q = bx * plan.queries_per_block + tz
        live = q < Lq
        for bz in range(groups):
            m = bz * plan.heads_per_block + ty
            for c in range(plan.vec):
                for b in range(B):
                    np.add.at(hits, (b, q[live], m[live],
                                     tx[live] * plan.vec + c), 1)
    return hits


@pytest.mark.parametrize("shape,dtype,align", [
    ((2, 37, 4, 8, 3, 2), F32, 16),
    ((3, 50, 4, 4, 1, 4), BF16, 16),
    ((1, 13, 2, 6, 2, 2), BF16, 2),
    ((2, 300, 16, 32, 3, 4), BF16, 16),
    ((1, 70, 16, 32, 1, 4), BF16, 2),     # 32 lanes a head: 2 head groups
    ((1, 33, 12, 40, 3, 2), F32, 4),      # 40 lanes: 6 heads a block
])
def test_plan_covers_every_output_once(shape, dtype, align):
    B, Lq, M, D, L, P = shape
    plan = msda_plan(B, Lq, M, D, L, P, dtype, align)
    assert plan.lanes * plan.vec == D
    assert M % plan.heads_per_block == 0
    assert (plan.lanes * plan.heads_per_block * plan.queries_per_block
            <= BLOCK_THREADS)
    np.testing.assert_array_equal(_covered(B, Lq, M, D, plan), 1)


@pytest.mark.parametrize("shape", [K3, K4], ids=["K3", "K4"])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_flagship_loads_are_16_bytes_and_fill_the_card(shape, dtype):
    B, Lq, M, D, L, P = shape
    plan = msda_plan(B, Lq, M, D, L, P, dtype, 16)
    esize = 2 if dtype == BF16 else 4
    assert plan.vec * esize == 16 and plan.lanes * plan.vec == D
    assert plan.heads_per_block == M and plan.grid[2] == 1
    assert plan.lanes * M * plan.queries_per_block == BLOCK_THREADS
    assert plan.grid[0] * plan.grid[1] >= 4 * SMS
    assert plan.grid[0] * plan.queries_per_block >= Lq
    assert (plan.grid[0] - 1) * plan.queries_per_block < Lq


@pytest.mark.parametrize("D,dtype,align,vec", [
    (4, BF16, 16, 4),     # deliver_tiny's head width: 8-byte loads
    (32, BF16, 8, 4),     # a base 8 bytes past a 16-byte boundary
    (32, BF16, 2, 1),     # ... 2 bytes past
    (32, F32, 4, 1),
    (6, BF16, 16, 2),
    (6, F32, 16, 2),
])
def test_narrower_loads_for_small_heads_and_misaligned_bases(D, dtype, align,
                                                             vec):
    plan = msda_plan(1, 100, 4, D, 1, 4, dtype, align)
    assert plan.vec == vec and plan.lanes * plan.vec == D


def test_small_grids_halve_the_queries_a_block():
    plan = msda_plan(2, 16, 4, 4, 3, 2, BF16, 16)   # deliver_tiny's K3
    assert plan.queries_per_block == 1 and plan.grid == (16, 2, 1)


@pytest.mark.parametrize("args,err", [
    ((1, 10, 4, 8, 5, 4), "levels"),
    ((1, 10, 4, 8, 0, 4), "levels"),
    ((1, 10, 4, 8, 3, 3), "points"),
    ((0, 10, 4, 8, 3, 4), "bad shape"),
    ((1, 0, 4, 8, 3, 4), "bad shape"),
    ((1, 10, 4, 0, 3, 4), "bad shape"),
    ((70000, 10, 4, 8, 3, 4), "bad shape"),
    ((1, 10, 4, 4096, 3, 4), "exceeds a block"),
    ((1, 2 ** 26, 16, 32, 3, 4), "32-bit"),
])
def test_plan_refuses_what_the_kernel_does_not_take(args, err):
    with pytest.raises(ValueError, match=err):
        msda_plan(*args, BF16, 16)
    with pytest.raises(TypeError):
        msda_plan(1, 10, 4, 8, 3, 4, torch.float16, 16)


def test_pointer_alignment():
    t = torch.zeros(64, dtype=BF16)
    assert pointer_alignment(t) == 16
    assert pointer_alignment(t[1:]) == 2
    assert pointer_alignment(t[4:]) == 8


@pytest.mark.parametrize("name", ["msda_multi_level", "msda_single_level"])
def test_one_batch_reference_points_equal_the_explicit_broadcast(name):
    fn, args = kc.msda_case(name, F32, torch.Generator().manual_seed(5),
                            grid=(4, 6), batch=3, heads=4, points=2,
                            value_width=16)
    value, shapes, ref, offs, logits, heads, points = args
    assert ref.shape[0] == 1
    got = fn(*args)
    full = ref.expand(3, *ref.shape[1:]).contiguous()
    want = fn(value, shapes, full, offs, logits, heads, points)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for b in range(3):   # and each image alone
        one = fn(value[b:b + 1], shapes, ref, offs[b:b + 1],
                 logits[b:b + 1], heads, points)
        torch.testing.assert_close(got[b:b + 1], one, rtol=1e-6, atol=1e-6)


# the Mask2Former pixel decoder's K3 (kernel_checks.MSDA_PIXEL_DECODER):
# 21504 tokens querying their own 3 levels, 8 heads of D = 64; and
# deliver_tiny_m2f's D = 4 at batch 2
M2F = (1, 32 * 32 + 64 * 64 + 128 * 128, 8, 64, 3, 4)
M2F_TINY = (2, 2 * 2 + 4 * 4 + 8 * 8, 8, 4, 3, 4)


@pytest.mark.parametrize("dtype,vec", [(BF16, 8), (F32, 4)])
def test_pixel_decoder_plan_takes_16_byte_loads(dtype, vec):
    B, Lq, M, D, L, P = M2F
    plan = msda_plan(B, Lq, M, D, L, P, dtype, 16)
    assert plan.vec == vec and plan.lanes * plan.vec == D
    assert plan.heads_per_block == M and plan.grid[2] == 1
    assert plan.grid[0] * plan.grid[1] >= 4 * SMS
    assert plan.grid[0] * plan.queries_per_block >= Lq


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_tiny_pixel_decoder_plan_covers_every_output_once(dtype):
    B, Lq, M, D, L, P = M2F_TINY
    plan = msda_plan(B, Lq, M, D, L, P, dtype, 16)
    assert plan.vec == 4 and plan.lanes == 1
    np.testing.assert_array_equal(_covered(B, Lq, M, D, plan), 1)


def test_pixel_decoder_reference_points_take_the_kernel_layout():
    """The encoder's points: each token's own pixel centre on its level,
    broadcast over the 3 levels and held as one contiguous float32
    (1, S, 3, 2) tensor (the kernel's layout for batch-broadcast points);
    the kernel case's points are the same."""
    from multimodal_sam_adapter_torch.models.adapter import (
        _reference_points, reference_points)

    levels = ((2, 2), (4, 4), (8, 8))
    ref = _reference_points(levels, 3, torch.device("cpu"))
    assert ref.shape == (1, 84, 3, 2) and ref.dtype == F32
    assert ref.is_contiguous()
    want = np.broadcast_to(reference_points(levels), (1, 84, 3, 2))
    np.testing.assert_array_equal(ref.numpy(), want)
    fn, args = kc.msda_encoder_case(F32, torch.Generator().manual_seed(2),
                                    levels, 8, 32, batch=2)
    value, shapes, case_ref, offs, logits, heads, points = args
    torch.testing.assert_close(case_ref, ref, rtol=0, atol=0)
    assert offs.shape == (2, 84, 8 * 3 * 4 * 2) and value.shape == (2, 84,
                                                                    32)
    full = case_ref.expand(2, -1, -1, -1).contiguous()
    torch.testing.assert_close(fn(*args), fn(value, shapes, full, offs,
                                             logits, heads, points),
                               rtol=0, atol=0)
