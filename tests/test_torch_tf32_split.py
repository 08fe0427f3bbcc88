"""3xTF32, K5's float32 products on the card, modelled on the CPU.

K5's float32 GEMMs (csrc/convnext_block.cu) run on .tf32 wgmma: each
float32 operand x is split into big = tf32(x) (cvt.rna.tf32.f32: the 23-bit
mantissa rounded to 10 bits, to nearest, ties away from zero) and small =
tf32(x - big), and a product a b is taken as a_big b_small + a_small b_big,
then + a_big b_big, in float32 accumulators (a_small b_small, ~2^-22 |a b|,
is dropped). A product of two TF32 values is exact in float32 (11 + 11
significant bits), so float32 matmuls of the halves model the tensor cores.

Here, on seeded inputs shaped as K5's two products give them (fc1: the
LayerNorm's xn (P, C) by w1 (4C, C) ~ 1/sqrt(C); fc2: the GELU's h (P, 4C)
by w2 (C, 4C) ~ 1/sqrt(4C)), C in {16, 32, 96}, 300 pixels:

- the split: |big + small - x| <= 2^-21 |x|;
- the 3-pass product lies within rtol 1e-5 of the float64 product, the
  tolerance taken against the magnitude of the dot product's terms,
  |a| |b|^T (where terms cancel, no float32 product has relative accuracy;
  the plain float32 product meets the same bound);
- the 1-pass TF32 product (a_big b_big alone) misses the kernel's float32
  tolerance (kernel_checks.TOLERANCES: 1e-4 + 1e-4 |want|) on the same
  data: the mutant that shows why three passes are needed.

The model lives in tests/_torch_tf32.py only; the package's CPU path is
the plain float32 version.
"""
import numpy as np
import pytest
import torch

from tests._torch_tf32 import split, tf32_rna

WIDTHS = (16, 32, 96)
PIXELS = 300
SEED = 18


def operands(C: int, product: str):
    """(a, b) float32 as K5's product `product` meets them: a (P, K), b
    (N, K), from numpy's generator seeded with SEED and C."""
    rng = np.random.default_rng([SEED, C])
    hid = 4 * C
    if product == "fc1":
        a = rng.standard_normal((PIXELS, C))          # LayerNorm'd rows
        b = rng.standard_normal((hid, C)) * C ** -0.5
    else:
        z = rng.standard_normal((PIXELS, hid))
        a = torch.nn.functional.gelu(torch.from_numpy(z)).numpy()
        b = rng.standard_normal((C, hid)) * hid ** -0.5
    return (torch.from_numpy(a.astype(np.float32)),
            torch.from_numpy(b.astype(np.float32)))


def three_pass(a, b):
    ab, a_s = split(a)
    bb, bs = split(b)
    return (ab @ bs.T + a_s @ bb.T) + ab @ bb.T


def one_pass(a, b):
    return tf32_rna(a) @ tf32_rna(b).T


def exact(a, b):
    return a.double() @ b.double().T


def test_rounding_is_to_nearest_ties_away():
    # 1 + k 2^-23 for k around the halfway point 2^12 of the dropped bits
    one = torch.tensor([1.0], dtype=torch.float32).view(torch.int32)
    cases = {0x0FFF: 0, 0x1000: 0x2000, 0x1001: 0x2000, 0x2FFF: 0x2000,
             0x3000: 0x4000}
    for low, want in cases.items():
        x = (one + low).view(torch.float32)
        got = tf32_rna(x).view(torch.int32) - one
        assert got.item() == want, hex(low)
        assert tf32_rna(-x).item() == -tf32_rna(x).item()
    # TF32 values are fixed points; 11 significant bits
    v = torch.tensor([1.0, -3.5, 2.0 ** -20, 1 + 2.0 ** -10],
                     dtype=torch.float32)
    torch.testing.assert_close(tf32_rna(v), v, rtol=0, atol=0)
    assert tf32_rna(torch.tensor([1 + 2.0 ** -11])).item() == 1 + 2.0 ** -10


@pytest.mark.parametrize("product", ["fc1", "fc2"])
@pytest.mark.parametrize("C", WIDTHS)
def test_split_halves_sum_to_the_value(C, product):
    for x in operands(C, product):
        big, small = split(x)
        assert ((big.view(torch.int32) & 0x1FFF) == 0).all()
        assert ((small.view(torch.int32) & 0x1FFF) == 0).all()
        err = (big.double() + small.double() - x.double()).abs()
        assert (err <= 2.0 ** -21 * x.double().abs()).all()
        # big alone is TF32's rounding: up to 2^-11 |x|, and more than
        # 2^-21 somewhere, so small carries real bits
        assert ((big.double() - x.double()).abs()
                <= 2.0 ** -11 * x.double().abs()).all()
        assert (small != 0).any()


@pytest.mark.parametrize("product", ["fc1", "fc2"])
@pytest.mark.parametrize("C", WIDTHS)
def test_three_passes_keep_float32_accuracy(C, product):
    a, b = operands(C, product)
    want = exact(a, b)
    scale = a.double().abs() @ b.double().abs().T
    err3 = (three_pass(a, b).double() - want).abs()
    assert (err3 <= 1e-5 * scale).all()
    # the float32 product itself meets the same bound
    assert ((a @ b.T).double() - want).abs().le(1e-5 * scale).all()
    # and the three passes are as close as float32's own rounding allows
    assert err3.max() <= 4 * ((a @ b.T).double() - want).abs().max()


@pytest.mark.parametrize("product", ["fc1", "fc2"])
@pytest.mark.parametrize("C", WIDTHS)
def test_one_tf32_pass_misses_the_float32_tolerance(C, product):
    a, b = operands(C, product)
    want = exact(a, b)
    within = (one_pass(a, b).double() - want).abs() <= 1e-4 + 1e-4 * want.abs()
    assert not within.all()
    within3 = (three_pass(a, b).double() - want).abs() <= (
        1e-4 + 1e-4 * want.abs())
    assert within3.all()
