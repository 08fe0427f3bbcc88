"""3xTF32 on the CPU: the arithmetic that the float32 kernels of K1/K2
(csrc/rel_pos_attention_f32.cuh), K5 (csrc/convnext_block.cu) and K6
(csrc/pixel_shuffle.cu) run on .tf32 wgmma, in torch, shared by
tests/test_torch_tf32_split.py, test_torch_tf32_attention.py and
test_torch_tf32_pixel_shuffle.py.

Each float32 operand x is split into big = tf32(x) (cvt.rna.tf32.f32) and
small = tf32(x - big); a k8 step adds a_big b_small + a_small b_big, then
a_big b_big (a_small b_small is dropped). A product of two TF32 values is
exact in float32 (11 + 11 significant bits), so float32 matmuls of the
halves model the tensor cores; `product(..., truncate=True)` also models
their accumulation, which adds each k8 product by truncation.
"""
import torch

TOL = dict(atol=1e-4, rtol=1e-4)   # kernel_checks.TOLERANCES[float32]


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on the int32 bit pattern: half of the 13 dropped
    mantissa bits' weight added to the magnitude (sign and magnitude: the
    pattern's low bits are the magnitude's), then the 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def add_truncated(acc: torch.Tensor, part: torch.Tensor) -> torch.Tensor:
    """acc + part (part exact, float64) rounded toward zero to float32."""
    exact = acc.double() + part
    r = exact.float()
    over = r.double().abs() > exact.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def product(a, b, passes=3, truncate=False):
    """a (..., M, K) times b (..., N, K)^T as the kernels' .tf32 wgmma
    products run it: 3xTF32 (or one pass of the big halves), each k8 step's
    three products added into one accumulator, in float32 or (truncate)
    exactly and then truncated to float32, as the tensor cores add. b is a
    tensor, split here, or its (big, small) halves, split beforehand."""
    bb, bs = b if isinstance(b, tuple) else split(b)
    if passes == 1:
        return tf32_rna(a) @ bb.transpose(-1, -2)
    ab, as_ = split(a)
    if not truncate:
        t = lambda x: x.transpose(-1, -2)  # noqa: E731
        return (ab @ t(bs) + as_ @ t(bb)) + ab @ t(bb)
    acc = torch.zeros(a.shape[:-1] + bb.shape[-2:-1])
    for k0 in range(0, a.shape[-1], 8):
        for x, y in ((ab, bs), (as_, bb), (ab, bb)):
            part = x[..., k0:k0 + 8].double() @ y[..., k0:k0 + 8].double(
            ).transpose(-1, -2)
            acc = add_truncated(acc, part)
    return acc


def within(got, want, share=1.0):
    """Every element within `share` of the float32 tolerance."""
    bound = TOL["atol"] + TOL["rtol"] * want.abs()
    return bool(((got.double() - want.double()).abs() <= share * bound)
                .all())
