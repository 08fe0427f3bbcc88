"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA Hopper card and nvcc; skips elsewhere (decided inside each
test). The JAX package is not installed on the card's machine, so run these
without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: kernel_checks.TOLERANCES (at the root of the checkout)
(float32: summation order only; bfloat16: the bf16 rounding of the kernel's
output, against the plain version on the inputs upcast to float32).
"""
import pytest
import torch

from kernel_checks import (
    KERNELS, TOLERANCES, flagship_case, plain_reference)
from multimodal_sam_adapter_torch.ops import kernels

pytestmark = pytest.mark.gpu

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_matches_plain_at_flagship_shapes(name, dtype):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    fn, args = flagship_case(name, DTYPES[dtype], g)
    before = kernels.LAUNCHES[name]
    got = fn(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    want = plain_reference(fn, args)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(),
                               **TOLERANCES[DTYPES[dtype]])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("head_dim", [16, 32])
@pytest.mark.parametrize("name", ["flash_attention", "window_attention"])
def test_attention_kernels_at_narrow_ragged_shapes(name, head_dim, dtype):
    """Head widths of the test configurations, and token counts that fill
    no tile: a 7x7 window (49 tokens) and a 10x12 global grid (120 tokens,
    rows and columns of unequal length)."""
    from multimodal_sam_adapter_torch.ops.flash_attention import (
        flash_attention)
    from multimodal_sam_adapter_torch.ops.window_attention import (
        window_attention)

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(1)
    heads, dt = 3, DTYPES[dtype]

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dt)

    C = heads * head_dim
    if name == "window_attention":
        ws = 7
        args = (randn(5, ws * ws, 3 * C), randn(2 * ws - 1, head_dim, scale=0.5),
                randn(2 * ws - 1, head_dim, scale=0.5), ws, heads,
                head_dim ** -0.5)
        fn = window_attention
    else:
        hw = (10, 12)
        args = (randn(2, hw[0] * hw[1], 3 * C),
                randn(2 * hw[0] - 1, head_dim, scale=0.5),
                randn(2 * hw[1] - 1, head_dim, scale=0.5), hw, heads,
                head_dim ** -0.5)
        fn = flash_attention
    before = kernels.LAUNCHES[name]
    got = fn(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    want = plain_reference(fn, args)
    torch.testing.assert_close(got.float(), want.float(), **TOLERANCES[dt])


def test_tiny_model_kernel_path_matches_plain_path():
    """The whole forward at the narrow test geometry (head width 16, MSDA
    head width 4) through the kernels and through the plain versions."""
    from multimodal_sam_adapter_torch.models.segmentor import build_segmentor
    from multimodal_sam_adapter_tpu.configs.registry import get_config

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    model = build_segmentor(get_config("deliver_tiny")["model"], dev,
                            generator=g)
    x = torch.randn((2, 64, 64, 6), generator=g, device=dev)
    kernels.reset_launches()
    with torch.no_grad():
        got = model(x)
        counts = dict(kernels.LAUNCHES)
        with kernels.plain_kernels():
            want = model(x)
    # deliver_tiny: 2 windowed + 2 global blocks, 4 injectors, 6 extractors
    assert counts == {"window_attention": 2, "flash_attention": 2,
                      "msda_multi_level": 4, "msda_single_level": 6}
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_wrapper_refuses_bad_operands():
    from multimodal_sam_adapter_torch.ops.window_attention import (
        window_attention_cuda)

    dev = _card()
    qkv = torch.zeros((2, 49, 3 * 64), device=dev)
    rh = torch.zeros((49, 16), device=dev)
    with pytest.raises(ValueError):
        window_attention_cuda(qkv[:, :48], rh, rh, 7, 4, 0.25)
    with pytest.raises(TypeError):
        window_attention_cuda(qkv, rh.double(), rh, 7, 4, 0.25)
    strided = torch.zeros((2, 3 * 64, 49), device=dev).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        window_attention_cuda(strided, rh, rh, 7, 4, 0.25)
