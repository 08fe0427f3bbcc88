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
    ATTENTION_RAGGED, CONVNEXT_RAGGED, CONVNEXT_STAGES, GRAD_TOLERANCES,
    KERNELS, MSDA_PIXEL_DECODER, MSDA_RAGGED, PIXEL_SHUFFLE_RAGGED,
    TOLERANCES, attention_case, convnext_case, convnext_delta_case,
    flagship_case, flagship_shapes, function_check, msda_case,
    msda_encoder_case, pixel_shuffle_case, plain_reference)
from multimodal_sam_adapter_torch.ops import kernels

pytestmark = pytest.mark.gpu

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _check_launch(name, fn, args, dt):
    before = kernels.LAUNCHES[name]
    got = fn(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    want = plain_reference(fn, args)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **TOLERANCES[dt])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name,shape", [
    (n, s) for n in sorted(KERNELS) for s in flagship_shapes(n)])
def test_kernel_matches_plain_at_flagship_shapes(name, shape, dtype):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    fn, args = flagship_case(name, DTYPES[dtype], g, shape)
    _check_launch(name, fn, args, DTYPES[dtype])


def _ragged_params():
    for shape in CONVNEXT_RAGGED:
        yield "convnext_block", "x".join(map(str, shape)), dict(
            hw=shape[0], C=shape[1])
    yield "convnext_block", "batch3", dict(hw=CONVNEXT_RAGGED[0][0],
                                           C=CONVNEXT_RAGGED[0][1], batch=3)
    for label, kw in PIXEL_SHUFFLE_RAGGED:
        yield "pixel_shuffle_up_bn", label, kw


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name,label,kw", list(_ragged_params()),
                         ids=[f"{n}-{lb}" for n, lb, _ in _ragged_params()])
def test_convnext_and_pixel_shuffle_at_ragged_shapes(name, label, kw,
                                                     dtype):
    """The FMB (800^2) widths that fill no tile (K5 at 25x25x768 and
    50x50x384, K6 from a 100x100 grid), the narrow test widths (atto
    C = 40, embed 32), batch 3 (slide mode's window batch), and for K6
    `whole` mode's 128x228 grid and c1 / x1 in each other's layout."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(2)
    kw = dict(kw)
    if name == "convnext_block":
        fn, args = convnext_case(kw.pop("hw"), kw.pop("C"), DTYPES[dtype], g,
                                 **kw)
    else:
        fn, args = pixel_shuffle_case(kw.pop("grid", 128), kw.pop("E", 1024),
                                      DTYPES[dtype], g, **kw)
    _check_launch(name, fn, args, DTYPES[dtype])


def test_pixel_shuffle_refuses_operands_tma_cannot_take():
    """K6 takes c1 and x1 NCHW or channels-last with 16-byte strides, in
    bf16 and in float32, and raises, launching nothing, on anything
    else."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    before = kernels.LAUNCHES["pixel_shuffle_up_bn"]
    for dt in (torch.bfloat16, torch.float32):
        fn, (c2, w, c1, x1, sc, sh) = pixel_shuffle_case(8, 32, dt, g)
        hw_swapped = c1.transpose(2, 3).contiguous().transpose(2, 3)
        with pytest.raises(ValueError, match="NCHW or channels-last"):
            fn(c2, w, hw_swapped, x1, sc, sh)
        shifted = torch.empty(c1.numel() + 1, dtype=c1.dtype, device=dev)[1:]
        with pytest.raises(ValueError, match="aligned"):
            fn(c2, w, c1, shifted.view(c1.shape), sc, sh)
    # float32 rows of 18 values: 72 bytes, no multiple of 16
    B, O, OH, OW = c1.shape
    wide = torch.zeros((B, O, OH, OW + 2), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match="multiples of 4"):
        fn(c2, w, c1, wide[..., :OW], sc, sh)
    assert kernels.LAUNCHES["pixel_shuffle_up_bn"] == before


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("label,kw", ATTENTION_RAGGED,
                         ids=[label for label, _ in ATTENTION_RAGGED])
@pytest.mark.parametrize("name", ["flash_attention", "window_attention"])
def test_attention_kernels_at_fmb_and_batch3_shapes(name, label, kw, dtype):
    """ViT-L's K1 and K2 at FMB's 800^2 (16 windows; a 50x50 global grid,
    two rows of 50 keys to a tile, the 127-row tables resized to 99), at
    slide's batch of 3 crops (75 windows; B = 3) and at a tensor-parallel
    rank's 4 and 8 heads."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(3)
    fn, args = attention_case(name, DTYPES[dtype], g, **kw)
    _check_launch(name, fn, args, DTYPES[dtype])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("label,kw", MSDA_RAGGED,
                         ids=[label for label, _ in MSDA_RAGGED])
@pytest.mark.parametrize("name", ["msda_multi_level", "msda_single_level"])
def test_msda_at_fmb_batch3_nonsquare_and_tiny_shapes(name, label, kw,
                                                      dtype):
    """K3 and K4 at FMB's 800^2 (a 50x50 grid), at slide's batch of 3
    crops (the reference points of one image broadcast), at `whole` mode's
    1024x1824 (a 64x114 grid, levels 128x228 / 64x114 / 32x57), at
    deliver_tiny's widths (D = 4, P = 2: 8-byte loads) and at a
    tensor-parallel rank's 4 and 8 heads."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(4)
    fn, args = msda_case(name, DTYPES[dtype], g, **kw)
    _check_launch(name, fn, args, DTYPES[dtype])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("label,kw", MSDA_PIXEL_DECODER,
                         ids=[label for label, _ in MSDA_PIXEL_DECODER])
def test_msda_at_the_pixel_decoder_shapes(label, kw, dtype):
    """K3 as the Mask2Former pixel decoder calls it: every token of the 3
    levels queries them from its own pixel centre (Lq = S), at full width
    (21504 tokens, 8 heads of D = 64) and at deliver_tiny_m2f's D = 4;
    and its Function's gradients against the plain autodiff."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(4)
    fn, args = msda_encoder_case(DTYPES[dtype], g, **kw)
    _check_launch("msda_multi_level", fn, args, DTYPES[dtype])
    res = function_check(fn, args, g)
    assert res["same_output"]
    assert res["grad_rel_err"] <= GRAD_TOLERANCES[DTYPES[dtype]]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shift", [1, 2])
def test_msda_on_a_misaligned_value(shift, dtype):
    """The value tensor a whole number of values past a 16-byte boundary:
    the plan narrows the loads to what the address allows."""
    dev = _card()
    dt = DTYPES[dtype]
    g = torch.Generator(device=dev).manual_seed(5)
    fn, args = msda_case("msda_multi_level", dt, g, grid=(8, 10))
    value = args[0]
    buf = torch.empty(value.numel() + shift, dtype=dt, device=dev)
    moved = buf[shift:].view(value.shape)
    moved.copy_(value)
    args = (moved,) + args[1:]
    _check_launch("msda_multi_level", fn, args, dt)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernels_refuse_a_call_autograd_would_record(name):
    """K6 (no backward: eval only) raises before it launches on a call
    with grad enabled and an input that requires grad; under no_grad the
    same call launches. K1-K5 take such a call through their autograd
    Function: the kernel's own output (bit-equal), one launch, and
    gradients equal to the plain version's autodiff (K2's banded backward
    against the unbanded one at N = 4096; K5 in its delta-only mode), in
    bf16 and float32."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    if name != "pixel_shuffle_up_bn":
        for dt in (torch.bfloat16, torch.float32):
            if name == "convnext_block":
                fn, args = convnext_delta_case(*CONVNEXT_STAGES[0], dt, g)
            else:
                fn, args = flagship_case(name, dt, g,
                                         flagship_shapes(name)[0])
            before = kernels.LAUNCHES[name]
            res = function_check(fn, args, g)
            torch.cuda.synchronize()
            assert kernels.LAUNCHES[name] == before + 2  # no grad, Function
            assert res["same_output"] and res["function"].endswith(
                "FunctionBackward"), res
            assert res["grad_rel_err"] <= GRAD_TOLERANCES[dt], res
        return
    fn, args = flagship_case(name, torch.bfloat16, g,
                             flagship_shapes(name)[0])
    args = list(args)
    i = next(i for i, a in enumerate(args) if torch.is_tensor(a))
    args[i] = args[i].detach().requires_grad_()
    before = dict(kernels.LAUNCHES)
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == before
    with torch.no_grad():
        fn(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before[name] + 1


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", CONVNEXT_STAGES,
                         ids=["x".join(map(str, s)) for s in CONVNEXT_STAGES])
def test_convnext_delta_mode_matches_plain_delta(shape, dtype):
    """K5 with a null shortcut (training's delta-only mode) at the four
    stage shapes, batch 3, against the plain delta."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    fn, args = convnext_delta_case(*shape, DTYPES[dtype], g, batch=3)
    _check_launch("convnext_block", fn, args, DTYPES[dtype])


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
    from multimodal_sam_adapter_torch.configs.registry import get_config

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
    # deliver_tiny: 2 windowed + 2 global blocks, 4 injectors, 6 extractors,
    # 2 x 12 atto ConvNeXt blocks, the f1 assembly
    assert counts == {"window_attention": 2, "flash_attention": 2,
                      "msda_multi_level": 4, "msda_single_level": 6,
                      "convnext_block": 24, "pixel_shuffle_up_bn": 1}
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_wrapper_refuses_bad_operands():
    from multimodal_sam_adapter_torch.ops.window_attention import (
        window_attention_cuda)

    dev = _card()
    qkv = torch.zeros((2, 49, 3 * 64), device=dev)
    th = torch.zeros((13, 16), device=dev)
    with pytest.raises(ValueError):
        window_attention_cuda(qkv[:, :48], th, th, 7, 4, 0.25)
    with pytest.raises(TypeError):
        window_attention_cuda(qkv, th.double(), th, 7, 4, 0.25)
    with pytest.raises(ValueError, match="shape"):
        window_attention_cuda(qkv, th[:12], th, 7, 4, 0.25)
    strided = torch.zeros((2, 3 * 64, 49), device=dev).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        window_attention_cuda(strided, th, th, 7, 4, 0.25)
