"""What the kernel wrappers do with a call that autograd would record.

Each kernel writes into a fresh tensor that has no `grad_fn`, so a call
with grad enabled and an input that requires grad must not return it as
is, or gradients would silently stop there. K1-K5 go through their
`torch.autograd.Function` (the kernel forward, the plain version's
autodiff as the backward, as the JAX package's custom_vjps); K6, which
has none (the JAX package runs it in eval only), raises before anything
launches. On the CPU the kernel branch is reached by routing CPU tensors
to it (`kernels.on_kernel_device`), with the kernel library replaced by a
stub that fails the test if it is called and each launcher by a recorder
(which, for the Functions' forwards, returns the plain version's output).
The plain versions, which run on CPU tensors, keep their gradients.
"""
import importlib

import pytest
import torch

import kernel_checks as kc
from multimodal_sam_adapter_torch.ops import (convnext_block, flash_attention,
                                              kernels, msda_cuda,
                                              pixel_shuffle, window_attention)

# kernel -> (wrapper module, the launchers its kernel branch calls)
LAUNCHERS = {
    "window_attention": ("window_attention", ("window_attention_cuda",
                                              "window_attention_bf16_cuda")),
    "flash_attention": ("flash_attention", ("flash_attention_cuda",
                                            "flash_attention_bf16_cuda")),
    "msda_multi_level": ("msda_cuda", ("ms_deform_attn_cuda",)),
    "msda_single_level": ("msda_cuda", ("ms_deform_attn_cuda",)),
    "convnext_block": ("convnext_block", ("convnext_block_cuda",)),
    "pixel_shuffle_up_bn": ("pixel_shuffle", ("pixel_shuffle_up_bn_cuda",)),
}


def _case(name):
    """(wrapper, args) of each kernel at a small shape, on the CPU."""
    g = torch.Generator().manual_seed(0)
    f32 = torch.float32
    if name in ("window_attention", "flash_attention"):
        return kc.attention_case(name, f32, g, grid=14 if name ==
                                 "window_attention" else 6)
    if name in ("msda_multi_level", "msda_single_level"):
        return kc.msda_case(name, f32, g, **dict(kc.MSDA_RAGGED)["tiny"])
    if name == "convnext_block":
        return kc.convnext_case(8, 40, f32, g)
    return kc.pixel_shuffle_case(4, 32, f32, g)


def _tensor_positions(args):
    return [i for i, a in enumerate(args) if torch.is_tensor(a)]


@pytest.fixture
def kernel_branch(monkeypatch):
    """Send CPU tensors to the kernel branch; record each launcher call;
    fail on any use of the kernel library."""
    calls = []

    def no_library():
        pytest.fail("the kernel library was reached")

    def recorder(launcher):
        def launch(*args, **kwargs):
            calls.append(launcher)
            return torch.zeros(1)
        return launch

    monkeypatch.setattr(kernels, "on_kernel_device", lambda x: True)
    monkeypatch.setattr(kernels, "library", no_library)
    for module, launchers in LAUNCHERS.values():
        mod = importlib.import_module(
            f"multimodal_sam_adapter_torch.ops.{module}")
        for launcher in launchers:
            monkeypatch.setattr(mod, launcher, recorder(launcher))
    return calls


# kernel -> (module, the kernel call its Function's forward makes, that
# call's plain version (same arguments), the Function, the wrapper's plain
# version (the wrapper's arguments))
FUNCTIONS = {
    "window_attention": (
        window_attention, "window_attention_kernel",
        window_attention.window_attention_plain, "WindowAttentionFunction",
        window_attention.window_attention_plain),
    "flash_attention": (
        flash_attention, "flash_attention_kernel",
        flash_attention.flash_attention_plain, "FlashAttentionFunction",
        flash_attention.flash_attention_plain),
    "msda_multi_level": (
        msda_cuda, "ms_deform_attn_cuda", msda_cuda.ms_deform_attn_plain,
        "MSDeformAttnFunction", msda_cuda.ms_deform_attn_plain),
    "msda_single_level": (
        msda_cuda, "ms_deform_attn_cuda", msda_cuda.ms_deform_attn_plain,
        "MSDeformAttnFunction", msda_cuda.ms_deform_attn_plain),
    "convnext_block": (
        convnext_block, "convnext_delta_kernel",
        convnext_block.convnext_delta_plain, "ConvNextDeltaFunction",
        convnext_block.convnext_block_plain),
}


@pytest.fixture
def function_branch(monkeypatch):
    """Send CPU tensors to the kernel branch; each Function's forward
    records its kernel call and returns the plain version's output; K6's
    launcher only records; any use of the kernel library fails."""
    calls = []

    def no_library():
        pytest.fail("the kernel library was reached")

    def recorder(name, plain):
        def launch(*args, **kwargs):
            calls.append(name)
            with torch.no_grad():
                return plain(*args, **kwargs)
        return launch

    monkeypatch.setattr(kernels, "on_kernel_device", lambda x: True)
    monkeypatch.setattr(kernels, "library", no_library)
    for mod, call, plain, _, _ in FUNCTIONS.values():
        monkeypatch.setattr(mod, call, recorder(call, plain))
    monkeypatch.setattr(pixel_shuffle, "pixel_shuffle_up_bn_cuda",
                        recorder("pixel_shuffle_up_bn", None))
    return calls


def _graph(out):
    """The class names of every node of out's autograd graph."""
    seen, todo = set(), [out.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo.extend(n for n, _ in node.next_functions)
    return {type(n).__name__ for n in seen}


@pytest.mark.parametrize("which", ["first", "last"])
@pytest.mark.parametrize("name", sorted(LAUNCHERS))
def test_grad_recording_call_raises_before_any_launch(name, which,
                                                      function_branch):
    """K6 still raises before anything launches. K1-K5 record the call
    through their Function: one kernel call, and gradients equal to the
    plain version's autodiff on the same inputs."""
    fn, args = _case(name)
    args = list(args)
    pos = _tensor_positions(args)
    i = pos[0] if which == "first" else pos[-1]
    args[i] = args[i].detach().requires_grad_()
    before = dict(kernels.LAUNCHES)
    assert torch.is_grad_enabled()
    if name not in FUNCTIONS:
        with pytest.raises(RuntimeError, match=f"{name}: .*no backward"):
            fn(*args)
        assert function_branch == []
        assert kernels.LAUNCHES == before
        return
    out = fn(*args)
    assert function_branch == [FUNCTIONS[name][1]]
    assert f"{FUNCTIONS[name][3]}Backward" in _graph(out)
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    (got,) = torch.autograd.grad(out, args[i], cot)
    leaf = args[i].detach().requires_grad_()
    plain_args = args[:i] + [leaf] + args[i + 1:]
    (want,) = torch.autograd.grad(FUNCTIONS[name][4](*plain_args), leaf, cot)
    # the same arithmetic up to summation order (K2's backward sums the
    # rel-pos bias first): float32 rounding of the largest gradient
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-6 * want.abs().max().item())


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode",
                                  "no_input_requires_grad"])
@pytest.mark.parametrize("name", sorted(LAUNCHERS))
def test_call_autograd_does_not_record_reaches_the_launcher(name, mode,
                                                            kernel_branch):
    fn, args = _case(name)
    args = list(args)
    if mode != "no_input_requires_grad":
        i = _tensor_positions(args)[0]
        args[i] = args[i].detach().requires_grad_()
    ctx = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode,
           "no_input_requires_grad": torch.enable_grad}[mode]
    with ctx():
        fn(*args)
    module, launchers = LAUNCHERS[name]
    assert len(kernel_branch) == 1 and kernel_branch[0] in launchers


@pytest.mark.parametrize("name", sorted(LAUNCHERS))
def test_plain_version_on_the_cpu_keeps_gradients(name):
    fn, args = _case(name)
    args = list(args)
    i = _tensor_positions(args)[0]
    args[i] = args[i].detach().requires_grad_()
    before = dict(kernels.LAUNCHES)
    out = fn(*args)
    assert out.grad_fn is not None
    out.float().square().sum().backward()
    assert args[i].grad is not None and torch.isfinite(args[i].grad).all()
    assert kernels.LAUNCHES == before
