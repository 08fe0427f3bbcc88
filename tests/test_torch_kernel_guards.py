"""The kernel wrappers refuse a call that autograd would record.

No kernel of the port has a backward yet, and each writes into a fresh
tensor that has no `grad_fn`: a call with grad enabled and an input that
requires grad must raise before anything launches, not return a tensor
that gradients silently do not flow through. On the CPU the kernel branch
is reached by routing CPU tensors to it (`kernels.on_kernel_device`), with
each launcher replaced by a recorder and the kernel library by a stub that
fails the test if it is called. The plain versions, which run on CPU
tensors, keep their gradients.
"""
import importlib

import pytest
import torch

import kernel_checks as kc
from multimodal_sam_adapter_torch.ops import kernels

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


@pytest.mark.parametrize("which", ["first", "last"])
@pytest.mark.parametrize("name", sorted(LAUNCHERS))
def test_grad_recording_call_raises_before_any_launch(name, which,
                                                      kernel_branch):
    fn, args = _case(name)
    args = list(args)
    pos = _tensor_positions(args)
    i = pos[0] if which == "first" else pos[-1]
    args[i] = args[i].detach().requires_grad_()
    before = dict(kernels.LAUNCHES)
    assert torch.is_grad_enabled()
    with pytest.raises(RuntimeError, match=f"{name}: .*no backward yet"):
        fn(*args)
    assert kernel_branch == []
    assert kernels.LAUNCHES == before


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
