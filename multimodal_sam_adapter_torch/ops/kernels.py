"""Build, load and dispatch the package's hand-written CUDA kernels.

The sources in `csrc/` are compiled with `nvcc` for `sm_90a` (Hopper), one
`nvcc` process per source, all started together, and linked into one
shared library with a plain C interface, bound with `ctypes`. The
library is built at first use into `build/kernels/<hash>/` at the root of
the checkout, keyed by a hash of the sources and flags, so a changed source
rebuilds and an unchanged one is loaded as is. Nothing is built or loaded
when this module is imported.

Dispatch rule shared by every kernel wrapper (`use_kernel`):

- a CUDA tensor goes through the kernel, or the call raises;
- when autograd would record the call (grad enabled and an input that
  requires grad, `records_grad`), K1-K5 go through their
  `torch.autograd.Function`: the kernel forward, and a backward that is
  the autodiff of the plain version recomputed, as the JAX package's
  `custom_vjp`s have it. K6 has no Function (the JAX package runs it in
  eval only) and refuses such a call before launching;
- a CPU tensor goes through the kernel's plain PyTorch version, gradients
  and all; so does a `meta` tensor (shapes only, for utils/flops.py);
- inside `plain_kernels()` CUDA tensors take the plain version too. Only
  comparisons of a kernel against its plain version enter it.

Every wrapper adds one to its entry of `LAUNCHES` each time it launches its
kernel, and nowhere else.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libmsa_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xcompiler", "-fPIC",
)
# the wgmma kernels (K1, K2, K5, K6) find cuTensorMapEncodeTiled with
# dlopen/dlsym
LINK_FLAGS = ("-ldl",)

# kernel name -> number of launches through its wrapper
LAUNCHES: Dict[str, int] = {
    "window_attention": 0,   # K1
    "flash_attention": 0,    # K2
    "msda_multi_level": 0,   # K3 (injectors, L > 1)
    "msda_single_level": 0,  # K4 (extractors, L == 1)
    "convnext_block": 0,     # K5 (the twin ConvNeXt's blocks)
    "pixel_shuffle_up_bn": 0,  # K6 (the eval f1 assembly)
}
# kernels with no autograd Function: the JAX package runs K6 in eval only
# (its models/backbone.py fuses f1 only when not training)
NO_BACKWARD = ("pixel_shuffle_up_bn",)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.c_longlong
_SIGNATURES = {
    "msa_window_attention": [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _F, _VP],
    "msa_window_attention_bf16": [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I,
                                  _I, _I, _I, _F, _VP],
    "msa_flash_attention": [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _F,
                            _VP],
    "msa_flash_attention_bf16": [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I,
                                 _I, _I, _F, _VP],
    "msa_deform_attn": [_VP] * 5 + [_I] * 7 + [ctypes.POINTER(_I)]
                       + [_I] * 7 + [_VP],
    "msa_convnext_block": [_VP] * 14 + [_I, _I, _I, _I, _I, _F, _I, _I,
                                        _I, _I, _VP],
    "msa_pixel_shuffle_up_bn": [_VP, _LL, _VP, _VP, _LL, _LL, _LL, _LL, _VP,
                                _LL, _LL, _LL, _LL, _VP, _VP, _VP]
                               + [_I] * 12 + [_VP],
}


class _State:
    lib: Optional[ctypes.CDLL] = None
    build_seconds: Optional[float] = None
    force_plain: bool = False


_state = _State()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


@contextlib.contextmanager
def plain_kernels():
    """Route CUDA tensors through the plain PyTorch versions, for comparing
    each kernel with its plain version on the card."""
    prev = _state.force_plain
    _state.force_plain = True
    try:
        yield
    finally:
        _state.force_plain = prev


def on_kernel_device(x: torch.Tensor) -> bool:
    """True: `x` goes to the CUDA kernel; False: to the plain version (CPU
    tensors, and `meta` ones, whose plain version gives the output's shape
    without computing it: utils/flops.py counts there)."""
    if x.device.type == "cuda":
        return not _state.force_plain
    if x.device.type in ("cpu", "meta"):
        return False
    raise RuntimeError(f"no kernel and no plain path for device {x.device}")


def use_kernel(name: str, x: torch.Tensor, *inputs) -> bool:
    """True: kernel `name` serves the call on `x` (and the other tensor
    `inputs`), through its autograd Function when autograd records it
    (`records_grad`); False: run the plain version. A kernel without a
    Function (`NO_BACKWARD`) raises before anything launches on a call
    that autograd would record: its output would silently cut the
    graph."""
    if not on_kernel_device(x):
        return False
    if name in NO_BACKWARD and records_grad(x, *inputs):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward (it serves eval "
            "only), and an input requires grad; call it under "
            "torch.no_grad() / torch.inference_mode()")
    return True


def records_grad(*tensors) -> bool:
    """True when autograd would record a call on `tensors`: grad enabled
    and one of them requires grad."""
    return torch.is_grad_enabled() and any(
        torch.is_tensor(t) and t.requires_grad for t in tensors)


def plain_vjp(plain, inputs, args, grad_out, needs):
    """The backward of every kernel Function: the plain version
    `plain(*inputs, *args)` recomputed under autograd at the saved
    `inputs`, and its gradients against `grad_out` for the inputs whose
    entry of `needs` is true (None for the others), as the JAX package's
    `custom_vjp`s take the VJP of their plain formulation. Called inside
    the Function's backward, so the forward's autocast state holds."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(bool(need))
                  for t, need in zip(inputs, needs)]
        out = plain(*leaves, *args)
        wrt = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wrt, grad_out.to(out.dtype)))
    return tuple(next(grads) if need else None for need in needs)


def autocast_off(device: torch.device):
    """A context with autocast off on `device`'s type; a null context on
    `meta`, where autocast does not exist (and so is never on)."""
    if device.type == "meta":
        return contextlib.nullcontext()
    return torch.autocast(device.type, enabled=False)


def autocast_dtype(x: torch.Tensor) -> Optional[torch.dtype]:
    """The autocast dtype for `x`'s device type when autocast is on there,
    else None."""
    dev = x.device.type
    if torch.is_autocast_enabled(dev):
        return torch.get_autocast_dtype(dev)
    return None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build_dir() -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into the shared library (once per source hash):
    one nvcc per source, all running at once, then one link."""
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    verbose_flags = ["-Xptxas=-v"] if verbose else []
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *verbose_flags, *NVCC_FLAGS, "-I", str(CSRC), "-c",
               "-o", str(obj), str(src)]
        jobs.append((obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for obj, proc in jobs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"{obj.name} ({proc.returncode}):\n{out}")
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    if not failed:
        res = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
             *[str(obj) for obj, _ in jobs], *LINK_FLAGS],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            failed.append(f"link ({res.returncode}):\n{res.stdout}")
    for obj, _ in jobs:
        obj.unlink(missing_ok=True)
    _state.build_seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    if verbose:
        print("".join(logs))
    os.replace(tmp, lib)
    return lib


def build_seconds() -> Optional[float]:
    """Seconds the last build in this process took (None: nothing built)."""
    return _state.build_seconds


def library() -> ctypes.CDLL:
    if _state.lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _state.lib = lib
    return _state.lib


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")
    return _DTYPE_CODES[t.dtype]


def check_operand(name: str, t: torch.Tensor, dtype: torch.dtype,
                  shape=None) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: expected a 16-byte aligned tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


def current_stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_status(name: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")
