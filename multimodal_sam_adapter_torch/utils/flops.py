"""The work a forward does: operations and bytes, counted from shapes.

`work(name, args, out)` is what kernel `name` (K1-K6) must do on its
wrapper's arguments, whatever the kernel does again: the bytes of each
tensor input read once and the output written once, and its operations,
split into those of the tensor cores (matrix products) and the rest.
`kernel_checks.py` derives each kernel's bound from it; `WorkCounter`
adds it up over a forward.

Inside `with WorkCounter() as wc:` every operation is counted once:

- each kernel's entry point (decorated with `counted`) adds its `work` at
  its call site, on the kernel path and on the plain path alike; the
  counter's dispatch modes are suspended inside the call, so the plain
  version's own aten ops are not counted again;
- every other op goes through `torch.utils.flop_counter.FlopCounterMode`:
  convolutions, linears and matmuls (`products`, 2 operations a
  multiply-add), and the bilinear / bicubic / linear interpolations
  (`interpolations`: 2 operations a tap of each output element, a
  formula of this module given to FlopCounterMode);
- `bytes` adds, for every aten op outside the kernels that is not a view,
  the bytes of its tensor inputs and outputs (a broadcast dimension
  counted once), and each kernel's `work` bytes: a floor, each op's
  inputs read once and its output written once. XLA's "bytes accessed"
  counts the fused program's buffers instead, so the two do not compare.

Elementwise work outside the kernels (adds, norms, activations, softmax)
is not counted: FlopCounterMode has no formula for it.

The count needs shapes only, so it runs on the `meta` device, where every
op of the plain path has a meta kernel (`grid_sample` and the depthwise
convolution included) and `ops/kernels.py` sends every wrapper to its
plain version. The same forward on the CPU or on the card's kernel path
gives the same operation counts.
"""
from __future__ import annotations

import functools
import inspect
from typing import Callable, Dict, Optional, Tuple, Union

import torch

def attention_geometry(args) -> Tuple[int, int, int, Tuple[int, int]]:
    """(batch x heads, tokens, head width, (H, W)) of K1 / K2 args."""
    qkv, _, _, hw, heads, _ = args
    hw = (hw, hw) if isinstance(hw, int) else tuple(hw)
    return (qkv.shape[0] * heads, qkv.shape[1], qkv.shape[2] // (3 * heads),
            hw)


def work(name: str, args: tuple, out: torch.Tensor) -> Dict[str, float]:
    """What the function must do on `args`, whatever a kernel does again:
    bytes (each tensor input read once, the output written once) and
    operations, split into those of the tensor cores (matrix products; in
    float32 they run on the CUDA cores all the same) and the rest."""
    if name == "convnext_block":  # out has x's shape (not a guarded buffer's)
        out = args[0]
    nbytes = sum(a.numel() * a.element_size() for a in args
                 if torch.is_tensor(a)) + out.numel() * out.element_size()
    tensor_ops = other_ops = 0.0
    if name in ("window_attention", "flash_attention"):
        BM, N, d, (H, W) = attention_geometry(args)
        # q.k and p.v; q against the gathered rel-pos rows of each (query,
        # key row) and (query, key column); bias add, max, exp, sum, scale
        tensor_ops = BM * (4.0 * N * N * d + 2.0 * N * (H + W) * d)
        other_ops = BM * 6.0 * N * N
    elif name in ("msda_multi_level", "msda_single_level"):
        value, shapes, _, offs, _, heads, points = args
        B, Lq, _ = offs.shape
        D = value.shape[-1] // heads
        samples = B * Lq * heads * len(shapes) * points
        # four corner weights and a bilinear sum of D values per sample
        other_ops = samples * (16.0 + 8.0 * D)
    elif name == "convnext_block":
        x = args[0]
        B, H, W, C = x.shape
        P = B * H * W
        tensor_ops = 2.0 * P * C * 4 * C * 2          # fc1 and fc2
        # dwconv 7x7, LayerNorm, GELU of the 4C hidden units, gamma, add
        other_ops = P * C * (2.0 * 49 + 10 + 4 * 8)
    elif name == "pixel_shuffle_up_bn":
        c2, weight = args[0], args[1]
        B, C, H, W = c2.shape
        O = weight.shape[1]
        tensor_ops = 2.0 * B * H * W * C * 4 * O
        other_ops = 4.0 * B * H * W * 4 * O            # + c1 + x1, affine
    else:
        raise KeyError(name)
    return dict(bytes=float(nbytes), tensor_ops=tensor_ops,
                other_ops=other_ops)


# ------------------------------------------------------------ interpolation

def _taps_formula(taps: int):
    """A FlopCounterMode formula: 2 operations for each of `taps` taps of
    every output element."""
    def formula(*args, out_shape=None, **kwargs) -> int:
        n = 1
        for s in out_shape:
            n *= s
        return 2 * taps * n
    return formula


_aten = torch.ops.aten
INTERPOLATIONS = {
    _aten.upsample_linear1d: _taps_formula(2),
    _aten.upsample_bilinear2d: _taps_formula(4),
    _aten.upsample_bicubic2d: _taps_formula(16),
}


def _storage_bytes(t: torch.Tensor) -> int:
    """t's bytes with each broadcast (stride 0) dimension counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


class _BytesMode(torch.utils._python_dispatch.TorchDispatchMode):
    """Adds the bytes of every op's tensor inputs and outputs, views
    excepted, to `total`."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view:
            tensors = [t for t in torch.utils._pytree.tree_leaves(
                (args, kwargs, out)) if isinstance(t, torch.Tensor)]
            self.total += sum(_storage_bytes(t) for t in tensors)
        return out


# ---------------------------------------------------------------- counting

_active: Optional["WorkCounter"] = None


class WorkCounter:
    """A context that counts the work of the code it runs (see the module's
    docstring). After it exits: `products`, `interpolations`, `bytes`,
    `kernels` ({name: {"calls", "bytes", "tensor_ops", "other_ops"}}),
    `modules` (FlopCounterMode's {module path: {op: operations}}, each
    module's count including its children's) and `totals()`."""

    def __init__(self):
        self.products = 0.0
        self.interpolations = 0.0
        self.bytes = 0.0
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.modules: Dict[str, Dict] = {}
        self._flop_mode = self._bytes_mode = None

    def __enter__(self) -> "WorkCounter":
        global _active
        if _active is not None:
            raise RuntimeError("a WorkCounter is already counting")
        from torch.utils.flop_counter import FlopCounterMode

        self._flop_mode = FlopCounterMode(display=False,
                                          custom_mapping=INTERPOLATIONS)
        self._bytes_mode = _BytesMode()
        self._flop_mode.__enter__()
        self._bytes_mode.__enter__()
        _active = self
        return self

    def __exit__(self, *exc):
        global _active
        _active = None
        self._bytes_mode.__exit__(*exc)
        self._flop_mode.__exit__(*exc)
        self.modules = self._flop_mode.get_flop_counts()
        by_op = self.modules.get("Global", {})
        interp = set(INTERPOLATIONS)
        self.products = float(sum(v for k, v in by_op.items()
                                  if k not in interp))
        self.interpolations = float(sum(v for k, v in by_op.items()
                                        if k in interp))
        self.bytes += float(self._bytes_mode.total)
        return False

    def add_kernel(self, name: str, args: tuple, out: torch.Tensor) -> None:
        w = work(name, args, out)
        k = self.kernels.setdefault(name, dict(calls=0, bytes=0.0,
                                               tensor_ops=0.0,
                                               other_ops=0.0))
        k["calls"] += 1
        for key in ("bytes", "tensor_ops", "other_ops"):
            k[key] += w[key]
        self.bytes += w["bytes"]

    def totals(self) -> Dict[str, float]:
        """The count by kind: `products` (convolutions and matmuls outside
        the kernels), `interpolations`, the kernels' `tensor_ops` and
        `other_ops`, their sum `flops`, and `bytes`."""
        t = dict(products=self.products, interpolations=self.interpolations,
                 tensor_ops=sum(k["tensor_ops"]
                                for k in self.kernels.values()),
                 other_ops=sum(k["other_ops"]
                               for k in self.kernels.values()))
        t["flops"] = sum(t.values())
        t["bytes"] = self.bytes
        return t


def counted(name: Union[str, Callable[[tuple], str]]):
    """Decorator of a kernel's entry point: inside a `WorkCounter`, the
    call adds `work(name, args, out)` (`name` a kernel's name, or a
    function of the call's arguments giving it) and nothing else, whichever
    path serves it; outside one it is the entry point as it is."""
    def wrap(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def call(*args, **kwargs):
            global _active
            counter = _active
            if counter is None:
                return fn(*args, **kwargs)
            bound = sig.bind(*args, **kwargs).arguments
            operands = tuple(v for k, v in bound.items() if k != "out")
            _active = None
            try:
                with torch.utils._python_dispatch._disable_current_modes():
                    out = fn(*args, **kwargs)
            finally:
                _active = counter
            counter.add_kernel(name if isinstance(name, str)
                               else name(operands), operands, out)
            return out
        return call
    return wrap
