"""The host pipeline's native core, bound with ctypes: the normalize + pad
of csrc/host/pipeline_core.cpp (the counterpart of
multimodal_sam_adapter_tpu/data/native.py) and the PNG unfilter and
float32 resize of csrc/host/image_core.cpp (used by data/image_io.py and
data/resize.py, which hold their numpy twins).

The library is built with g++ at first use into `build/host/<hash>/` at the
root of the checkout, keyed by a hash of the sources, the flags and the
host (machine and node name), so it is never one built for another CPU. A
failed build raises with the compiler's message: callers that want the
numpy path ask for it (`TrainPipeline(..., native=False)`).
`normalize_pad_numpy` is the same arithmetic in numpy, bit-equal to the
library (it is built with -ffp-contract=off: every multiply and add rounds
on its own).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "host" / (
    "pipeline_core.cpp")
IMAGE_SOURCE = SOURCE.with_name("image_core.cpp")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "host"
LIB_NAME = "libmsa_pipeline.so"
CXX_FLAGS = ("-O3", "-funroll-loops", "-ffp-contract=off", "-fPIC",
             "-shared")

# the core's per-channel tables hold 64 entries
MAX_CHANNELS = 64

_LOCK = threading.Lock()
_LIB = None
_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def build_dir() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(IMAGE_SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(f"{platform.machine()} {platform.node()}".encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def load_native() -> ctypes.CDLL:
    """The library, built first if this host has none of this source."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        out = build_dir() / LIB_NAME
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
            cxx = os.environ.get("CXX", "g++")
            r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE),
                                str(IMAGE_SOURCE)],
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(
                    f"building {SOURCE.name} and {IMAGE_SOURCE.name} with "
                    f"{cxx} failed:\n{r.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        lib.msa_normalize_pad.argtypes = [
            _FP, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            _FP, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, _IP, _FP, _FP, _IP, _IP, ctypes.c_float]
        lib.msa_pad_label.argtypes = [
            _U8P, ctypes.c_int, ctypes.c_int, _U8P, ctypes.c_int,
            ctypes.c_int, ctypes.c_uint8]
        lib.msa_normalize_pad.restype = lib.msa_pad_label.restype = None
        lib.msa_png_unfilter.argtypes = [_U8P, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, _U8P]
        lib.msa_png_unfilter.restype = ctypes.c_int
        lib.msa_resize_f32.argtypes = [
            _FP, ctypes.c_int, ctypes.c_int,
            _FP, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            _IP, _IP, _FP, _FP, _IP, _IP, _FP, _FP, _U8P, ctypes.c_int]
        lib.msa_resize_f32.restype = None
        _LIB = lib
        return lib


def _check(hw, out_hw) -> None:
    if out_hw[0] < hw[0] or out_hw[1] < hw[1]:
        raise ValueError(f"pad target {tuple(out_hw)} smaller than the "
                         f"input {tuple(hw)}")


def _affine(modalities_ch, means, stds, to_rgb, div255):
    """Per source channel k: its destination channel and the float32
    (a, b) of out[dst[k]] = img[k] * a[k] + b[k], computed as the core
    computes them."""
    f32 = np.float32
    mean = np.concatenate([np.asarray(m, f32) for m in means])
    std = np.concatenate([np.asarray(s, f32) for s in stds])
    dst, a, b = [], [], []
    base = 0
    for ch, flip, d255 in zip(modalities_ch, to_rgb, div255):
        pre = f32(1) / f32(255) if d255 else f32(1)
        for j in range(ch):
            d = base + ch - 1 - j if flip else base + j
            dst.append(d)
            a.append(pre / std[d])
            b.append(-mean[d] / std[d])
        base += ch
    return (np.asarray(dst, np.int32), np.asarray(a, f32),
            np.asarray(b, f32), mean, std)


def normalize_pad_native(img: np.ndarray, modalities_ch: Sequence[int],
                         means, stds, to_rgb: Sequence[bool],
                         div255: Sequence[bool], out_hw: Tuple[int, int],
                         pad_val: float = 0.0) -> np.ndarray:
    """Per modality: optional /255, optional channel flip, (x - mean) /
    std (mean and std in the destination, post-flip, channel order), into
    an (out_h, out_w, C) float32 image padded bottom/right with pad_val."""
    lib = load_native()
    img = np.ascontiguousarray(img, np.float32)
    h, w, c = img.shape
    _check(img.shape[:2], out_hw)
    if c != sum(modalities_ch) or c > MAX_CHANNELS:
        raise ValueError(f"{c} channels for modalities {modalities_ch} "
                         f"(the core takes up to {MAX_CHANNELS})")
    out = np.empty((out_hw[0], out_hw[1], c), np.float32)
    _, _, _, mean, std = _affine(modalities_ch, means, stds, to_rgb, div255)
    ch = np.asarray(modalities_ch, np.int32)
    flip = np.asarray([1 if f else 0 for f in to_rgb], np.int32)
    d255 = np.asarray([1 if d else 0 for d in div255], np.int32)
    lib.msa_normalize_pad(
        img.ctypes.data_as(_FP), h, w, c, out.ctypes.data_as(_FP),
        out.shape[0], out.shape[1], len(modalities_ch),
        ch.ctypes.data_as(_IP), mean.ctypes.data_as(_FP),
        std.ctypes.data_as(_FP), flip.ctypes.data_as(_IP),
        d255.ctypes.data_as(_IP), ctypes.c_float(pad_val))
    return out


def normalize_pad_numpy(img: np.ndarray, modalities_ch: Sequence[int],
                        means, stds, to_rgb: Sequence[bool],
                        div255: Sequence[bool], out_hw: Tuple[int, int],
                        pad_val: float = 0.0) -> np.ndarray:
    """`normalize_pad_native` in numpy, with the same float32 arithmetic."""
    img = np.asarray(img, np.float32)
    h, w, c = img.shape
    dst, a, b, _, _ = _affine(modalities_ch, means, stds, to_rgb, div255)
    out = np.full((out_hw[0], out_hw[1], c), np.float32(pad_val), np.float32)
    out[:h, :w, dst] = img * a + b
    return out


def pad_label_native(lab: np.ndarray, out_hw: Tuple[int, int],
                     pad_val: int = 255) -> np.ndarray:
    lib = load_native()
    lab = np.ascontiguousarray(lab, np.uint8)
    _check(lab.shape, out_hw)
    out = np.empty(out_hw, np.uint8)
    lib.msa_pad_label(lab.ctypes.data_as(_U8P), lab.shape[0], lab.shape[1],
                      out.ctypes.data_as(_U8P), out.shape[0], out.shape[1],
                      pad_val)
    return out


def pad_label_numpy(lab: np.ndarray, out_hw: Tuple[int, int],
                    pad_val: int = 255) -> np.ndarray:
    out = np.full(out_hw, pad_val, np.uint8)
    out[:lab.shape[0], :lab.shape[1]] = lab
    return out
