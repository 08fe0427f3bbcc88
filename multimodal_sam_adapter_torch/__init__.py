"""Multimodal SAM-Adapter, PyTorch and CUDA port (Hopper).

The counterpart of `multimodal_sam_adapter_tpu`, which stays the reference:
same modules, same parameter names (the reference checkpoint keys), same
public NHWC layouts. The TPU's Pallas kernels on the inference path are
hand-written CUDA kernels here (`csrc/`, bound in `ops/kernels.py`).
"""

__version__ = "0.1.0"
