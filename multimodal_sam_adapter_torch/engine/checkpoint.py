"""Read a segmentor checkpoint in the forms the reference writes it: the
counterpart of multimodal_sam_adapter_tpu/engine/checkpoint.py:
load_torch_checkpoint, without its URL resolution (the port reads local
files only).

The reference's trained `.pth` is an mmcv container (`state_dict`, `meta`,
`optimizer`); other tools save `{"model": ...}` or the bare state_dict, and
a model wrapped in DistributedDataParallel prefixes every key with
`module.`.
"""
from __future__ import annotations

import pickle
from typing import Dict

import torch

CONTAINER_KEYS = ("state_dict", "model")
DDP_PREFIX = "module."


def load_state_dict_file(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    """The state_dict in the checkpoint file `path`, its tensors on
    `device`: unwrapped from `state_dict`, else `model` (the first of the
    two the file holds), with the `module.` prefix stripped. Reads with
    `weights_only=True`: tensors, numbers, strings and containers only."""
    try:
        ckpt = torch.load(path, map_location=device, weights_only=True)
    except pickle.UnpicklingError as e:
        raise RuntimeError(
            f"{path}: torch.load(weights_only=True) refuses it, so it holds "
            f"objects other than tensors, numbers, strings and containers "
            f"(save its state_dict alone): {e}") from e
    for key in CONTAINER_KEYS:
        if isinstance(ckpt, dict) and key in ckpt:
            ckpt = ckpt[key]
            break
    if not isinstance(ckpt, dict) or not all(
            torch.is_tensor(v) for v in ckpt.values()):
        raise RuntimeError(f"{path}: no state_dict of tensors in it (a bare "
                           f"one, or under {' or '.join(CONTAINER_KEYS)})")
    return {k[len(DDP_PREFIX):] if k.startswith(DDP_PREFIX) else k: v
            for k, v in ckpt.items()}
