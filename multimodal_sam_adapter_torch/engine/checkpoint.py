"""Checkpoints of the port: the counterpart of
multimodal_sam_adapter_tpu/engine/checkpoint.py, in torch files.

- `save_checkpoint` (the state of a model and an optimizer) and
  `write_checkpoint` (given states) write `<ckpt_dir>/step_<N>.pth` (or
  `<tag>.pth`, e.g. `best.pth`) in the reference's mmcv form, {"meta",
  "state_dict", "optimizer"}, keeping the newest `max_keep` step files;
  `meta` holds plain types only (the train entry's config, CLASSES,
  PALETTE, seed, ... plus epoch, iter and step), so that
  `torch.load(weights_only=True)` reads the whole file;
- `restore_checkpoint` reads one back, `latest_checkpoint` finds the
  newest step file;
- `load_state_dict_file` reads the model's state_dict from any of the
  forms the reference writes: the mmcv container, `{"model": ...}` or a
  bare state_dict, with DistributedDataParallel's `module.` prefix
  stripped; `read_checkpoint` also returns the container's `meta`. Both
  take a path or a URL (`resolve_checkpoint_source`), and so do the
  ingestion functions below;
- `ingest_sam_pth`, `ingest_convnext_pth` and `merge_pretrained`: a SAM
  image encoder and an ImageNet ConvNeXt into the segmentor's state_dict
  (an RGB-only segmentor takes the SAM encoder alone: it has no ConvNeXt),
  or the SAM encoder into the standalone `ImageEncoderViT`.
  The port's names are the reference's keys, so ingestion renames keys
  (the ConvNeXt into both twin branches) and checks shapes; the JAX
  package also converts layouts there.
"""
from __future__ import annotations

import os
import pickle
import re
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch

CONTAINER_KEYS = ("state_dict", "model")
DDP_PREFIX = "module."
SAM_ENCODER_PREFIX = "image_encoder."
SAM_BLOCK_KEYS = (
    "norm1.weight", "norm1.bias", "norm2.weight", "norm2.bias",
    "attn.rel_pos_h", "attn.rel_pos_w", "attn.qkv.weight", "attn.qkv.bias",
    "attn.proj.weight", "attn.proj.bias", "mlp.lin1.weight", "mlp.lin1.bias",
    "mlp.lin2.weight", "mlp.lin2.bias")
CONVNEXT_BLOCK_KEYS = (
    "depthwise_conv.weight", "depthwise_conv.bias", "norm.weight",
    "norm.bias", "pointwise_conv1.weight", "pointwise_conv1.bias",
    "pointwise_conv2.weight", "pointwise_conv2.bias", "gamma")


def _load(path, device="cpu"):
    try:
        return torch.load(path, map_location=device, weights_only=True)
    except pickle.UnpicklingError as e:
        raise RuntimeError(
            f"{path}: torch.load(weights_only=True) refuses it, so it holds "
            f"objects other than tensors, numbers, strings and containers "
            f"(save its state_dict alone): {e}") from e


def resolve_checkpoint_source(path: str,
                              cache_dir: Optional[str] = None) -> str:
    """A checkpoint source as a local path: an http(s):// or file:// URL is
    fetched once into `cache_dir` (default
    ~/.cache/multimodal_sam_adapter_torch/checkpoints, or
    $MSA_CHECKPOINT_CACHE), as <sha256 of the URL, 16 hex digits>_<its
    basename>, through a `.part` file renamed into place; later calls find
    it there. Any other string is returned unchanged. The reference's
    pavi://, s3:// and open-mmlab:// schemes are internal services and
    are not read."""
    if not re.match(r"^(https?|file)://", path):
        return path
    import hashlib
    import urllib.request

    cache_dir = (cache_dir or os.environ.get("MSA_CHECKPOINT_CACHE")
                 or os.path.expanduser(
                     "~/.cache/multimodal_sam_adapter_torch/checkpoints"))
    os.makedirs(cache_dir, exist_ok=True)
    name = os.path.basename(path.split("?")[0]) or "checkpoint"
    dest = os.path.join(cache_dir, hashlib.sha256(
        path.encode()).hexdigest()[:16] + "_" + name)
    if not os.path.exists(dest):
        tmp = dest + ".part"
        urllib.request.urlretrieve(path, tmp)
        os.replace(tmp, dest)
    return dest


def load_state_dict_file(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    """The state_dict in the checkpoint file `path`, its tensors on
    `device`: unwrapped from `state_dict`, else `model` (the first of the
    two the file holds), with the `module.` prefix stripped. Reads with
    `weights_only=True`: tensors, numbers, strings and containers only."""
    return read_checkpoint(path, device)[0]


def read_checkpoint(path: str, device="cpu"
                    ) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """(`load_state_dict_file`'s state_dict, the container's `meta` or {})
    from one read of the file (`path` a path or a URL)."""
    ckpt = _load(resolve_checkpoint_source(path), device)
    meta = ckpt.get("meta") if isinstance(ckpt, dict) else None
    meta = meta if isinstance(meta, dict) else {}
    for key in CONTAINER_KEYS:
        if isinstance(ckpt, dict) and key in ckpt:
            ckpt = ckpt[key]
            break
    if not isinstance(ckpt, dict) or not all(
            torch.is_tensor(v) for v in ckpt.values()):
        raise RuntimeError(f"{path}: no state_dict of tensors in it (a bare "
                           f"one, or under {' or '.join(CONTAINER_KEYS)})")
    return {k[len(DDP_PREFIX):] if k.startswith(DDP_PREFIX) else k: v
            for k, v in ckpt.items()}, meta


# ---------------------------------------------------------------- save / load

def _step_of(path: Path) -> Optional[int]:
    m = re.fullmatch(r"step_(\d+)\.pth", path.name)
    return int(m.group(1)) if m else None


def save_checkpoint(ckpt_dir: str, model: torch.nn.Module, optimizer,
                    step: int, meta: Optional[Dict] = None,
                    max_keep: int = 1, tag: Optional[str] = None) -> str:
    """`write_checkpoint` of the model's and the optimizer's state."""
    return write_checkpoint(ckpt_dir, model.state_dict(),
                            optimizer.state_dict(), step, meta, max_keep, tag)


def write_checkpoint(ckpt_dir: str, state_dict: Dict[str, torch.Tensor],
                     optimizer_state: Dict, step: int,
                     meta: Optional[Dict] = None, max_keep: int = 1,
                     tag: Optional[str] = None) -> str:
    """Write {"meta": meta + {"step": step}, "state_dict": `state_dict`,
    "optimizer": `optimizer_state`} to `<ckpt_dir>/step_<step>.pth` (or
    `<tag>.pth`), through a temporary file, then drop all but the newest
    `max_keep` step files (max_keep <= 0 keeps all; a tagged save prunes
    nothing). A tensor-parallel run writes its gathered, unsharded state
    (parallel/tp.py:gather_train_state). Returns the path."""
    d = Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"{tag or f'step_{step}'}.pth"
    payload = {"meta": dict(meta or {}, step=int(step)),
               "state_dict": state_dict, "optimizer": optimizer_state}
    tmp = path.with_name(path.name + f".{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)
    if tag is None and max_keep > 0:
        steps = sorted((s, p) for p in d.iterdir()
                       if (s := _step_of(p)) is not None)
        for _, old in steps[:-max_keep]:
            old.unlink()
    return str(path)


def restore_checkpoint(path: str, device="cpu") -> Dict:
    """The payload of a checkpoint written by `save_checkpoint`, read with
    `weights_only=True`, its tensors on `device`."""
    payload = _load(path, device)
    missing = {"meta", "state_dict", "optimizer"} - set(payload)
    if missing:
        raise RuntimeError(f"{path}: not a train checkpoint (no "
                           f"{', '.join(sorted(missing))})")
    return payload


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The step file with the largest step in `ckpt_dir`, or None."""
    d = Path(ckpt_dir)
    if not d.is_dir():
        return None
    steps = [(s, p) for p in d.iterdir() if (s := _step_of(p)) is not None]
    return str(max(steps)[1]) if steps else None


# ---------------------------------------------------------------- ingestion

def _block_index(i: int, interaction_indexes) -> None:
    if not any(lo <= i <= hi for lo, hi in interaction_indexes):
        raise ValueError(f"block {i} not covered by {interaction_indexes}")


def ingest_sam_pth(path: str, interaction_indexes: Sequence[Tuple[int, int]]
                   = ((0, 5), (6, 11), (12, 17), (18, 23)),
                   standalone: bool = False) -> Dict[str, torch.Tensor]:
    """A SAM checkpoint (the whole SAM, or its image encoder alone) -> the
    segmentor's `backbone.*` keys: the encoder's keys kept (the
    `image_encoder.` prefix stripped, `neck.*` dropped), any other key
    refused. `standalone=True` returns them without the `backbone.`
    prefix, the keys of models/sam_vit.py:ImageEncoderViT (its blocks need
    no interaction stage: `interaction_indexes` is not read)."""
    sd = load_state_dict_file(path)
    if any(k.startswith(SAM_ENCODER_PREFIX) for k in sd):
        sd = {k[len(SAM_ENCODER_PREFIX):]: v for k, v in sd.items()
              if k.startswith(SAM_ENCODER_PREFIX)}
    out = {}
    for k, v in sd.items():
        if k.startswith("neck."):
            continue
        m = re.fullmatch(r"blocks\.(\d+)\.(.+)", k)
        if m:
            if not standalone:
                _block_index(int(m.group(1)), interaction_indexes)
            if m.group(2) not in SAM_BLOCK_KEYS:
                raise KeyError(f"unmapped ViT block key: {m.group(2)}")
        elif k not in ("pos_embed", "patch_embed.proj.weight",
                       "patch_embed.proj.bias"):
            raise KeyError(f"unmapped SAM encoder key: {k}")
        out[k if standalone else f"backbone.{k}"] = v
    return out


def ingest_convnext_pth(path: str) -> Dict[str, torch.Tensor]:
    """An ImageNet ConvNeXt checkpoint (mmpretrain layout, keys with or
    without `backbone.`) -> both twin branches of the spatial prior:
    `downsample_layers.*`, `stages.*` and `norm<i>` become their `_x` and
    `_y` keys; the classifier head and the final norm are dropped."""
    out = {}
    base = "backbone.spm.twin_conv"
    for k, v in load_state_dict_file(path).items():
        k = k[len("backbone."):] if k.startswith("backbone.") else k
        if re.fullmatch(r"downsample_layers\.\d+\.[01]\.(weight|bias)", k):
            names = [f"downsample_layers_{b}{k[len('downsample_layers'):]}"
                     for b in "xy"]
        elif m := re.fullmatch(r"stages\.(\d+\.\d+)\.(.+)", k):
            if m.group(2) not in CONVNEXT_BLOCK_KEYS:
                raise KeyError(f"unmapped ConvNeXt stage key: {k}")
            names = [f"stages_{b}.{m.group(1)}.{m.group(2)}" for b in "xy"]
        elif m := re.fullmatch(r"norm(\d)\.(weight|bias)", k):
            names = [f"norm_{b}{m.group(1)}.{m.group(2)}" for b in "xy"]
        elif k.startswith(("head.", "norm.", "gap")):
            continue
        else:
            raise KeyError(f"unmapped ConvNeXt key: {k}")
        for n in names:
            out[f"{base}.{n}"] = v.clone()
    return out


def merge_pretrained(state_dict: Dict[str, torch.Tensor],
                     pretrained: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """A copy of `state_dict` with `pretrained`'s tensors in place of its
    own (cast to the model's dtype and device): a pretrained key the model
    lacks raises KeyError, a shape that differs ValueError; keys it does
    not hold keep their init."""
    out = dict(state_dict)
    for k, v in pretrained.items():
        if k not in out:
            raise KeyError(f"pretrained key {k} not in model params")
        if tuple(v.shape) != tuple(out[k].shape):
            raise ValueError(f"shape mismatch at {k}: model "
                             f"{tuple(out[k].shape)} vs checkpoint "
                             f"{tuple(v.shape)}")
        out[k] = v.to(dtype=out[k].dtype, device=out[k].device)
    return out
