"""Single-image inference: the counterpart of
multimodal_sam_adapter_tpu/apis/inference.py (the reference's
mmseg_custom/apis/inference.py:12-130).

- `init_segmentor(config_name, checkpoint=None, bf16=True, device="cuda")`
  -> a handle holding the model, its `InferenceEngine` and the config; the
  weights from a torch checkpoint (`engine/checkpoint.py`), or drawn from a
  torch.Generator seeded with 0;
- `inference_segmentor(handle, img_path, mod_path=None)` -> the (H, W)
  class map of one image file and its auxiliary modality (zeros when it
  is missing): the config's test pipeline, the pad to a multiple of 32,
  `InferenceEngine.predict`, the pad cut off for 'whole' and 'slide';
- `show_result_pyplot(handle, img_path, result, ...)` -> the palette blend
  (engine/visualize.py), written to `out_file` when given.

Files are read by data/image_io.py; the model runs on `device`, the card
unless the caller asks for "cpu".
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


class SegmentorHandle:
    def __init__(self, model, engine, cfg):
        self.model = model
        self.engine = engine
        self.cfg = cfg


def init_segmentor(config_name: str, checkpoint: Optional[str] = None,
                   bf16: bool = True, device="cuda") -> SegmentorHandle:
    from ..configs.registry import get_config
    from ..engine.checkpoint import load_state_dict_file
    from ..engine.inference import InferenceEngine
    from ..models.segmentor import build_segmentor

    cfg = get_config(config_name)
    m = cfg["model"]
    if m.get("head_type", "segformer") != "segformer":
        raise NotImplementedError(f"head {m['head_type']!r} is not ported")
    device = torch.device(device)
    if checkpoint:
        model = build_segmentor(
            m, device, state_dict=load_state_dict_file(checkpoint, device))
    else:
        model = build_segmentor(
            m, device, generator=torch.Generator(device=device).manual_seed(0))
    if bf16:
        model = model.to(torch.bfloat16)
    return SegmentorHandle(model, InferenceEngine(model, cfg["test_cfg"]),
                           cfg)


def prepare_input(handle: SegmentorHandle, img_path: str,
                  mod_path: Optional[str] = None
                  ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """The test pipeline's (H', W', C) input of one image, padded to a
    multiple of 32, and its unpadded (H, W)."""
    from ..data.pipelines import TestPipeline, load_multimodal_image
    from ..engine.evaluator import _pad_for_model

    mods_ch = handle.cfg["dataset"]["modalities_ch"]
    img = load_multimodal_image(img_path, [mod_path] if mod_path else [],
                                mods_ch[1:] if mod_path else [])
    if not mod_path and sum(mods_ch) > img.shape[2]:
        # the auxiliary modality is missing: its channels are zeros
        pad_c = sum(mods_ch) - img.shape[2]
        img = np.concatenate([img, np.zeros_like(img[..., :pad_c])], axis=2)
    sample = TestPipeline(handle.cfg["test_pipeline"], mods_ch)(
        {"img": img, "gt": None, "meta": {}})
    return _pad_for_model(sample["img"])


def inference_segmentor(handle: SegmentorHandle, img_path: str,
                        mod_path: Optional[str] = None) -> np.ndarray:
    """The (H, W) int64 class map of one image (+ auxiliary modality)."""
    arr, ori_hw = prepare_input(handle, img_path, mod_path)
    # a batch axis of torch's own strides, as the evaluator stacks its
    # batches (numpy's arr[None] has stride 0 there, which some bf16 ops
    # take another way)
    pred = handle.engine.predict(torch.from_numpy(arr)[None])[0].numpy()
    if handle.engine.test_cfg.get("mode", "whole") in ("whole", "slide"):
        pred = pred[:ori_hw[0], :ori_hw[1]]
    return pred


def show_result_pyplot(handle: SegmentorHandle, img_path: str,
                       result: np.ndarray, opacity: float = 0.5,
                       out_file: Optional[str] = None) -> np.ndarray:
    """The palette blend of `result` over the image file (BGR, uint8)."""
    from ..data.datasets import _DATASETS
    from ..data.image_io import imread
    from ..engine.visualize import show_result

    palette = _DATASETS[handle.cfg["dataset"]["type"]].PALETTE
    return show_result(imread(img_path, "color"), result, palette, opacity,
                       out_file)
