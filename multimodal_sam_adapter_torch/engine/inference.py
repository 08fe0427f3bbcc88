"""Inference engine for the port: modes 'whole' and 'whole_dim' (the
flagship config's mode). The counterpart of
multimodal_sam_adapter_tpu/engine/inference.py; slide, flip TTA and
'whole_dim_cut' are not ported yet.

Images are tensors (B, H, W, C_in), already normalized, on the model's
device: the serve path reads no image files.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..utils.interpolate import resize_bilinear


def _resize_nhwc(x: torch.Tensor, hw: Sequence[int]) -> torch.Tensor:
    return resize_bilinear(x.permute(0, 3, 1, 2), hw).permute(0, 2, 3, 1)


class InferenceEngine:
    def __init__(self, model: torch.nn.Module, test_cfg: dict):
        mode = test_cfg.get("mode", "whole")
        if mode not in ("whole", "whole_dim"):
            raise NotImplementedError(f"test mode {mode!r} is not ported")
        self.model = model.eval()
        self.test_cfg = dict(test_cfg)

    @torch.inference_mode()
    def logits(self, img: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C_in) -> (B, H, W, num_classes)."""
        return self.model(img)

    def whole(self, img, ori_shape=None, rescale=True):
        out = self.logits(img)
        if (rescale and ori_shape is not None
                and tuple(ori_shape) != tuple(out.shape[1:3])):
            out = _resize_nhwc(out, ori_shape)
        return out

    def whole_dim(self, img, dim, rescale=True):
        out = self.logits(img)
        if rescale:
            out = _resize_nhwc(out, dim)
        return out

    @torch.inference_mode()
    def inference(self, img: torch.Tensor, ori_shape=None) -> torch.Tensor:
        """Class probabilities (B, H', W', classes), float32."""
        cfg = self.test_cfg
        if cfg.get("mode", "whole") == "whole":
            out = self.whole(img, ori_shape, cfg.get("rescale", True))
        else:
            out = self.whole_dim(img, cfg["dim"], cfg.get("rescale", True))
        return out.float().softmax(dim=-1)

    def predict(self, img: torch.Tensor, ori_shape=None) -> torch.Tensor:
        """argmax class map (B, H', W'), int64, on the host."""
        probs = self.inference(img, ori_shape)
        return probs.argmax(dim=-1).cpu()
