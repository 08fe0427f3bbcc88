"""Inference engine for the port: modes 'whole', 'whole_dim',
'whole_dim_cut', 'slide' and 'slide_mod_sel', flip undo and flip /
multi-scale averaging. The counterpart of
multimodal_sam_adapter_tpu/engine/inference.py, mode for mode:

- every mode cuts an evaluator pad band (`valid_hw`) off the logits before
  its final resize;
- slide stacks all windows of an image into ONE batched forward, then
  scatter-adds the window logits and divides by the overlap count;
- the order is the reference's: logits -> resize -> softmax (float32) ->
  flip undo.

Images are tensors (B, H, W, C_in), already normalized; the engine moves
them to the model's device and dtype. The serve path reads no image files.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..utils.interpolate import resize_bilinear

MODES = ("whole", "whole_dim", "whole_dim_cut", "slide", "slide_mod_sel")


def _resize_nhwc(x: torch.Tensor, hw: Sequence[int]) -> torch.Tensor:
    return resize_bilinear(x.permute(0, 3, 1, 2), hw).permute(0, 2, 3, 1)


def slide_windows(hw: Tuple[int, int], crop_size: Tuple[int, int],
                  stride: Tuple[int, int]) -> List[Tuple[int, int]]:
    """Top-left corners (y1, x1) of the overlapping crops over an (H, W)
    image: a grid at `stride`, the last row and column shifted back to end
    at the image border."""
    H, W = hw
    ch, cw = crop_size
    sh, sw = stride
    h_grids = max(H - ch + sh - 1, 0) // sh + 1
    w_grids = max(W - cw + sw - 1, 0) // sw + 1
    return [(min(hi * sh, max(H - ch, 0)), min(wi * sw, max(W - cw, 0)))
            for hi in range(h_grids) for wi in range(w_grids)]


class InferenceEngine:
    def __init__(self, model: torch.nn.Module, test_cfg: dict):
        mode = test_cfg.get("mode", "whole")
        if mode not in MODES:
            raise ValueError(f"unknown test mode {mode!r}")
        self.model = model.eval()
        self.test_cfg = dict(test_cfg)
        param = next(model.parameters())
        self.device, self.dtype = param.device, param.dtype

    @torch.inference_mode()
    def logits(self, img: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C_in) -> (B, H, W, num_classes)."""
        return self.model(img.to(device=self.device, dtype=self.dtype))

    @staticmethod
    def _crop_valid(out: torch.Tensor, valid_hw) -> torch.Tensor:
        """Cut an evaluator pad band off the logits BEFORE the mode's final
        resize, as an exact-size run would see them."""
        if valid_hw is not None and tuple(valid_hw) != tuple(out.shape[1:3]):
            out = out[:, :valid_hw[0], :valid_hw[1]]
        return out

    # -- modes -------------------------------------------------------------
    def whole(self, img, ori_shape=None, rescale=True, valid_hw=None):
        out = self._crop_valid(self.logits(img), valid_hw)
        if (rescale and ori_shape is not None
                and tuple(ori_shape) != tuple(out.shape[1:3])):
            out = _resize_nhwc(out, ori_shape)
        return out

    def whole_dim(self, img, dim, rescale=True, valid_hw=None):
        out = self._crop_valid(self.logits(img), valid_hw)
        if rescale:
            out = _resize_nhwc(out, dim)
        return out

    def whole_dim_cut(self, img, dim, cut_dim, rescale=False, valid_hw=None):
        out = self._crop_valid(self.logits(img), valid_hw)
        if rescale:
            out = _resize_nhwc(out, dim)
        # cut_dim is (w, h): keep [:h, :w]
        return out[:, :cut_dim[1], :cut_dim[0]]

    @torch.inference_mode()
    def slide(self, img: torch.Tensor, crop_size, stride) -> torch.Tensor:
        """Overlapping crops as one batch through one forward, scatter-added
        back and divided by the overlap count. One image per call. The sum
        runs in float32 (the JAX engine sums in the logits' dtype)."""
        B, H, W, _ = img.shape
        if B != 1:
            raise ValueError(f"slide inference takes one image, got {B}")
        ch, cw = crop_size
        boxes = slide_windows((H, W), crop_size, stride)
        crops = torch.stack([img[0, y1:y1 + ch, x1:x1 + cw]
                             for y1, x1 in boxes])
        logits = self.logits(crops).float()
        h, w = logits.shape[1:3]
        preds = logits.new_zeros((H, W, logits.shape[-1]))
        count = logits.new_zeros((H, W, 1))
        for (y1, x1), lg in zip(boxes, logits):
            preds[y1:y1 + h, x1:x1 + w] += lg
            count[y1:y1 + h, x1:x1 + w] += 1.0
        return (preds / count)[None]

    # -- public API ---------------------------------------------------------
    @torch.inference_mode()
    def inference(self, img: torch.Tensor, ori_shape=None, flip: bool = False,
                  flip_direction: str = "horizontal",
                  valid_hw: Optional[Sequence[int]] = None) -> torch.Tensor:
        """Class probabilities (B, H', W', classes), float32, on the model's
        device; `flip` undoes a flip of the input. valid_hw: the unpadded
        (H, W) when the caller padded the input."""
        cfg = self.test_cfg
        mode = cfg.get("mode", "whole")
        if mode == "whole":
            out = self.whole(img, ori_shape, cfg.get("rescale", True),
                             valid_hw)
        elif mode == "whole_dim":
            out = self.whole_dim(img, cfg["dim"], cfg.get("rescale", True),
                                 valid_hw)
        elif mode == "whole_dim_cut":
            out = self.whole_dim_cut(img, cfg["dim"], cfg["cut_dim"],
                                     cfg.get("rescale", False), valid_hw)
        else:
            # slide_mod_sel also averages a per-window modality-selector
            # map when the decode head emits one; no shipped head does, so
            # it is slide
            out = self.slide(img, tuple(cfg["crop_size"]),
                             tuple(cfg["stride"]))
            out = self._crop_valid(out, valid_hw)
            if (ori_shape is not None
                    and tuple(ori_shape) != tuple(out.shape[1:3])):
                out = _resize_nhwc(out, ori_shape)
        probs = out.float().softmax(dim=-1)
        if flip:
            probs = probs.flip(2 if flip_direction == "horizontal" else 1)
        return probs

    def predict(self, img: torch.Tensor, ori_shape=None,
                valid_hw=None) -> torch.Tensor:
        """argmax class map (B, H', W'), int64, on the host."""
        probs = self.inference(img, ori_shape, valid_hw=valid_hw)
        return probs.argmax(dim=-1).cpu()

    def aug_test(self, imgs: List[torch.Tensor], flips: List[bool],
                 ori_shape) -> torch.Tensor:
        """Multi-scale + flip TTA: the softmax averaged over the
        augmentations, then argmax (B, H', W'), int64, on the host."""
        acc = None
        for img, flip in zip(imgs, flips):
            p = self.inference(img, ori_shape, flip=flip)
            acc = p if acc is None else acc + p
        return (acc / len(imgs)).argmax(dim=-1).cpu()
