"""The reference's test modes: what a served request's class map is.

`whole_dim`: the segmentor's logits (already at the input's size),
resized bilinearly to `dim`. `slide`: the image cut into crop_size
windows at `stride` (the last row and column of windows moved back to end
at the border), each window's logits added into a float32 canvas and
divided by the number of windows covering each pixel. Then the float32
softmax over classes; the class map is its argmax.

`logits_of` returns the float32 logits (B, H, W, classes) the softmax is
taken of; it runs one image at a time and, for `slide`, one window at a
time, so that the reference fits beside nothing else on the card.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from .model import resize


def slide_windows(hw, crop, stride) -> List[Tuple[int, int]]:
    H, W = hw
    ch, cw = crop
    sh, sw = stride
    rows = max(H - ch + sh - 1, 0) // sh + 1
    cols = max(W - cw + sw - 1, 0) // sw + 1
    return [(min(r * sh, max(H - ch, 0)), min(c * sw, max(W - cw, 0)))
            for r in range(rows) for c in range(cols)]


@torch.no_grad()
def logits_of(model, img: torch.Tensor, test_cfg: dict) -> torch.Tensor:
    """img (1, H, W, C_in) float32 -> float32 logits in the mode's output
    grid, (1, H', W', classes)."""
    mode = test_cfg["mode"]
    if mode == "whole_dim":
        out = model(img)
        return resize(out.permute(0, 3, 1, 2),
                      test_cfg["dim"]).permute(0, 2, 3, 1)
    if mode == "slide":
        _, H, W, _ = img.shape
        ch, cw = test_cfg["crop_size"]
        canvas = count = None
        for y, x in slide_windows((H, W), test_cfg["crop_size"],
                                  test_cfg["stride"]):
            lg = model(img[:, y:y + ch, x:x + cw])[0]
            if canvas is None:
                canvas = lg.new_zeros((H, W, lg.shape[-1]))
                count = lg.new_zeros((H, W, 1))
            canvas[y:y + ch, x:x + cw] += lg
            count[y:y + ch, x:x + cw] += 1.0
        return (canvas / count)[None]
    raise ValueError(f"the reference has no test mode {mode!r}")
