"""Prediction visualisation: palette-blended dumps (the counterpart of
multimodal_sam_adapter_tpu/engine/visualize.py).

The reference's show_result path (apis/test_bs.py:290-316 and
BaseSegmentor.show_result): blend the palette-coloured prediction over the
BGR image with `opacity` and write it to
out_dir/prediction/<condition>/<case>/<stem>.png. The image is resized to
the prediction's grid, where they differ, by data/resize.py's uint8
INTER_LINEAR (OpenCV's fixed-point path) and written by data/image_io.py,
so the files decode to the arrays the JAX package writes.
"""
from __future__ import annotations

import os
import os.path as osp
from typing import Optional, Sequence

import numpy as np

from ..data.image_io import imwrite
from ..data.resize import resize


def colorize(pred: np.ndarray, palette: Sequence[Sequence[int]]
             ) -> np.ndarray:
    """(H, W) class map -> (H, W, 3) palette colours (RGB), classes past
    the palette's end clipped to its last entry."""
    pal = np.asarray(palette, np.uint8)
    return pal[np.clip(pred, 0, len(pal) - 1)]


def show_result(img_bgr: np.ndarray, pred: np.ndarray, palette,
                opacity: float = 0.5, out_file: Optional[str] = None
                ) -> np.ndarray:
    """The uint8 BGR blend img * (1 - opacity) + colour * opacity,
    truncated; written to `out_file` (its directory made) when given."""
    color = colorize(pred, palette)[:, :, ::-1]   # the palette is RGB
    if img_bgr.shape[:2] != color.shape[:2]:
        img_bgr = resize(img_bgr, (color.shape[1], color.shape[0]))
    blended = (img_bgr * (1 - opacity) + color * opacity).astype(np.uint8)
    if out_file:
        os.makedirs(osp.dirname(out_file), exist_ok=True)
        imwrite(out_file, blended)
    return blended


def dump_prediction(out_dir: str, condition: Optional[str],
                    case: Optional[str], name: str, img_bgr, pred, palette,
                    opacity: float = 0.5) -> np.ndarray:
    """`show_result` into out_dir/prediction/<condition or 'all'>/<case or
    'ordinary'>/<name>."""
    sub = osp.join(out_dir, "prediction", condition or "all",
                   case or "ordinary")
    return show_result(img_bgr, pred, palette, opacity, osp.join(sub, name))
