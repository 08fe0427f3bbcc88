"""Colour label PNGs with a dataset's palette (the counterpart of the root
`tools/color_gt.py`, with the port's palettes, data/datasets.py):

    python -m multimodal_sam_adapter_torch.tools.color_gt \
        DELIVER|FMB|MUSES gt_dir out_dir

Each label PNG of `gt_dir` (read unchanged, channel 0 of a 3-channel file)
becomes an RGB picture of its classes in `out_dir`, under the same name;
labels at or past the palette's length are black. The files decode, with
OpenCV or `data/image_io.py`, to the root tool's.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np

from ..data.datasets import CITYSCAPES_PALETTE, DELIVER_PALETTE, FMB_PALETTE
from ..data.image_io import imread, imwrite

PALETTES = {"DELIVER": DELIVER_PALETTE, "FMB": FMB_PALETTE,
            "MUSES": CITYSCAPES_PALETTE}


def colorize(gt: np.ndarray, palette) -> np.ndarray:
    """A (H, W) label map -> its (H, W, 3) BGR picture (labels at or past
    the palette's length black)."""
    pal = np.asarray(palette, np.uint8)
    color = pal[np.clip(gt, 0, len(pal) - 1)][:, :, ::-1]
    color[gt >= len(pal)] = 0
    return color


def color_dir(dataset: str, gt_dir: str, out_dir: str) -> int:
    """Colour every .png of `gt_dir` into `out_dir`; returns the count."""
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for f in sorted(os.listdir(gt_dir)):
        if not f.endswith(".png"):
            continue
        gt = imread(osp.join(gt_dir, f), "unchanged")
        if gt.ndim == 3:
            gt = gt[:, :, 0]
        imwrite(osp.join(out_dir, f), colorize(gt, PALETTES[dataset]))
        n += 1
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description="colour label PNGs")
    p.add_argument("dataset", choices=sorted(PALETTES))
    p.add_argument("gt_dir")
    p.add_argument("out_dir")
    args = p.parse_args(argv)
    n = color_dir(args.dataset, args.gt_dir, args.out_dir)
    print("done")
    return n


if __name__ == "__main__":
    main()
