"""Write a learnable fake-DeLiVER dataset (the counterpart of the root
`tools/make_synth_deliver.py`: the same layout, names and numpy draws, so
the arrays are bit-equal to the root tool's; the PNGs are written by the
port's `data/image_io.py`, so their bytes may differ from OpenCV's, and
their decoded pixels do not):

    python -m multimodal_sam_adapter_torch.tools.make_synth_deliver \
        <out_root> [n_per_cell] [seed]

Each class k paints its rectangles with its own colour in both the RGB
image and the LiDAR-slot image (channels reversed), plus noise, so a model
trained on the training split generalises to validation and test: a real
(non-random) mIoU through `tools/train.py` and `tools/test.py`. Layout:
samples/{images,annotations,lidar}/{training,validation,test}/
<case><cond>_<split>_<i>_{rgb,lidar,semantic}_front.png, with the
conditions sun / rain and the cases none / motionblur (n_per_cell samples
of each, 4 by default).
"""
from __future__ import annotations

import os
import sys

import numpy as np

from ..data.image_io import imwrite

K = 6  # classes actually present (ids 0..K-1 of deliver_tiny's 25)
SIZE = 80
COLORS = np.array(
    [[200, 40, 40], [40, 200, 40], [40, 40, 200], [200, 200, 40],
     [40, 200, 200], [160, 80, 200]], np.int32)
CONDS = ("sun", "rain")
CASES = ("", "motionblur_")
SPLITS = ("training", "validation", "test")


def make_pair(rng: np.random.Generator):
    """(BGR image, LiDAR-slot image, label), uint8, from `rng`'s draws in
    the root tool's order."""
    ann = np.zeros((SIZE, SIZE), np.uint8)
    # random rectangles of random classes over a class-0 background
    for _ in range(6):
        k = int(rng.integers(1, K))
        x, y = rng.integers(0, SIZE - 8, 2)
        w, h = rng.integers(8, 40, 2)
        ann[y:y + h, x:x + w] = k
    img = COLORS[ann] + rng.normal(0, 18, (SIZE, SIZE, 3))
    aux = COLORS[ann][..., ::-1] + rng.normal(0, 18, (SIZE, SIZE, 3))
    return (np.clip(img, 0, 255).astype(np.uint8),
            np.clip(aux, 0, 255).astype(np.uint8), ann)


def write(root: str, n: int = 4, seed: int = 0) -> int:
    """Write the tree under `root`; returns the number of samples."""
    rng = np.random.default_rng(seed)
    for split in SPLITS:
        for d in ("images", "annotations", "lidar"):
            os.makedirs(os.path.join(root, "samples", d, split),
                        exist_ok=True)
        for cond in CONDS:
            for case in CASES:
                for i in range(n):
                    stem = f"{case}{cond}_{split}_{i}"
                    img, aux, ann = make_pair(rng)
                    imwrite(os.path.join(root, "samples/images", split,
                                         f"{stem}_rgb_front.png"), img)
                    imwrite(os.path.join(root, "samples/lidar", split,
                                         f"{stem}_lidar_front.png"), aux)
                    imwrite(os.path.join(root, "samples/annotations", split,
                                         f"{stem}_semantic_front.png"), ann)
    return len(SPLITS) * len(CONDS) * len(CASES) * n


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    root = argv[0]
    n = int(argv[1]) if len(argv) > 1 else 4
    seed = int(argv[2]) if len(argv) > 2 else 0
    print(f"wrote {root}: {write(root, n, seed)} samples")


if __name__ == "__main__":
    main()
