"""Reorganise a raw DeLiVER download into the flat training layout (the
counterpart of the root `tools/convert_deliver.py`, the same layout and
names, with PNGs read and written by the port's `data/image_io.py`):

    python -m multimodal_sam_adapter_torch.tools.convert_deliver \
        RAW_DELIVER_DIR OUT_DIR

Files are copied into samples/{images,annotations,depth,lidar,event}/
{training,validation,test} with '<case>_<condition>_<name>' flat names;
semantic labels are read unchanged (channel 0 of a 3-channel file, as
OpenCV's IMREAD_UNCHANGED gives it), remapped 255 -> 0, shifted by -1 and
the negatives set to 255 (class ids 0..24, 255 ignored).
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import shutil

import numpy as np

from ..data.image_io import imread, imwrite

SPLIT_MAP = {"train": "training", "val": "validation", "test": "test"}
MODS = {
    "img": ("images", False),
    "semantic": ("annotations", True),
    "depth": ("depth", False),
    "lidar": ("lidar", False),
    "event": ("event", False),
}


def convert_label(src: str, dst: str) -> None:
    lab = imread(src, "unchanged")
    if lab.ndim == 3:
        lab = lab[:, :, 0]
    lab = lab.astype(np.int32)
    lab[lab == 255] = 0
    lab = lab - 1
    lab[lab < 0] = 255
    imwrite(dst, lab.astype(np.uint8))


def convert(src: str, dst: str) -> int:
    """Convert the raw tree `src` into `dst`; returns the files written."""
    n = 0
    for mod, (out_name, is_label) in MODS.items():
        mod_root = osp.join(src, mod)
        if not osp.isdir(mod_root):
            print(f"skip {mod}: not found")
            continue
        for case in sorted(os.listdir(mod_root)):
            case_dir = osp.join(mod_root, case)
            if not osp.isdir(case_dir):
                continue
            for split, out_split in SPLIT_MAP.items():
                split_dir = osp.join(case_dir, split)
                if not osp.isdir(split_dir):
                    continue
                out_dir = osp.join(dst, "samples", out_name, out_split)
                os.makedirs(out_dir, exist_ok=True)
                for root, _, files in os.walk(split_dir):
                    cond = osp.relpath(root, split_dir).split(osp.sep)[0]
                    for f in files:
                        if not f.lower().endswith(".png"):
                            continue
                        out = osp.join(out_dir, f"{case}_{cond}_{f}")
                        src_f = osp.join(root, f)
                        if is_label:
                            convert_label(src_f, out)
                        else:
                            shutil.copyfile(src_f, out)
                        n += 1
        print(f"converted modality {mod}")
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description="DeLiVER raw -> flat layout")
    p.add_argument("src")
    p.add_argument("dst")
    args = p.parse_args(argv)
    return convert(args.src, args.dst)


if __name__ == "__main__":
    main()
