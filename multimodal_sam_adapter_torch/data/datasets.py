"""Dataset classes: DELIVER (+easy/hard), FMB (val/easy/hard), MUSES.

Re-design of reference mmseg_custom/datasets/: file discovery by suffix
pairing (img file -> per-modality file via suffix replacement), easy/hard
split files, MUSES case/condition directory scheme, class names + palettes,
and the per-image `pre_eval` -> intersect/union contract the evaluator
consumes.

The port's own copy of multimodal_sam_adapter_tpu/data/datasets.py. Images
are read by data/image_io.py when a sample is loaded; MUSES's
`format_results` writes the benchmark server's PNGs with its `imwrite`.
"""
from __future__ import annotations

import os
import os.path as osp
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

from .image_io import imwrite
from .pipelines import load_annotation, load_multimodal_image

# ---------------------------------------------------------------------------
# class tables (reference datasets/DELIVER.py:28-57, FMB_val.py:57, MUSES.py:32)
# ---------------------------------------------------------------------------

DELIVER_CLASSES = (
    "Building", "Fence", "Other", "Pedestrian", "Pole", "RoadLine", "Road",
    "SideWalk", "Vegetation", "Cars", "Wall", "TrafficSign", "Sky", "Ground",
    "Bridge", "RailTrack", "GroundRail", "TrafficLight", "Static", "Dynamic",
    "Water", "Terrain", "TwoWheeler", "Bus", "Truck",
)
DELIVER_PALETTE = [
    [70, 70, 70], [100, 40, 40], [55, 90, 80], [220, 20, 60], [153, 153, 153],
    [157, 234, 50], [128, 64, 128], [244, 35, 232], [107, 142, 35],
    [0, 0, 142], [102, 102, 156], [220, 220, 0], [70, 130, 180],
    [81, 0, 81], [150, 100, 100], [230, 150, 140], [180, 165, 180],
    [250, 170, 30], [110, 190, 160], [170, 120, 50], [45, 60, 150],
    [145, 170, 100], [0, 0, 230], [0, 60, 100], [0, 0, 70],
]

FMB_CLASSES = (
    "Road", "Sidewalk", "Building", "Lamp", "Sign", "Vegetation", "Sky",
    "Person", "Car", "Truck", "Bus", "Motorcycle", "Bicycle", "Pole",
)
FMB_PALETTE = [
    [179, 228, 228], [181, 57, 133], [67, 162, 177], [200, 178, 50],
    [132, 45, 199], [66, 172, 84], [179, 73, 79], [76, 99, 166],
    [66, 121, 253], [137, 6, 75], [91, 131, 237], [255, 160, 1],
    [206, 190, 59], [147, 142, 162],
]

CITYSCAPES_CLASSES = (
    "road", "sidewalk", "building", "wall", "fence", "pole", "traffic light",
    "traffic sign", "vegetation", "terrain", "sky", "person", "rider", "car",
    "truck", "bus", "train", "motorcycle", "bicycle",
)
CITYSCAPES_PALETTE = [
    [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
    [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
    [107, 142, 35], [152, 251, 152], [70, 130, 180], [220, 20, 60],
    [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100], [0, 80, 100],
    [0, 0, 230], [119, 11, 32],
]

# DELIVER eval breakdown (reference apis/test_bs.py:158-165)
DELIVER_CONDITIONS = ("cloud", "fog", "night", "rain", "sun")
DELIVER_CASES = ("motionblur", "overexposure", "underexposure", "lidarjitter",
                 "eventlowres")


class SegDataset:
    """Base multimodal segmentation dataset.

    Samples are dicts with 'img' (HWC float32, BGR-loaded + aux channels),
    'gt' (HW uint8 or None) and 'meta' (filenames, shapes, condition/case).
    """

    CLASSES: Sequence[str] = ()
    PALETTE: Optional[list] = None

    def __init__(
        self,
        data_root: str,
        img_dir: str,
        ann_dir: Optional[str],
        mod_dir: str,
        img_suffix: str,
        seg_map_suffix: str,
        mod_suffix: str,
        modalities_ch=(3, 3),
        split_file: Optional[str] = None,
        reduce_zero_label: bool = False,
        test_mode: bool = False,
    ):
        self.data_root = data_root
        self.img_dir = osp.join(data_root, img_dir)
        self.ann_dir = osp.join(data_root, ann_dir) if ann_dir else None
        # mod_dir/mod_suffix accept a str (one aux modality) or aligned
        # LISTS (reference mod_dir/mod_suffix are lists, e.g.
        # configs/_base_/datasets/muses.py:30-31 carries event + lidar)
        mod_dirs = [mod_dir] if isinstance(mod_dir, str) else list(mod_dir)
        mod_sufs = ([mod_suffix] if isinstance(mod_suffix, str)
                    else list(mod_suffix))
        assert len(mod_dirs) == len(mod_sufs), "mod_dir/mod_suffix mismatch"
        assert len(mod_dirs) == len(modalities_ch) - 1, (
            "one aux dir/suffix per non-RGB modality")
        self.mod_dirs = [osp.join(data_root, d) for d in mod_dirs]
        self.mod_suffixes = mod_sufs
        # single-aux convenience aliases (most configs)
        self.mod_dir = self.mod_dirs[0]
        self.mod_suffix = self.mod_suffixes[0]
        self.img_suffix = img_suffix
        self.seg_map_suffix = seg_map_suffix
        self.modalities_ch = tuple(modalities_ch)
        self.reduce_zero_label = reduce_zero_label
        self.test_mode = test_mode
        self.infos = self._load_infos(split_file)

    # -- file discovery: pair img files with modality/ann files by suffix
    def _load_infos(self, split_file: Optional[str]) -> List[Dict]:
        infos = []
        if split_file:
            with open(osp.join(self.data_root, split_file)) as f:
                names = [l.strip() for l in f if l.strip()]
            stems = [n[: -len(self.img_suffix)] if n.endswith(self.img_suffix)
                     else n for n in names]
        else:
            stems = sorted(
                fn[: -len(self.img_suffix)]
                for fn in _scan(self.img_dir)
                if fn.endswith(self.img_suffix)
            )
        for stem in stems:
            infos.append(dict(
                stem=stem,
                img=osp.join(self.img_dir, stem + self.img_suffix),
                mod=[osp.join(d, stem + s)
                     for d, s in zip(self.mod_dirs, self.mod_suffixes)],
                ann=(osp.join(self.ann_dir, stem + self.seg_map_suffix)
                     if self.ann_dir else None),
            ))
        return infos

    def __len__(self):
        return len(self.infos)

    def __getitem__(self, idx: int) -> Dict:
        info = self.infos[idx]
        mods = info["mod"] if isinstance(info["mod"], list) else [info["mod"]]
        img = load_multimodal_image(info["img"], mods,
                                    self.modalities_ch[1:])
        gt = None
        if info["ann"] and (not self.test_mode or osp.exists(info["ann"])):
            gt = load_annotation(info["ann"], self.reduce_zero_label)
        return {
            "img": img,
            "gt": gt,
            "meta": {
                "filename": osp.basename(info["img"]),
                "stem": info["stem"],
                "ori_shape": img.shape,
                "condition": self.condition_of(info["stem"]),
                "case": self.case_of(info["stem"]),
            },
        }

    def get_gt(self, idx: int) -> np.ndarray:
        info = self.infos[idx]
        return load_annotation(info["ann"], self.reduce_zero_label)

    # condition/case routing (overridden by DELIVER / MUSES)
    def condition_of(self, stem: str) -> Optional[str]:
        return None

    def case_of(self, stem: str) -> Optional[str]:
        return None


def _scan(d: str) -> List[str]:
    out = []
    for root, _, files in os.walk(d):
        rel = osp.relpath(root, d)
        for f in files:
            out.append(f if rel == "." else osp.join(rel, f))
    return out


class DELIVER(SegDataset):
    """DELIVER: 25 classes; condition x case from the filename
    (converted layout: <case>_<condition>_..., reference test_bs.py:158-165,
    tools/convert_DELIVER_to_mmseg.py)."""

    CLASSES = DELIVER_CLASSES
    PALETTE = DELIVER_PALETTE
    CONDITIONS = DELIVER_CONDITIONS
    CASES = DELIVER_CASES

    def condition_of(self, stem):
        for c in self.CONDITIONS:
            if c in stem:
                return c
        return None

    def case_of(self, stem):
        for c in self.CASES:
            if c in stem:
                return c
        return "ordinary"


class DELIVER_easy(DELIVER):
    """Split-file-driven subset (test_easy.txt at the dataset root)."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("split_file", "test_easy.txt")
        super().__init__(*args, **kwargs)


class DELIVER_hard(DELIVER):
    def __init__(self, *args, **kwargs):
        kwargs.setdefault("split_file", "test_hard.txt")
        super().__init__(*args, **kwargs)


class FMB(SegDataset):
    """FMB: 14 classes, RGB + thermal, reduce_zero_label GT."""

    CLASSES = FMB_CLASSES
    PALETTE = FMB_PALETTE

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("reduce_zero_label", True)
        super().__init__(*args, **kwargs)


class FMB_easy(FMB):
    def __init__(self, *args, **kwargs):
        kwargs.setdefault("split_file", "test_easy.txt")
        super().__init__(*args, **kwargs)


class FMB_hard(FMB):
    def __init__(self, *args, **kwargs):
        kwargs.setdefault("split_file", "test_hard.txt")
        super().__init__(*args, **kwargs)


class MUSES(SegDataset):
    """MUSES: 19 Cityscapes classes; files live under
    <case>/<condition>/ subdirectories (cases clear/rain/fog/snow x
    conditions day/night); aux modality from .npz.

    Discovery mirrors reference MUSES.py:170-185: files are enumerated per
    case x condition directory and the pair is ENCODED into the stem as
    'case_condition_<name>'; loading decodes the first two '_'-separated
    path components back into the directory tree (loading.py:84-109)."""

    CLASSES = CITYSCAPES_CLASSES
    PALETTE = CITYSCAPES_PALETTE
    CASES = ("clear", "rain", "fog", "snow")
    CONDITIONS = ("day", "night")

    def _load_infos(self, split_file):
        if split_file:
            # split files carry plain names (reference MUSES.py:159-169);
            # the base suffix-pairing discovery applies
            return super()._load_infos(split_file)
        infos = []
        for case in self.CASES:
            for cond in self.CONDITIONS:
                d = osp.join(self.img_dir, case, cond)
                if not osp.isdir(d):
                    continue
                for fn in _scan(d):
                    if not fn.endswith(self.img_suffix):
                        continue
                    base = fn[: -len(self.img_suffix)]
                    infos.append(dict(
                        stem=f"{case}_{cond}_{base}",
                        img=osp.join(d, fn),
                        mod=[osp.join(md, case, cond, base + ms)
                             for md, ms in zip(self.mod_dirs,
                                               self.mod_suffixes)],
                        ann=(osp.join(self.ann_dir, case, cond,
                                      base + self.seg_map_suffix)
                             if self.ann_dir else None),
                    ))
        infos.sort(key=lambda x: x["stem"])
        return infos

    # routing decodes the encoded path components (NOT substring matching):
    # stem = '<case>_<condition>_<name>'. Split the FULL stem — a '<name>'
    # carrying sub-directories ('rain_day_seq1/frame7') would lose its
    # leading case/condition under osp.basename.
    def case_of(self, stem):
        p = stem.split("_")
        return p[0] if p and p[0] in self.CASES else None

    def condition_of(self, stem):
        p = stem.split("_")
        return p[1] if len(p) > 1 and p[1] in self.CONDITIONS else None

    def format_results(self, preds, stems, out_dir: str) -> List[str]:
        """Write uint8 labelTrainIds PNGs with the benchmark server's names
        (reference MUSES.py:127-138: drop '_frame_camera', strip everything
        before the trailing 'R<...>' record id); returns the paths."""
        os.makedirs(osp.join(out_dir, "labelTrainIds"), exist_ok=True)
        files = []
        for pred, stem in zip(preds, stems):
            name = osp.basename(stem).replace("/", "_") + ".png"
            name = name.replace("_frame_camera", "")
            name = re.sub(r".*_R", "R", name)
            fn = osp.join(out_dir, "labelTrainIds", name)
            imwrite(fn, np.asarray(pred).astype(np.uint8))
            files.append(fn)
        return files


_DATASETS = {
    "DELIVER": DELIVER,
    "DELIVER_easy": DELIVER_easy,
    "DELIVER_hard": DELIVER_hard,
    "FMB_val": FMB,
    "FMB_easy": FMB_easy,
    "FMB_hard": FMB_hard,
    "MUSES": MUSES,
}


def build_dataset(cfg: dict, data_root: str, test_mode: bool = False,
                  split: str = None):
    """Build a dataset; '{split}' in dir templates is resolved via
    cfg['split_names'] (reference configs use per-split directory trees)."""
    cls = _DATASETS[cfg["type"]]
    if split is None:
        split = "test" if test_mode else "train"
    name = cfg.get("split_names", {}).get(split, split)

    def sub(d):
        # mod_dir/mod_suffix may be aligned LISTS (multi-aux configs, like
        # the reference's configs/_base_/datasets/muses.py:30-31)
        if isinstance(d, (list, tuple)):
            return [sub(x) for x in d]
        return d.format(split=name) if d else d

    return cls(
        data_root=data_root,
        img_dir=sub(cfg["img_dir"]),
        ann_dir=sub(cfg.get("ann_dir")),
        mod_dir=sub(cfg["mod_dir"]),
        img_suffix=cfg["img_suffix"],
        seg_map_suffix=cfg["seg_map_suffix"],
        mod_suffix=cfg["mod_suffix"],
        modalities_ch=cfg.get("modalities_ch", (3, 3)),
        reduce_zero_label=cfg.get("reduce_zero_label", False),
        test_mode=test_mode,
    )
