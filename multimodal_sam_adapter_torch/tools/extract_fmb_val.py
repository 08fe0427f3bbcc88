"""Sort FMB images into easy/hard subfolders from the provided file lists
(the port's copy of the root `tools/extract_fmb_val.py`, the same CLI,
moves, copies and dry-run output):

    python -m multimodal_sam_adapter_torch.tools.extract_fmb_val <FMB-root>
        [--divisions train val test] [--modality-dirs Visible Infrared]
        [--copy] [--dry-run]

For each division, creates <division>/<modality>/{easy,hard} and moves
(`--copy`: copies) the files listed in <division>_easy_files.txt /
<division>_hard_files.txt into them; `--dry-run` prints the plan and
touches nothing. The reference's quirk is kept: the val lists name files
that live under train/<modality>. (The root tool finds that directory by
replacing every "val" in the path, so a root whose path holds "val"
elsewhere misleads it; this copy joins <root>/train/<modality>.)
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import shutil


def extract(base_dir: str, divisions, modality_dirs, copy=False,
            dry_run=False):
    """Returns (files moved or copied, files listed but missing)."""
    n_moved = n_missing = 0
    for division in divisions:
        for mod_dir in modality_dirs:
            visible_dir = osp.join(base_dir, division, mod_dir)
            for folder in ("easy", "hard"):
                if not dry_run:
                    os.makedirs(osp.join(visible_dir, folder), exist_ok=True)
            for txt_file, target in (
                (f"{division}_easy_files.txt", "easy"),
                (f"{division}_hard_files.txt", "hard"),
            ):
                txt_path = osp.join(base_dir, txt_file)
                if not osp.exists(txt_path):
                    print(f"note: {txt_path} not found, skipping")
                    continue
                with open(txt_path) as f:
                    for line in f:
                        filename = line.strip()
                        if not filename:
                            continue
                        # the val lists name files stored under train/
                        src_dir = (osp.join(base_dir, "train", mod_dir)
                                   if division == "val" else visible_dir)
                        src = osp.join(src_dir, filename)
                        dst = osp.join(visible_dir, target, filename)
                        if not osp.exists(src):
                            print(f"Warning: {src} does not exist.")
                            n_missing += 1
                            continue
                        if dry_run:
                            print(f"{'copy' if copy else 'move'} {src} "
                                  f"-> {dst}")
                        elif copy:
                            shutil.copy2(src, dst)
                        else:
                            shutil.move(src, dst)
                        n_moved += 1
    print(f"done: {n_moved} files {'copied' if copy else 'moved'}, "
          f"{n_missing} missing")
    return n_moved, n_missing


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("base_dir", help="FMB dataset root")
    p.add_argument("--divisions", nargs="+",
                   default=["train", "val", "test"])
    p.add_argument("--modality-dirs", nargs="+", default=["Visible"])
    p.add_argument("--copy", action="store_true")
    p.add_argument("--dry-run", action="store_true")
    a = p.parse_args(argv)
    return extract(a.base_dir, a.divisions, a.modality_dirs, a.copy,
                   a.dry_run)


if __name__ == "__main__":
    main()
