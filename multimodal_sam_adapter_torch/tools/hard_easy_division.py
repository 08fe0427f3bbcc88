"""Write DeLiVER's test_easy.txt / test_hard.txt split files (the port's
copy of the root `tools/hard_easy_division.py`, the same CLI and files):

    python -m multimodal_sam_adapter_torch.tools.hard_easy_division \
        DATA_ROOT [--img-dir samples/images/test] [--hard-token underexposure]

'hard' are the files whose name holds the token, 'easy' all the others.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp


def divide(data_root: str, img_dir: str = "samples/images/test",
           hard_token: str = "underexposure"):
    """Write the two lists under `data_root`; returns (hard, easy)."""
    src = osp.join(data_root, img_dir)
    names = sorted(f for f in os.listdir(src) if f.endswith(".png"))
    hard = [n for n in names if hard_token in n]
    easy = [n for n in names if hard_token not in n]
    for split, items in (("test_hard.txt", hard), ("test_easy.txt", easy)):
        with open(osp.join(data_root, split), "w") as f:
            f.write("\n".join(items) + "\n")
        print(f"{split}: {len(items)} files")
    return hard, easy


def main(argv=None):
    p = argparse.ArgumentParser(description="DeLiVER easy / hard lists")
    p.add_argument("data_root")
    p.add_argument("--img-dir", default="samples/images/test")
    p.add_argument("--hard-token", default="underexposure")
    args = p.parse_args(argv)
    return divide(args.data_root, args.img_dir, args.hard_token)


if __name__ == "__main__":
    main()
