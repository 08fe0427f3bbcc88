"""Inference-only run of the PyTorch port: write predictions, no metrics
(the counterpart of the root `infer_test.py`, and of the reference's
segmentation/infer_test.py): `tools/test.py` with `--format-only`.

    python -m multimodal_sam_adapter_torch.tools.infer_test <config>
        <checkpoint> --data-root DIR [--show-dir DIR] [tools/test.py's
        other arguments]

MUSES writes its benchmark-server submission, DIR/labelTrainIds/R....png
(into --show-dir, else ./results); --show-dir also writes the palette
blends. Runs on `--device`, `cuda` by default.
"""
from __future__ import annotations

import sys

from . import test as test_entry


def main(argv=None):
    """tools/test.py's `main` on `argv` (default: the command line) with
    --format-only appended when it is missing."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--format-only" not in argv:
        argv.append("--format-only")
    return test_entry.main(argv)


if __name__ == "__main__":
    main()
