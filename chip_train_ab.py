"""The train phase of `chip_smoke.py` alone, for two or more checkouts on
one card in one run: for each checkout, in the order given, that
checkout's own `chip_smoke.py` phases 1 (device), 2 (build) and 9 (train:
the full-width deliver_rgblidar micro-step, kernel vs plain, two bf16
updates, one profiled micro-step with its device busy ms, idle share and
launch count), in a process of its own that imports that checkout's
package and builds its kernels:

    python3 chip_train_ab.py <checkout> [<checkout> ...]

Run A, B, B, A to see how far the card and the host drift within the run.
Each checkout's lines are printed as its `chip_smoke.py` prints them,
under a `== <checkout>` line; the run fails if one of them fails.
"""
import subprocess
import sys
from pathlib import Path

TRAIN_PHASE = """
import os, sys
root = sys.argv[1]
sys.path.insert(0, root)
os.chdir(root)
import torch
import chip_smoke as cs
from multimodal_sam_adapter_torch.ops import kernels
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
kind, smi = cs.phase_device(torch)
cs.phase_build(kernels)
cs.phase_train(torch, kernels, smi,
               torch.Generator(device="cuda").manual_seed(cs.SEED))
"""


def main(roots):
    if not roots:
        raise SystemExit(__doc__)
    for root in roots:
        root = Path(root).resolve()
        print(f"== {root}", flush=True)
        proc = subprocess.run([sys.executable, "-c", TRAIN_PHASE, str(root)],
                              check=False)
        if proc.returncode != 0:
            raise SystemExit(f"{root}: exit {proc.returncode}")


if __name__ == "__main__":
    main(sys.argv[1:])
