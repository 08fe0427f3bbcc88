"""What nvcc made of the port's CUDA kernels, on the card's machine.

Builds `multimodal_sam_adapter_torch/csrc/` (or a copy, `--csrc`) into a
fresh directory under `build/sass/` with ptxas's report on (`-Xptxas=-v`),
then reads `cuobjdump -sass` of the library, and prints one JSON line per
kernel entry whose name matches `--match`: its registers, stack frame and
spill bytes from ptxas, and its count of HGMMA (wgmma) instructions in the
SASS. Run on the machine with the toolkit:

    python3 kernel_sass.py --match rel_pos_attention
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def demangle(names):
    """C++ names of mangled `names`, by c++filt where it exists."""
    tool = shutil.which("c++filt")
    if tool is None or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), text=True,
                         capture_output=True).stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else {
        n: n for n in names}


def ptxas_report(log: str):
    """{mangled entry: {registers, stack, spill_stores, spill_loads}} from
    ptxas -v output."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def hgmma_counts(lib: Path):
    """{mangled function: HGMMA instructions} from cuobjdump -sass."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], text=True,
                          capture_output=True, check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = 0
        elif name and "HGMMA" in line:
            out[name] += 1
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", type=Path, help="a copy of csrc/ to build")
    ap.add_argument("--match", default="",
                    help="only kernels whose C++ name contains this")
    args = ap.parse_args(argv)
    from multimodal_sam_adapter_torch.ops import kernels

    if args.csrc is not None:
        kernels.CSRC = args.csrc.resolve()
    kernels.BUILD_ROOT = ROOT / "build" / "sass" / str(os.getpid())
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        lib = kernels.build(verbose=True)
    report = ptxas_report(log.getvalue())
    hgmma = hgmma_counts(lib)
    names = sorted(set(report) | set(hgmma))
    readable = demangle(names)
    for n in names:
        if args.match not in readable[n]:
            continue
        print(json.dumps(dict(kernel=readable[n], hgmma=hgmma.get(n),
                              **report.get(n, {}))), flush=True)


if __name__ == "__main__":
    main()
