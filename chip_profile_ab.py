"""Where the served forward's device time goes, for two or more checkouts
on one card in one run: for each checkout, in the order given, the
full-width deliver_rgblidar forward (weights from seed 0, B=1, 1024^2,
`InferenceEngine.logits`) in float32 (TF32 off for cuBLAS and cuDNN) or
bf16, profiled through the kernels and through the plain versions by that
checkout's own `utils/profiling.py:profile_calls` (3 calls, 5 unprofiled
repeats), in a process of its own that imports that checkout's package
and builds its kernels:

    python3 chip_profile_ab.py [--dtype f32|bf16] <checkout> [<checkout> ...]

One JSON line a checkout and path (busy ms, unprofiled ms, idle share,
launches, device ms by op family), under a `== <checkout>` line; the
traces go to each checkout's build/profiles/. Run A, B, B, A to see how
far the card drifts within the run.
"""
import subprocess
import sys
from pathlib import Path

PROFILE = """
import contextlib, json, os, sys
root, tag = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
os.chdir(root)
import torch
from multimodal_sam_adapter_torch.configs.registry import get_config
from multimodal_sam_adapter_torch.engine.inference import InferenceEngine
from multimodal_sam_adapter_torch.models.segmentor import build_segmentor
from multimodal_sam_adapter_torch.ops import kernels
from multimodal_sam_adapter_torch.utils.profiling import profile_calls
from pathlib import Path
dtype = torch.float32 if tag == "f32" else torch.bfloat16
if dtype == torch.float32:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
cfg = get_config("deliver_rgblidar")
g = torch.Generator(device="cuda").manual_seed(0)
model = build_segmentor(cfg["model"], "cuda", generator=g)
engine = InferenceEngine(model.to(dtype), cfg["test_cfg"])
img = torch.randn((1, 1024, 1024, 6), generator=g, device="cuda").to(dtype)
for path in ("kernel", "plain"):
    ctx = (kernels.plain_kernels() if path == "plain"
           else contextlib.nullcontext())
    with ctx:
        for _ in range(2):
            engine.logits(img)
        res = profile_calls(lambda: engine.logits(img), 3,
                            Path("build/profiles") / f"ab_{path}_{tag}.json",
                            5)
    print(json.dumps(dict(checkout=root, path=path, dtype=tag,
                          device=torch.cuda.get_device_name(0), **res)),
          flush=True)
"""


def main(argv):
    tag = "bf16"
    if argv[:1] == ["--dtype"]:
        tag, argv = argv[1], argv[2:]
    if not argv or tag not in ("f32", "bf16"):
        raise SystemExit(__doc__)
    for root in argv:
        root = Path(root).resolve()
        print(f"== {root}", flush=True)
        proc = subprocess.run([sys.executable, "-c", PROFILE, str(root), tag],
                              check=False)
        if proc.returncode != 0:
            raise SystemExit(f"{root}: exit {proc.returncode}")


if __name__ == "__main__":
    main(sys.argv[1:])
