"""Parameters, operations and bytes of one forward (the counterpart of the
root `tools/get_flops.py`, same arguments, plus `--device`):

    python -m multimodal_sam_adapter_torch.tools.get_flops <config>
        [--shape H W] [--tiny] [--device meta|cpu|cuda]

Builds the config's segmentor (the root tool builds deliver_rgblidar's
whatever config it is given; the two agree there) in bfloat16, with
`--tiny` at test scale (deliver_tiny's backbone and head width, the
root tool's `tiny=True`), and counts one eval forward of a
(1, H, W, channels) input with `utils/flops.py:WorkCounter`. Prints

    params: <M> M
    flops (fwd, batch 1, HxW): <G> GFLOPs
    hbm bytes accessed: <G> GB
    split: <JSON of the GFLOPs by kind, and each kernel's calls and work>

The root tool reads XLA's cost analysis of the compiled program, which
also counts elementwise work (adds, norms, activations, softmax) and the
JAX plain paths' own formulation; this count has the products outside
the kernels, the interpolations, and K1-K6's formulas (`work`), so it is
the lower of the two. The bytes line is a floor (each op's inputs read
once and its output written once, each kernel's `work` bytes), not XLA's
"bytes accessed" of the fused program's buffers.

`--device meta` (the default) counts from shapes alone, with no weights
and no compute; `cpu` runs the plain path, `cuda` the kernel path on the
card, both on weights from a seeded generator, and give the same
operation counts.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="FLOPs / params counter "
                                            "(PyTorch)")
    p.add_argument("config")
    p.add_argument("--shape", nargs=2, type=int, default=[1024, 1024])
    p.add_argument("--tiny", action="store_true",
                   help="deliver_tiny's backbone and head width")
    p.add_argument("--device", default="meta",
                   help="meta: shapes only; cpu: the plain path; cuda: the "
                        "kernel path on the card")
    return p.parse_args(argv)


def model_config(config: str, tiny: bool = False) -> Dict:
    """The config's `model`; with `tiny`, deliver_tiny's backbone (the
    config's modalities kept) and head width."""
    from ..configs.registry import get_config

    m = get_config(config)["model"]
    if tiny:
        t = get_config("deliver_tiny")["model"]
        m["backbone"] = dict(t["backbone"],
                             modalities_ch=m["backbone"]["modalities_ch"])
        m["head_channels"] = t["head_channels"]
    return m


def count(model_cfg: Dict, hw, device="meta"):
    """(number of parameters, the WorkCounter of one bf16 eval forward of a
    (1, H, W, channels) input) of the segmentor `model_cfg` on `device`."""
    import torch

    from ..models.segmentor import build_segmentor
    from ..utils.flops import WorkCounter

    device = torch.device(device)
    # a meta model's init draws nothing
    gen = torch.Generator(device="cpu" if device.type == "meta" else device)
    model = build_segmentor(model_cfg, device, generator=gen.manual_seed(0))
    model = model.to(torch.bfloat16)
    n_params = sum(p.numel() for p in model.parameters())
    channels = sum(model_cfg["backbone"]["modalities_ch"])
    x = torch.zeros((1, *hw, channels), dtype=torch.bfloat16, device=device)
    with torch.no_grad(), WorkCounter() as wc:
        model(x)
    return n_params, wc


def main(argv=None):
    args = parse_args(argv)
    from .train import entry_device

    device = (args.device if args.device == "meta"
              else entry_device(args.device))
    hw = tuple(args.shape)
    n_params, wc = count(model_config(args.config, args.tiny), hw, device)
    t = wc.totals()
    h, w = hw
    print(f"params: {n_params / 1e6:.2f} M")
    print(f"flops (fwd, batch 1, {h}x{w}): {t['flops'] / 1e9:.2f} GFLOPs")
    print(f"hbm bytes accessed: {t['bytes'] / 1e9:.2f} GB")
    split = {k: t[k] / 1e9 for k in ("products", "interpolations",
                                     "tensor_ops", "other_ops")}
    print("split: " + json.dumps(dict(gflops=split, kernels=wc.kernels)),
          flush=True)
    return n_params, wc


if __name__ == "__main__":
    main()
