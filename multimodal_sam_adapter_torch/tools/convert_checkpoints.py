"""Convert a reference .pth into the port's checkpoint file (the
counterpart of the root `tools/convert_checkpoints.py`, same CLI):

    python -m multimodal_sam_adapter_torch.tools.convert_checkpoints \
        sam|convnext|full <pth> <out> [--config deliver_rgblidar]

The root tool writes an orbax tree for the JAX package. The port reads
`.pth` files as they are, so this writes the port's own checkpoint, the
file `engine/checkpoint.py:restore_checkpoint` and `tools/test.py` read
({"meta", "state_dict", "optimizer"}, the optimizer's state empty):

- `sam`: a SAM checkpoint's image encoder, the keys of
  `models/sam_vit.py:ImageEncoderViT` (`ingest_sam_pth(standalone=True)`);
- `convnext`: an ImageNet ConvNeXt in both twin branches of the spatial
  prior (`ingest_convnext_pth`, the segmentor's `backbone.spm.twin_conv.*`
  keys);
- `full`: a trained segmentor's state dict, loaded strictly into the
  config's segmentor and written as its state_dict.

`<pth>` may be a path or an http(s):// / file:// URL
(`resolve_checkpoint_source`). Prints the number of values written.
"""
from __future__ import annotations

import argparse
import os


def convert(kind: str, pth: str, config: str = "deliver_rgblidar"):
    """The state_dict of `kind` from the reference file `pth`."""
    from ..configs.registry import get_config
    from ..engine.checkpoint import (ingest_convnext_pth, ingest_sam_pth,
                                     load_state_dict_file)
    from ..models.segmentor import build_segmentor

    if kind == "sam":
        return ingest_sam_pth(pth, standalone=True)
    if kind == "convnext":
        return ingest_convnext_pth(pth)
    if kind == "full":
        model = build_segmentor(get_config(config)["model"], "cpu",
                                state_dict=load_state_dict_file(pth))
        return {k: v.detach() for k, v in model.state_dict().items()}
    raise ValueError(f"unknown kind {kind!r}")


def main(argv=None):
    p = argparse.ArgumentParser(description=".pth -> the port's checkpoint")
    p.add_argument("kind", choices=["sam", "convnext", "full"])
    p.add_argument("pth")
    p.add_argument("out")
    p.add_argument("--config", default="deliver_rgblidar")
    args = p.parse_args(argv)
    import torch

    sd = convert(args.kind, args.pth, args.config)
    payload = {"meta": {"kind": args.kind, "source": args.pth,
                        "config": args.config},
               "state_dict": sd, "optimizer": {}}
    tmp = f"{args.out}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, args.out)
    n = sum(v.numel() for v in sd.values())
    print(f"wrote {args.out} ({n / 1e6:.1f}M values)")
    return args.out


if __name__ == "__main__":
    main()
