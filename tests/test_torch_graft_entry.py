"""The port's entry points (multimodal_sam_adapter_torch/
graft_entry.py) against __graft_entry__.py's:

- the two geometries of `_flagship_model`: the flagship's model config
  and the tiny backbone dict the port keeps its own copy of;
- `entry()` on the `meta` device: the bf16 flagship eval forward's
  output shape on a 1x1024x1024x6 input, from shapes alone;
- `dryrun_multichip(4, device="cpu")`: four gloo ranks on a (data 2,
  model 2) mesh take one train step of the tiny model and print JAX's
  line with a finite loss; on `cuda` with too few cards it raises before
  it starts a rank, and it never moves to the CPU on its own.
"""
import math
import re

import pytest
import torch

import __graft_entry__ as jentry
from multimodal_sam_adapter_torch import graft_entry


@pytest.mark.parametrize("tiny", [True, False])
def test_flagship_geometry_is_the_jax_entry(tiny):
    jm = jentry._flagship_model(tiny=tiny)
    got = graft_entry.flagship_config(tiny)
    assert (got["num_classes"], got["head_channels"],
            got["dropout_ratio"]) == (jm.num_classes, jm.head_channels,
                                      jm.dropout_ratio)
    assert got["backbone"] == dict(jm.backbone_cfg)
    assert (graft_entry.TINY_BACKBONE == dict(jm.backbone_cfg)) == tiny


def test_entry_is_the_bf16_flagship_forward():
    fn, (model, img) = graft_entry.entry(device="meta")
    assert img.shape == (1, 1024, 1024, 6) and img.dtype == torch.bfloat16
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    assert not model.training
    # PERF.md section 2: 459.05 M parameters
    assert round(sum(p.numel() for p in model.parameters()) / 1e6,
                 2) == 459.05
    out = fn(model, img)
    assert out.shape == (1, 1024, 1024, 25)


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    loss = graft_entry.dryrun_multichip(4, device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert re.fullmatch(r"dryrun_multichip\(4\) ok: mesh=data2xmodel2, "
                        r"loss=\d+\.\d{4}", out[-1]), out
    assert math.isfinite(loss) and out[-1].endswith(f"loss={loss:.4f}")


def test_dryrun_multichip_never_falls_back(monkeypatch):
    def no_ranks(*a, **k):
        raise AssertionError("a rank was started")

    monkeypatch.setattr("multimodal_sam_adapter_torch.parallel.ddp."
                        "launch_ranks", no_ranks)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs a card a rank"):
        graft_entry.dryrun_multichip(4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="needs a card a rank"):
        graft_entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        graft_entry.dryrun_multichip(2, backend="gloo")
    with pytest.raises(ValueError, match="gloo"):
        graft_entry.dryrun_multichip(2, device="cpu", backend="nccl")
