"""The port's checkpoint reader (engine/checkpoint.py) and the test entry on
checkpoints in the reference's forms, against the JAX package's reader.

A synthetic deliver_tiny checkpoint with the reference's key names (and
BatchNorm's `num_batches_tracked`, as torch writes it) is saved with
`torch.save` bare, as the reference's mmcv container (`state_dict` with
DistributedDataParallel's `module.` prefixes, `meta`, `optimizer`) and as
`{"model": ...}`: the port's reader and
multimodal_sam_adapter_tpu/engine/checkpoint.py:load_torch_checkpoint give
the same keys and values for each file, and `tools/test.py` loads each
strictly and scores alike.
"""
import json
import pickle

import numpy as np
import pytest
import torch

from multimodal_sam_adapter_torch.configs.registry import get_config
from multimodal_sam_adapter_torch.engine.checkpoint import (
    load_state_dict_file)
from multimodal_sam_adapter_torch.tools import test as entry
from multimodal_sam_adapter_tpu.engine.checkpoint import load_torch_checkpoint
from tests.test_convert_full import synth_state_dict
from tests.test_torch_evaluator import fake_deliver  # noqa: F401 (fixture)

FORMS = ("bare", "mmcv_ddp", "model")


@pytest.fixture(scope="module")
def tiny_state_dict():
    m = get_config("deliver_tiny")["model"]
    sd = synth_state_dict(cfg=m["backbone"], head_ch=m["head_channels"],
                          ncls=m["num_classes"])
    out = {}
    for k, v in sd.items():
        v = np.asarray(v)
        if k.endswith("running_var"):
            v = np.abs(v) + 0.5
        out[k] = torch.from_numpy(np.ascontiguousarray(v))
        if k.endswith("running_mean"):
            out[k[:-len("running_mean")] + "num_batches_tracked"] = (
                torch.tensor(0))
    return out


def _save(sd, form, path):
    if form == "bare":
        obj = sd
    elif form == "mmcv_ddp":
        obj = {"meta": {"mmcv_version": "1.7.0", "epoch": 3, "iter": 120,
                        "CLASSES": ("road", "car"), "PALETTE": [[1, 2, 3]]},
               "state_dict": {"module." + k: v for k, v in sd.items()},
               "optimizer": {"state": {0: {"exp_avg": torch.ones(2)}},
                             "param_groups": [{"lr": 1e-4, "params": [0]}]}}
    else:
        obj = {"model": sd}
    torch.save(obj, path)
    return str(path)


@pytest.mark.parametrize("form", FORMS)
def test_reader_matches_the_jax_reader(form, tiny_state_dict, tmp_path):
    path = _save(tiny_state_dict, form, tmp_path / f"{form}.pth")
    got = load_state_dict_file(path)
    want = load_torch_checkpoint(path)
    assert set(got) == set(want) == set(tiny_state_dict)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, k)
        assert torch.equal(got[k], tiny_state_dict[k]), k


@pytest.fixture(scope="module")
def bare_scores(tiny_state_dict, fake_deliver, tmp_path_factory):  # noqa: F811
    d = tmp_path_factory.mktemp("bare")
    return _entry(_save(tiny_state_dict, "bare", d / "bare.pth"),
                  fake_deliver, d)


def _entry(ckpt, data_root, out_dir):
    out = entry.main(["deliver_tiny", ckpt, "--data-root", data_root,
                      "--device", "cpu", "--no-bf16", "--out-dir",
                      str(out_dir), "--max-samples", "2"])
    with open(out) as f:
        payload = json.load(f)
    assert payload["provenance"]["checkpoint"] == ckpt
    return {k: payload[k] for k in ("mIoU", "aAcc", "mAcc")}


@pytest.mark.parametrize("form", FORMS)
def test_entry_loads_each_form_strictly(form, tiny_state_dict, bare_scores,
                                        fake_deliver, tmp_path):  # noqa: F811
    path = _save(tiny_state_dict, form, tmp_path / f"{form}.pth")
    scores = _entry(path, fake_deliver, tmp_path)
    assert all(np.isfinite(v) for v in scores.values())
    assert scores == bare_scores
    bad = dict(tiny_state_dict)
    bad.pop("decode_head.conv_seg.weight")
    path = _save(bad, form, tmp_path / f"{form}_bad.pth")
    with pytest.raises(RuntimeError, match="Missing key"):
        _entry(path, fake_deliver, tmp_path)


class _NotAllowed:
    pass


def test_reader_says_why_it_refuses_a_file(tmp_path):
    path = tmp_path / "objects.pth"
    torch.save({"state_dict": {"w": torch.ones(1)}, "meta": _NotAllowed()},
               path)
    with pytest.raises(RuntimeError, match="weights_only=True") as e:
        load_state_dict_file(str(path))
    assert isinstance(e.value.__cause__, pickle.UnpicklingError)
    path = tmp_path / "list.pth"
    torch.save([torch.ones(1)], path)
    with pytest.raises(RuntimeError, match="no state_dict of tensors"):
        load_state_dict_file(str(path))
    torch.save({"state_dict": {"w": torch.ones(1), "note": "x"}}, path)
    with pytest.raises(RuntimeError, match="no state_dict of tensors"):
        load_state_dict_file(str(path))
