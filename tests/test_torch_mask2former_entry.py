"""The entries with the Mask2Former head on the CPU: tools/train.py trains
deliver_tiny_m2f on a fake DELIVER-layout tree and writes its checkpoints;
tools/test.py and tools/infer_test.py evaluate them, deliver_tiny takes
the head from --cfg-options, and the single-image API builds it from the
config. torch on one thread (see tests/test_torch_train_entry.py).
"""
import json
import os

import numpy as np
import pytest
import torch

from multimodal_sam_adapter_torch import apis
from multimodal_sam_adapter_torch.engine.evaluator import Evaluator
from multimodal_sam_adapter_torch.models.mask2former import Mask2FormerHead
from multimodal_sam_adapter_torch.tools import infer_test
from multimodal_sam_adapter_torch.tools import test as test_entry
from multimodal_sam_adapter_torch.tools import train as train_entry
from tests.test_torch_evaluator import fake_deliver  # noqa: F401

TINY_HEAD = ["model.head_type=mask2former", "model.head_channels=32",
             "model.head={'num_queries':4,'num_decoder_layers':1,"
             "'num_encoder_layers':1}"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trained(fake_deliver, tmp_path_factory):  # noqa: F811
    work = str(tmp_path_factory.mktemp("m2f_train"))
    runner = train_entry.main([
        "deliver_tiny_m2f", "--data-root", fake_deliver, "--work-dir", work,
        "--device", "cpu", "--max-epochs", "1", "--cfg-options",
        "log_config.interval=1"])
    return runner, work


def test_train_entry_trains_the_m2f_head(trained):
    runner, work = trained
    head = runner.state.model.decode_head
    assert isinstance(head, Mask2FormerHead)
    assert len(head.transformer_decoder.layers) == 2
    with open(os.path.join(work, "train_log.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r["loss"] for r in recs if "loss" in r]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert any("eval" in r for r in recs)
    assert runner.state.optimizer.updates == 2
    # the last step's assignments: in each image, one query a class
    for row in head.record["assign"][-1]:
        matched = row[row >= 0].tolist()
        assert matched and len(set(matched)) == len(matched)
    assert sorted(os.listdir(os.path.join(work, "ckpts"))) == [
        "best.pth", "step_2.pth"]


def test_test_entry_evaluates_the_checkpoint(trained, fake_deliver,  # noqa: F811,E501
                                             tmp_path):
    _, work = trained
    out = test_entry.main([
        "deliver_tiny_m2f", os.path.join(work, "ckpts", "best.pth"),
        "--data-root", fake_deliver, "--device", "cpu", "--no-bf16",
        "--out-dir", str(tmp_path)])
    with open(out) as f:
        payload = json.load(f)
    assert payload["provenance"]["config"] == "deliver_tiny_m2f"
    for key in ("mIoU", "aAcc", "mAcc"):
        assert np.isfinite(payload[key])


def test_entries_take_the_head_from_cfg_options(fake_deliver, tmp_path,  # noqa: F811,E501
                                                monkeypatch):
    """deliver_tiny with --cfg-options model.head_type=mask2former (and a
    head of 32 channels: GroupNorm's 32 groups) builds and evaluates the
    head; infer_test writes predictions only; the bf16 model runs."""
    built = []
    real = Evaluator.run

    def recorded(ev, *a, **kw):
        built.append(ev.engine.model)
        return real(ev, *a, **kw)

    monkeypatch.setattr(Evaluator, "run", recorded)
    out = test_entry.main(["deliver_tiny", "random", "--data-root",
                           fake_deliver, "--device", "cpu", "--out-dir",
                           str(tmp_path), "--cfg-options"] + TINY_HEAD)
    model = built[-1]
    assert isinstance(model.decode_head, Mask2FormerHead)
    assert model.decode_head.num_queries == 4
    assert next(model.parameters()).dtype == torch.bfloat16
    with open(out) as f:
        assert np.isfinite(json.load(f)["mIoU"])
    infer_test.main(["deliver_tiny_m2f", "random", "--data-root",
                     fake_deliver, "--device", "cpu", "--no-bf16",
                     "--show-dir", str(tmp_path / "show")])
    assert isinstance(built[-1].decode_head, Mask2FormerHead)


def test_single_image_api_builds_the_head(fake_deliver):  # noqa: F811
    handle = apis.init_segmentor("deliver_tiny_m2f", bf16=False,
                                 device="cpu")
    assert isinstance(handle.model.decode_head, Mask2FormerHead)
    root = os.path.join(fake_deliver, "samples")
    img = os.path.join(root, "images", "test", "sun_test_0_rgb_front.png")
    mod = os.path.join(root, "lidar", "test", "sun_test_0_lidar_front.png")
    pred = apis.inference_segmentor(handle, img, mod)
    assert pred.shape[0] > 0 and pred.max() < 25
