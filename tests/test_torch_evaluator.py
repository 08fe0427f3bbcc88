"""The port's Evaluator against the JAX package's, and the port's test
entry (`python -m multimodal_sam_adapter_torch.tools.test`).

- Exact metrics: both evaluators run one stub engine (fixed class maps
  computed from the input) over one in-memory dataset with condition and
  case meta, ignored pixels, ragged shapes (padded to a multiple of 32) and
  several batching, sharding and flip-TTA settings: histograms, flat mIoU
  and the nested report agree exactly.
- Model runs: deliver_tiny on one bridged checkpoint in both packages,
  including a sample whose labels are smaller than the prediction (the
  re-inference path): class maps agree on >= 99.9% of pixels.
- The entry writes its JSON, with the DELIVER case breakdown, on a
  DELIVER-layout dataset written with OpenCV.
"""
import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_sam_adapter_torch.engine.evaluator as tevaluator
import multimodal_sam_adapter_tpu.engine.evaluator as jevaluator
from multimodal_sam_adapter_torch.engine.convert import state_dict_from_jax
from multimodal_sam_adapter_torch.engine.evaluator import Evaluator
from multimodal_sam_adapter_torch.engine.inference import InferenceEngine
from multimodal_sam_adapter_torch.models.segmentor import build_segmentor
from multimodal_sam_adapter_torch.tools import test as entry
from multimodal_sam_adapter_torch.configs.registry import get_config
from multimodal_sam_adapter_tpu.engine.convert_full import (
    convert_full_checkpoint)
from multimodal_sam_adapter_tpu.engine.evaluator import (
    Evaluator as JaxEvaluator)
from multimodal_sam_adapter_tpu.engine.inference import (
    InferenceEngine as JaxInferenceEngine)
from multimodal_sam_adapter_tpu.models.segmentor import (
    EncoderDecoder as JaxEncoderDecoder)
from tests.test_convert_full import synth_state_dict

K = 6


class InMemoryDataset:
    CLASSES = tuple(f"c{i}" for i in range(K))
    CONDITIONS = ("cloud", "sun")
    CASES = ("motionblur", "overexposure")

    def __init__(self, shapes, seed=0, num_classes=K):
        rng = np.random.default_rng(seed)
        conds = ("cloud", "sun", None)
        cases = (None, "motionblur", "overexposure", None)
        self.samples = []
        for i, (h, w) in enumerate(shapes):
            gt = rng.integers(0, num_classes, (h, w)).astype(np.uint8)
            gt[rng.random((h, w)) < 0.1] = 255
            self.samples.append(dict(
                img=rng.standard_normal((h, w, 6)).astype(np.float32),
                gt=gt, meta=dict(stem=f"s{i}", condition=conds[i % 3],
                                 case=cases[i % 4])))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        s = self.samples[i]
        return dict(img=s["img"].copy(), gt=s["gt"].copy(),
                    meta=dict(s["meta"]))


class StubEngine:
    """Class maps computed from the input pixels, for either package: the
    port's evaluator gets torch tensors back, the JAX one numpy / jax
    arrays."""

    def __init__(self, as_torch):
        self.as_torch = as_torch
        self.test_cfg = {"mode": "whole"}
        self.calls = []

    @staticmethod
    def _classes(img, valid_hw):
        a = np.asarray(img)
        pred = (np.floor(a[..., 0] * 3) + np.floor(a[..., 1] * 5)
                ).astype(np.int64) % K
        if valid_hw is not None:
            pred = pred[:, :valid_hw[0], :valid_hw[1]]
        return pred

    def predict(self, img, ori_shape=None, valid_hw=None):
        self.calls.append(tuple(img.shape))
        pred = self._classes(img, valid_hw)
        return torch.from_numpy(pred) if self.as_torch else pred

    def inference(self, img, ori_shape=None, flip=False, valid_hw=None,
                  **kw):
        self.calls.append(tuple(img.shape))
        probs = np.eye(K, dtype=np.float32)[self._classes(img, valid_hw)]
        assert ori_shape is None or tuple(ori_shape) == probs.shape[1:3]
        if flip:
            probs = np.ascontiguousarray(probs[:, :, ::-1])
        return torch.from_numpy(probs) if self.as_torch else jnp.asarray(
            probs)


SHAPES = [(64, 64), (64, 64), (64, 64), (60, 56), (60, 56), (32, 48),
          (64, 64)]


@pytest.mark.parametrize("kw", [
    dict(), dict(batch_size=2), dict(batch_size=3, max_samples=5),
    dict(shard=(1, 2)), dict(aug_cfg={"ratios": [1.0], "flip": True}),
], ids=["batch1", "batch2", "batch3_max5", "shard1of2", "flip_tta"])
def test_metrics_match_jax_exactly_on_stub_predictions(kw):
    ds = InMemoryDataset(SHAPES)
    port_engine, jax_engine = StubEngine(True), StubEngine(False)
    got = Evaluator(port_engine, ds, K, case_aware=True).run(
        progress_every=0, **kw)
    want = JaxEvaluator(jax_engine, ds, K, case_aware=True).run(
        progress_every=0, **dict(kw, shard=kw.get("shard", (0, 1))))
    assert port_engine.calls == jax_engine.calls
    np.testing.assert_array_equal(got["payload"]["flat"],
                                  want["payload"]["flat"])
    np.testing.assert_array_equal(got["payload"]["nested"],
                                  want["payload"]["nested"])
    for key in ("IoU", "Acc", "aAcc"):
        np.testing.assert_array_equal(got["flat"][key], want["flat"][key])
    assert got["summary"] == want["summary"]
    assert got["nested_report"] == want["nested_report"]
    assert got["eval_results"] == want["eval_results"]
    assert "_motionblur results" in got["nested_report"]
    if "batch_size" not in kw:
        return
    # same-shape images went through one stacked forward each, and the
    # metrics equal the batch-1 run's where the same samples are scored
    assert max(c[0] for c in port_engine.calls) == kw["batch_size"]
    one = Evaluator(StubEngine(True), ds, K, case_aware=True).run(
        progress_every=0, max_samples=kw.get("max_samples"))
    np.testing.assert_array_equal(got["payload"]["flat"],
                                  one["payload"]["flat"])


def test_slide_and_tta_force_batch_one_and_unported_options_raise():
    ds = InMemoryDataset(SHAPES[:4])
    engine = StubEngine(True)
    engine.test_cfg = {"mode": "slide"}
    Evaluator(engine, ds, K).run(progress_every=0, batch_size=4)
    assert [c[0] for c in engine.calls] == [1, 1, 1, 1]
    ev = Evaluator(StubEngine(True), ds, K)
    # show without an out_dir writes nothing and scores as usual;
    # format_only on a dataset with no format_results writes no files and
    # skips the metrics (tests/test_torch_output_surface.py writes both)
    assert "flat" in ev.run(show=True, progress_every=0)
    assert ev.run(format_only=True, progress_every=0) == {"files": []}
    with pytest.raises(ValueError):  # a scale ratio needs the pipeline
        ev.run(aug_cfg={"ratios": [0.5], "flip": False})


@pytest.fixture(scope="module")
def tiny_engines():
    cfg = get_config("deliver_tiny")
    m = cfg["model"]
    bcfg = m["backbone"]
    sd = synth_state_dict(cfg=bcfg, head_ch=m["head_channels"],
                          ncls=m["num_classes"])
    for k in sd:
        if k.endswith("running_var"):
            sd[k] = np.abs(sd[k]) + 0.5
    idx = bcfg["interaction_indexes"]
    tree = convert_full_checkpoint(sd, idx)
    port = build_segmentor(m, "cpu", state_dict=state_dict_from_jax(tree, idx))
    jm = JaxEncoderDecoder(num_classes=m["num_classes"],
                           head_channels=m["head_channels"],
                           backbone_cfg=bcfg)
    variables = {"params": tree["params"], "batch_stats": tree["batch_stats"]}
    return (InferenceEngine(port, cfg["test_cfg"]),
            JaxInferenceEngine(jm, variables, cfg["test_cfg"]),
            m["num_classes"])


def _recording(module, monkeypatch):
    """Record the class maps an evaluator module scores."""
    preds = []
    real = module.intersect_and_union

    def record(pred, gt, *a, **kw):
        preds.append(np.asarray(pred))
        return real(pred, gt, *a, **kw)

    monkeypatch.setattr(module, "intersect_and_union", record)
    return preds


def test_model_runs_agree_with_jax(tiny_engines, monkeypatch):
    """deliver_tiny ('whole_dim' at 64^2): three 64^2 samples and one 60x56
    sample, padded to 64^2, whose 64^2 prediction no longer fits its
    labels: both evaluators re-run it and resize the probabilities to the
    label grid."""
    engine, jengine, ncls = tiny_engines
    ds = InMemoryDataset([(64, 64), (64, 64), (60, 56), (64, 64)], seed=1,
                         num_classes=ncls)
    ds.CLASSES = tuple(f"c{i}" for i in range(ncls))
    got_preds = _recording(tevaluator, monkeypatch)
    want_preds = _recording(jevaluator, monkeypatch)
    got = Evaluator(engine, ds, ncls, case_aware=True).run(progress_every=0)
    with jax.default_matmul_precision("highest"):
        want = JaxEvaluator(jengine, ds, ncls, case_aware=True).run(
            progress_every=0, shard=(0, 1))
    assert len(got_preds) == len(want_preds) == len(ds)
    for g, w, s in zip(got_preds, want_preds, ds.samples):
        assert g.shape == w.shape == s["gt"].shape
        assert (g == w).mean() >= 0.999
    labelled = sum(float((s["gt"] != 255).sum()) for s in ds.samples)
    diff = np.abs(got["payload"]["flat"][0] - want["payload"]["flat"][0])
    assert diff.sum() <= 2e-3 * labelled
    assert set(got["eval_results"]) == set(want["eval_results"])


@pytest.fixture(scope="module")
def fake_deliver(tmp_path_factory):
    """A DELIVER-layout dataset of 80x80 images (the layout of
    tests/test_cli_e2e.py)."""
    root = tmp_path_factory.mktemp("deliver")
    rng = np.random.default_rng(0)
    for split in ("training", "validation", "test"):
        for d in ("images", "annotations", "lidar"):
            os.makedirs(root / "samples" / d / split, exist_ok=True)
        for ci, cond in enumerate(("sun", "rain")):
            for case in ("", "motionblur_"):
                stem = f"{case}{cond}_{split}_{ci}"
                for d, suffix, img in (
                        ("images", "rgb", rng.integers(0, 255, (80, 80, 3))),
                        ("lidar", "lidar", rng.integers(0, 255, (80, 80, 3))),
                        ("annotations", "semantic",
                         rng.integers(0, 25, (80, 80)))):
                    cv2.imwrite(str(root / "samples" / d / split /
                                    f"{stem}_{suffix}_front.png"),
                                img.astype(np.uint8))
    return str(root)


def test_entry_writes_the_eval_json(fake_deliver, tmp_path, capsys):
    out = entry.main(["deliver_tiny", "random", "--data-root", fake_deliver,
                      "--device", "cpu", "--no-bf16", "--out-dir",
                      str(tmp_path), "--batch-size", "2"])
    assert os.path.basename(out).startswith("eval_single_scale_")
    with open(out) as f:
        payload = json.load(f)
    for key in ("mIoU", "aAcc", "mAcc"):
        assert np.isfinite(payload[key])
    prov = payload["provenance"]
    assert prov["config"] == "deliver_tiny" and prov["checkpoint"] == "random"
    assert prov["framework"] == "torch" and prov["dtype"] == "float32"
    assert prov["n_samples"] == 4
    assert {"sun", "rain"} <= set(payload["eval_results"])
    assert "motionblur" in payload["eval_results"]["sun"]
    assert "_motionblur results" in capsys.readouterr().out


def test_entry_loads_a_state_dict_strictly_and_refuses_a_missing_card(
        fake_deliver, tmp_path):
    cfg = get_config("deliver_tiny")
    model = build_segmentor(cfg["model"], "cpu",
                            generator=torch.Generator().manual_seed(1))
    ckpt = tmp_path / "tiny.pth"
    torch.save(model.state_dict(), ckpt)
    args = ["deliver_tiny", str(ckpt), "--data-root", fake_deliver,
            "--device", "cpu", "--no-bf16", "--out-dir", str(tmp_path),
            "--max-samples", "2"]
    with open(entry.main(args)) as f:
        payload = json.load(f)
    assert payload["provenance"]["n_samples"] == 2
    bad = dict(model.state_dict())
    bad.pop(next(iter(bad)))
    torch.save(bad, ckpt)
    with pytest.raises(RuntimeError, match="Missing key"):
        entry.main(args)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA card"):
            entry.main(args[:4] + args[6:])
