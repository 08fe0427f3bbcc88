"""What evaluation writes, in the port against the JAX package, on the CPU:
engine/visualize.py, MUSES.format_results, `Evaluator.run(show=...,
format_only=...)`, the single-image API (apis/inference.py) and the entries
(tools/test.py --show-dir / --format-only, tools/infer_test.py), on the
fake DELIVER and MUSES layouts of tests/test_torch_shared_copies.py.

- `colorize` and `show_result` (same size, and resized through the uint8
  INTER_LINEAR) equal JAX's arrays, and the files decode equal;
- `MUSES.format_results` writes the same names, decoding to the same maps;
- the evaluators at deliver_tiny (show) and muses_tiny (show and
  format_only), bridged parity weights in both packages: the same file
  names; every file decodes exactly to what its own package's prediction
  gives; the two packages' predictions agree on >= 99.9% of pixels (the
  model-run bound of tests/test_torch_evaluator.py) and their files are
  equal wherever they agree;
- `inference_segmentor` at deliver_tiny: the test pipeline's input equal,
  the probabilities within rtol 1e-3 / atol 2e-4, the class maps equal;
  `show_result_pyplot` equal;
- tools/infer_test.py end to end on the MUSES layout with --device cpu,
  and tools/test.py --show-dir reading CLASSES / PALETTE from a
  checkpoint's meta.
"""
import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sam_adapter_torch import apis
from multimodal_sam_adapter_torch.configs.registry import get_config
from multimodal_sam_adapter_torch import data as tdata
from multimodal_sam_adapter_torch.data import build_dataset
from multimodal_sam_adapter_torch.data.datasets import DELIVER_PALETTE
from multimodal_sam_adapter_torch.data.image_io import imread
from multimodal_sam_adapter_torch.engine import visualize as tvis
from multimodal_sam_adapter_torch.engine.convert import state_dict_from_jax
from multimodal_sam_adapter_torch.engine.evaluator import Evaluator
from multimodal_sam_adapter_torch.engine.inference import InferenceEngine
from multimodal_sam_adapter_torch.models.segmentor import build_segmentor
from multimodal_sam_adapter_torch.tools import infer_test
from multimodal_sam_adapter_torch.tools import test as test_entry
from multimodal_sam_adapter_tpu import data as jdata
from multimodal_sam_adapter_tpu.apis import inference as japis
from multimodal_sam_adapter_tpu.configs.registry import (
    get_config as jax_config)
from multimodal_sam_adapter_tpu.engine import visualize as jvis
from multimodal_sam_adapter_tpu.engine.convert_full import (
    convert_full_checkpoint)
from multimodal_sam_adapter_tpu.engine.evaluator import (
    Evaluator as JaxEvaluator)
from multimodal_sam_adapter_tpu.engine.inference import (
    InferenceEngine as JaxInferenceEngine)
from multimodal_sam_adapter_tpu.models.segmentor import (
    EncoderDecoder as JaxEncoderDecoder)
from tests.test_convert_full import synth_state_dict
from tests.test_torch_shared_copies import layouts  # noqa: F401 (fixture)

LAYOUT = {"deliver_tiny": "deliver_tiny", "muses_tiny": "muses_rgblidar"}


def _files(root):
    """Relative path -> decoded array (cv2.imread, unchanged) of every PNG
    under root."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            if n.endswith(".png"):
                p = os.path.join(d, n)
                out[os.path.relpath(p, root)] = cv2.imread(
                    p, cv2.IMREAD_UNCHANGED)
    return out


# ---------------------------------------------------------------------------
# visualize and format_results
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opacity", [0.5, 0.3])
@pytest.mark.parametrize("img_hw", [(40, 56), (33, 47), (80, 112)])
def test_colorize_and_show_result_equal_jax(tmp_path, img_hw, opacity):
    rng = np.random.default_rng(img_hw[0])
    pred = rng.integers(0, 27, (40, 56))      # classes past the palette too
    img = rng.integers(0, 256, img_hw + (3,)).astype(np.uint8)
    palette = DELIVER_PALETTE
    np.testing.assert_array_equal(tvis.colorize(pred, palette),
                                  jvis.colorize(pred, palette))
    got = tvis.show_result(img, pred, palette, opacity,
                           str(tmp_path / "t" / "a.png"))
    want = jvis.show_result(img, pred, palette, opacity,
                            str(tmp_path / "j" / "a.png"))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "t" / "a.png"), cv2.IMREAD_UNCHANGED),
        cv2.imread(str(tmp_path / "j" / "a.png"), cv2.IMREAD_UNCHANGED))
    got = tvis.dump_prediction(str(tmp_path / "t"), "fog", None, "s.png",
                               img, pred, palette, opacity)
    np.testing.assert_array_equal(imread(
        tmp_path / "t" / "prediction" / "fog" / "ordinary" / "s.png"), got)


def test_muses_format_results_equals_jax(layouts, tmp_path):  # noqa: F811
    cfg = get_config("muses_tiny")["dataset"]
    root = str(layouts["muses_rgblidar"])
    tds = build_dataset(cfg, root, test_mode=True)
    jds = jdata.build_dataset(cfg, root, test_mode=True)
    stems = [i["stem"] for i in tds.infos] + ["rain_day_R20_frame_camera"]
    rng = np.random.default_rng(0)
    preds = [rng.integers(0, 19, (54, 96)) for _ in stems]
    got = tds.format_results(preds, stems, str(tmp_path / "t"))
    want = jds.format_results(preds, stems, str(tmp_path / "j"))
    assert [os.path.relpath(f, tmp_path / "t") for f in got] == [
        os.path.relpath(f, tmp_path / "j") for f in want]
    assert os.path.basename(got[-1]) == "R20.png"
    t, j = _files(tmp_path / "t"), _files(tmp_path / "j")
    assert t.keys() == j.keys() and len(t) == len(stems)
    for k in t:
        np.testing.assert_array_equal(t[k], j[k])


# ---------------------------------------------------------------------------
# the evaluators with bridged parity weights
# ---------------------------------------------------------------------------

def _parity(name):
    """The port's and the JAX package's engines for config `name` from one
    synthesised checkpoint (tests/test_torch_evaluator.py's tiny_engines),
    and the port's state dict."""
    cfg = get_config(name)
    m = cfg["model"]
    bcfg = m["backbone"]
    sd = synth_state_dict(cfg=bcfg, head_ch=m["head_channels"],
                          ncls=m["num_classes"])
    for k in sd:
        if k.endswith("running_var"):
            sd[k] = np.abs(sd[k]) + 0.5
    idx = bcfg["interaction_indexes"]
    tree = convert_full_checkpoint(sd, idx)
    tsd = state_dict_from_jax(tree, idx)
    port = build_segmentor(m, "cpu", state_dict=tsd)
    jm = JaxEncoderDecoder(num_classes=m["num_classes"],
                           head_channels=m["head_channels"],
                           backbone_cfg=bcfg)
    variables = {"params": tree["params"], "batch_stats": tree["batch_stats"]}
    return dict(cfg=cfg, sd=tsd, jmodel=jm, variables=variables,
                port=InferenceEngine(port, cfg["test_cfg"]),
                jax=JaxInferenceEngine(jm, variables, cfg["test_cfg"]))


@pytest.fixture(scope="module")
def parity():
    return {name: _parity(name) for name in LAYOUT}


def _recording(vis, dataset, monkeypatch):
    """What an evaluator hands its visualize module's `dump_prediction`
    (file name -> (raw image, class map)) and its dataset's
    `format_results` (stem -> class map)."""
    shown, formatted = {}, {}
    dump = vis.dump_prediction

    def dump_prediction(out_dir, cond, case, name, img, pred, *a):
        shown[name] = (np.asarray(img), np.asarray(pred))
        return dump(out_dir, cond, case, name, img, pred, *a)

    monkeypatch.setattr(vis, "dump_prediction", dump_prediction)
    fr = getattr(dataset, "format_results", None)

    def format_results(preds, stems, out_dir):
        formatted.update(zip(stems, map(np.asarray, preds)))
        return fr(preds, stems, out_dir)

    if fr is not None:
        dataset.format_results = format_results
    return shown, formatted


@pytest.mark.parametrize("name,mode", [("deliver_tiny", "show"),
                                       ("muses_tiny", "show"),
                                       ("muses_tiny", "format_only")])
def test_evaluator_writes_the_files_jax_writes(parity, layouts, tmp_path,  # noqa: F811,E501
                                               monkeypatch, name, mode):
    p = parity[name]
    cfg = p["cfg"]
    root = str(layouts[LAYOUT[name]])
    ch = cfg["dataset"]["modalities_ch"]
    tds = build_dataset(cfg["dataset"], root, test_mode=True)
    jds = jdata.build_dataset(cfg["dataset"], root, test_mode=True)
    ncls = cfg["model"]["num_classes"]
    kw = dict(show=mode == "show", format_only=mode == "format_only",
              progress_every=0)
    tshown, tpreds = _recording(tvis, tds, monkeypatch)
    jshown, jpreds = _recording(jvis, jds, monkeypatch)
    got = Evaluator(p["port"], tds, ncls, out_dir=str(tmp_path / "t")).run(
        tdata.TestPipeline(cfg["test_pipeline"], ch), **kw)
    with jax.default_matmul_precision("highest"):
        want = JaxEvaluator(p["jax"], jds, ncls,
                            out_dir=str(tmp_path / "j")).run(
            jdata.TestPipeline(cfg["test_pipeline"], ch), shard=(0, 1), **kw)
    t, j = _files(tmp_path / "t"), _files(tmp_path / "j")
    assert t.keys() == j.keys() and len(t) == len(tds)
    if mode == "format_only":
        assert got.keys() == want.keys() == {"files"}
        assert ([os.path.relpath(f, tmp_path / "t") for f in got["files"]]
                == [os.path.relpath(f, tmp_path / "j")
                    for f in want["files"]])
        for stem in tpreds:
            k = os.path.join("labelTrainIds",
                             "R" + stem.split("_R", 1)[1] + ".png")
            np.testing.assert_array_equal(t[k], tpreds[stem])
            np.testing.assert_array_equal(j[k], jpreds[stem])
            agree = tpreds[stem] == jpreds[stem]
            assert agree.mean() >= 0.999
            np.testing.assert_array_equal(t[k][agree], j[k][agree])
        return
    assert "summary" in got and "summary" in want
    assert tshown.keys() == jshown.keys() and len(tshown) == len(tds)
    for name, (raw, tpred) in tshown.items():
        jraw, jpred = jshown[name]
        np.testing.assert_array_equal(raw, jraw)
        (k,) = [k for k in t if os.path.basename(k) == name]
        # each file is its own package's blend of the prediction it was
        # handed; the blend is per pixel, so the two files agree wherever
        # the predictions do
        np.testing.assert_array_equal(
            t[k], tvis.show_result(raw, tpred, tds.PALETTE))
        np.testing.assert_array_equal(
            j[k], jvis.show_result(raw, jpred, jds.PALETTE))
        agree = tpred == jpred
        assert agree.mean() >= 0.999
        np.testing.assert_array_equal(t[k][agree], j[k][agree])


# ---------------------------------------------------------------------------
# the single-image API
# ---------------------------------------------------------------------------

def test_inference_segmentor_equals_jax(parity, layouts, tmp_path):  # noqa: F811,E501
    p = parity["deliver_tiny"]
    ckpt = tmp_path / "tiny.pth"
    torch.save({"state_dict": p["sd"], "meta": {}}, ckpt)
    handle = apis.init_segmentor("deliver_tiny", str(ckpt), bf16=False,
                                 device="cpu")
    jhandle = japis.SegmentorHandle(p["jmodel"], p["variables"], p["jax"],
                                    jax_config("deliver_tiny"))
    ds = build_dataset(p["cfg"]["dataset"], str(layouts["deliver_tiny"]),
                       test_mode=True)
    for info in ds.infos:
        img, mod = info["img"], info["mod"][0]
        arr, hw = apis.inference.prepare_input(handle, img, mod)
        got = apis.inference_segmentor(handle, img, mod)
        with jax.default_matmul_precision("highest"):
            want = japis.inference_segmentor(jhandle, img, mod)
            jprobs = np.asarray(p["jax"].inference(jnp.asarray(arr[None])))
        probs = handle.engine.inference(torch.from_numpy(arr)[None]).numpy()
        np.testing.assert_allclose(probs, jprobs, rtol=1e-3, atol=2e-4)
        # 'whole_dim' gives the config's dim, the pad band cut before it
        assert got.shape == want.shape == tuple(p["cfg"]["test_cfg"]["dim"])
        assert arr.shape[:2] == tuple(-(-s // 32) * 32 for s in hw)
        np.testing.assert_array_equal(got, want)
        blend = apis.show_result_pyplot(handle, img, got, 0.4,
                                        str(tmp_path / "t.png"))
        np.testing.assert_array_equal(
            blend, japis.show_result_pyplot(jhandle, img, want, 0.4))
        np.testing.assert_array_equal(imread(tmp_path / "t.png"), blend)
    # a missing auxiliary modality reads as zeros, as in JAX
    got = apis.inference_segmentor(handle, ds.infos[0]["img"])
    with jax.default_matmul_precision("highest"):
        want = japis.inference_segmentor(jhandle, ds.infos[0]["img"])
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the entries
# ---------------------------------------------------------------------------

def test_infer_test_writes_the_submission(layouts, tmp_path):  # noqa: F811
    root = str(layouts["muses_rgblidar"])
    out = infer_test.main(["muses_tiny", "random", "--data-root", root,
                           "--device", "cpu", "--no-bf16", "--show-dir",
                           str(tmp_path)])
    assert os.path.dirname(out) == str(tmp_path)
    files = _files(tmp_path)
    subs = sorted(k for k in files if k.startswith("labelTrainIds"))
    assert subs == [os.path.join("labelTrainIds", "REC0_clear.png"),
                    os.path.join("labelTrainIds", "REC0_fog.png")]
    for k in subs:
        assert files[k].shape == (54, 96) and files[k].dtype == np.uint8
        assert files[k].max() < 19
    blends = sorted(k for k in files if k.startswith("prediction"))
    assert blends == [
        os.path.join("prediction", "day", "clear", "clear_day_REC0_clear.png"),
        os.path.join("prediction", "night", "fog", "fog_night_REC0_fog.png")]
    with open(out) as f:
        assert "mIoU" not in json.load(f)


def test_test_entry_show_dir_reads_the_checkpoint_meta(layouts, tmp_path):  # noqa: F811,E501
    cfg = get_config("deliver_tiny")
    model = build_segmentor(cfg["model"], "cpu",
                            generator=torch.Generator().manual_seed(2))
    ckpt = tmp_path / "tiny.pth"
    palette = [[10, 20, 30]] * 25
    torch.save({"state_dict": model.state_dict(), "meta": {
        "CLASSES": [f"k{i}" for i in range(25)], "PALETTE": palette}}, ckpt)
    root = str(layouts["deliver_tiny"])
    show = tmp_path / "show"
    out = test_entry.main(["deliver_tiny", str(ckpt), "--data-root", root,
                           "--device", "cpu", "--no-bf16", "--show-dir",
                           str(show), "--out-dir", str(tmp_path / "x")])
    assert os.path.dirname(out) == str(show)
    with open(out) as f:
        assert np.isfinite(json.load(f)["mIoU"])
    ds = build_dataset(cfg["dataset"], root, test_mode=True)
    files = _files(show)
    assert len(files) == len(ds)
    for i in range(len(ds)):
        raw = ds[i]["img"][..., :3].astype(np.uint8)
        (k,) = [k for k in files if k.endswith(ds.infos[i]["stem"] + ".png")]
        # 'whole_dim' predicts on the config's 64^2 grid: the raw image is
        # resized to it (OpenCV's uint8 INTER_LINEAR); one colour for every
        # class, so the blend needs no prediction
        raw = cv2.resize(raw, files[k].shape[1::-1])
        want = (raw * 0.5 + np.array([30, 20, 10]) * 0.5).astype(np.uint8)
        np.testing.assert_array_equal(files[k], want)
