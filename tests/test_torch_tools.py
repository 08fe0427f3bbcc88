"""The port's tools (multimodal_sam_adapter_torch/tools/) against the root
tools of the JAX package, on the CPU, and checkpoint sources.

- `make_synth_deliver` (n = 2, seeds 0 and 1), `convert_deliver` (a raw
  tree with 8-bit, 3-channel, 16-bit and palette labels, 255s included)
  and `color_gt` (the three palettes, labels past each palette's end):
  the same files as the root tool writes, each decoding by `cv2.imread`
  (IMREAD_UNCHANGED) to the same array; the port writes its PNGs with
  data/image_io.py, so only the bytes may differ.
- `hard_easy_division` and `extract_fmb_val`: the same files written,
  moved or copied, and the same output, the dry run included.
- `resolve_checkpoint_source`: file:// and http:// (a loopback
  http.server thread) fetched once into the cache, the second load a
  hit; a plain path unchanged.
- `convert_checkpoints` sam / full: the file written loads strictly and
  equals the state dict of the direct path; tools/test.py scores it as it
  scores the reference file.
- One epoch of tools/train.py and tools/test.py on a tree the port's
  make_synth_deliver wrote; the kernels' entries called as often as
  chip_smoke.py's phase 15 predicts their launches on the card.
"""
import functools
import http.server
import importlib.util
import json
import sys
import threading
from pathlib import Path

import chip_smoke
import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from multimodal_sam_adapter_torch.configs.registry import get_config
from multimodal_sam_adapter_torch.engine.checkpoint import (
    ingest_sam_pth, load_state_dict_file, resolve_checkpoint_source,
    restore_checkpoint)
from multimodal_sam_adapter_torch.models.sam_vit import ImageEncoderViT
from multimodal_sam_adapter_torch.models.segmentor import build_segmentor
from multimodal_sam_adapter_torch.tools import (color_gt, convert_checkpoints,
                                                convert_deliver,
                                                extract_fmb_val,
                                                hard_easy_division,
                                                make_synth_deliver)
from multimodal_sam_adapter_torch.tools import test as test_entry
from multimodal_sam_adapter_torch.tools import train as train_entry
from multimodal_sam_adapter_torch.utils import flops
from tests.test_convert_full import synth_state_dict
from tests.test_torch_evaluator import fake_deliver  # noqa: F401 (fixture)
from tests.test_torch_sam_encoder import ENC, sam_file, sam_layout

ROOT = Path(__file__).resolve().parents[1]


def root_tool(name):
    """The root tools/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(
        f"root_tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_root(monkeypatch, name, *argv):
    monkeypatch.setattr(sys, "argv", [f"tools/{name}.py", *map(str, argv)])
    root_tool(name).main()


def files_of(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*")
                  if p.is_file())


def assert_same_pngs(a, b):
    """The two trees hold the same files, each PNG decoding alike."""
    names = files_of(a)
    assert names and names == files_of(b)
    for n in names:
        if n.endswith(".png"):
            x = cv2.imread(str(Path(a) / n), cv2.IMREAD_UNCHANGED)
            y = cv2.imread(str(Path(b) / n), cv2.IMREAD_UNCHANGED)
            assert x.dtype == y.dtype and np.array_equal(x, y), n
        else:
            assert (Path(a) / n).read_bytes() == (Path(b) / n).read_bytes()


@pytest.mark.parametrize("seed", [0, 1])
def test_make_synth_deliver_equals_the_root_tool(tmp_path, monkeypatch,
                                                 capsys, seed):
    run_root(monkeypatch, "make_synth_deliver", tmp_path / "root", 2, seed)
    make_synth_deliver.main([str(tmp_path / "port"), "2", str(seed)])
    root_out, port_out = capsys.readouterr().out.splitlines()
    assert root_out.split(": ")[1] == port_out.split(": ")[1] == "24 samples"
    assert_same_pngs(tmp_path / "root", tmp_path / "port")
    assert len(files_of(tmp_path / "port")) == 72


def _raw_deliver(root, rng):
    """A raw DeLiVER download: <mod>/<case>/<split>/<cond>/<frame>.png
    (conditions as directories), labels in several PNG kinds."""
    def label(kind):
        lab = rng.integers(0, 26, (24, 20)).astype(np.uint8)
        lab[rng.random(lab.shape) < 0.1] = 255
        if kind == "3ch":
            return np.stack([lab, lab[::-1], lab[:, ::-1]], -1)
        if kind == "16bit":
            return (lab.astype(np.uint16) * 3 + 40)
        return lab

    kinds = ("8bit", "3ch", "16bit", "palette")
    i = 0
    for case in ("cloud", "night"):
        for split in ("train", "val", "test"):
            for cond in ("MAP_1_point0", "MAP_3_point2"):
                for frame in ("000001", "000002"):
                    for mod, suffix in (("img", "rgb_front"),
                                        ("lidar", "lidar_front"),
                                        ("depth", "depth_front"),
                                        ("semantic", "semantic_front")):
                        d = root / mod / case / split / cond
                        d.mkdir(parents=True, exist_ok=True)
                        path = str(d / f"{frame}_{suffix}.png")
                        if mod != "semantic":
                            cv2.imwrite(path, rng.integers(
                                0, 256, (24, 20, 3)).astype(np.uint8))
                            continue
                        kind = kinds[i % len(kinds)]
                        i += 1
                        if kind == "palette":
                            im = Image.fromarray(label("8bit"), mode="P")
                            im.putpalette(list(rng.integers(
                                0, 256, 768).astype(np.uint8)))
                            im.save(path)
                        else:
                            cv2.imwrite(path, label(kind))
    (root / "img" / "cloud" / "train" / "MAP_1_point0" / "notes.txt"
     ).write_text("not an image")


def test_convert_deliver_equals_the_root_tool(tmp_path, monkeypatch, capsys):
    _raw_deliver(tmp_path / "raw", np.random.default_rng(0))
    run_root(monkeypatch, "convert_deliver", tmp_path / "raw",
             tmp_path / "root")
    want = capsys.readouterr().out
    n = convert_deliver.main([str(tmp_path / "raw"), str(tmp_path / "port")])
    assert capsys.readouterr().out == want
    assert "skip event: not found" in want
    assert n == 2 * 3 * 2 * 2 * 4
    assert_same_pngs(tmp_path / "root", tmp_path / "port")
    labels = tmp_path / "port" / "samples" / "annotations"
    seen = np.concatenate([cv2.imread(str(p), cv2.IMREAD_UNCHANGED).ravel()
                           for p in labels.rglob("*.png")])
    assert 255 in seen and seen.max() == 255


@pytest.mark.parametrize("dataset", ["DELIVER", "FMB", "MUSES"])
def test_color_gt_equals_the_root_tool(tmp_path, monkeypatch, capsys,
                                       dataset):
    rng = np.random.default_rng(1)
    gt = tmp_path / "gt"
    gt.mkdir()
    lab = rng.integers(0, 30, (20, 24)).astype(np.uint8)
    lab[0, :4] = 255
    cv2.imwrite(str(gt / "a.png"), lab)
    cv2.imwrite(str(gt / "b.png"), np.stack([lab.T[:20, :20]] * 3, -1))
    cv2.imwrite(str(gt / "c.png"), lab.astype(np.uint16) * 20)
    (gt / "d.txt").write_text("skipped")
    run_root(monkeypatch, "color_gt", dataset, gt, tmp_path / "root")
    assert color_gt.main([dataset, str(gt), str(tmp_path / "port")]) == 3
    assert capsys.readouterr().out == "done\ndone\n"
    assert_same_pngs(tmp_path / "root", tmp_path / "port")
    colors = cv2.imread(str(tmp_path / "port" / "a.png"))
    assert (colors[0, :4] == 0).all() and colors.any()


def test_hard_easy_division_equals_the_root_tool(tmp_path, monkeypatch,
                                                 capsys):
    outs = []
    for tag in ("root", "port"):
        d = tmp_path / tag / "samples" / "images" / "test"
        d.mkdir(parents=True)
        for name in ("cloud_underexposure_1_rgb_front.png",
                     "fog_1_rgb_front.png", "night_underexposure_2.png",
                     "sun_3_rgb_front.png", "readme.txt"):
            (d / name).write_bytes(b"")
        if tag == "root":
            run_root(monkeypatch, "hard_easy_division", tmp_path / tag)
        else:
            hard, easy = hard_easy_division.main([str(tmp_path / tag)])
            assert len(hard) == len(easy) == 2
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] == ("test_hard.txt: 2 files\n"
                                  "test_easy.txt: 2 files\n")
    for split in ("test_hard.txt", "test_easy.txt"):
        assert ((tmp_path / "root" / split).read_text()
                == (tmp_path / "port" / split).read_text())


def _fmb(root):
    for division, names in (("train", ("a.png", "b.png", "c.png", "e.png")),
                            ("test", ("d.png", "f.png"))):
        for mod in ("Visible", "Infrared"):
            d = root / division / mod
            d.mkdir(parents=True)
            for n in names:
                (d / n).write_bytes(f"{division}/{mod}/{n}".encode())
    lists = {"train_easy_files.txt": "a.png\nmissing.png\n\n",
             "train_hard_files.txt": "b.png\n",
             "val_easy_files.txt": "c.png\n",
             "test_hard_files.txt": "d.png\n",
             "test_easy_files.txt": "f.png\n"}
    for name, text in lists.items():
        (root / name).write_text(text)


@pytest.mark.parametrize("flags", [[], ["--copy"], ["--dry-run"],
                                   ["--modality-dirs", "Visible", "Infrared",
                                    "--divisions", "val", "test"]])
def test_extract_fmb_val_equals_the_root_tool(tmp_path_factory, monkeypatch,
                                              capsys, flags):
    # the root tool replaces every "val" in the path: a root without one
    tmp_path = tmp_path_factory.mktemp("fmb")
    assert "val" not in str(tmp_path)
    outs = []
    for tag in ("root", "port"):
        base = tmp_path / tag
        _fmb(base)
        if tag == "root":
            run_root(monkeypatch, "extract_fmb_val", base, *flags)
        else:
            extract_fmb_val.main([str(base), *flags])
        outs.append(capsys.readouterr().out.replace(str(base), "<base>"))
    assert outs[0] == outs[1]
    assert "Warning: <base>/train/Visible/missing.png does not exist." \
        in outs[0] or "--divisions" in flags
    assert files_of(tmp_path / "root") == files_of(tmp_path / "port")
    for n in files_of(tmp_path / "root"):
        assert ((tmp_path / "root" / n).read_bytes()
                == (tmp_path / "port" / n).read_bytes())
    moved = (tmp_path / "port" / "val" / "Visible" / "easy" / "c.png")
    assert moved.exists() == ("--dry-run" not in flags)


def test_extract_fmb_val_under_a_path_holding_val(tmp_path_factory):
    base = tmp_path_factory.mktemp("eval") / "FMB"
    _fmb(base)
    assert extract_fmb_val.main([str(base), "--divisions", "val"]) == (1, 0)
    assert (base / "val" / "Visible" / "easy" / "c.png").read_bytes() == (
        b"train/Visible/c.png")


class _CountingHandler(http.server.SimpleHTTPRequestHandler):
    requests = 0

    def do_GET(self):
        type(self).requests += 1
        super().do_GET()

    def log_message(self, *args):
        pass


@pytest.fixture
def loopback_server(tmp_path):
    """An http.server on 127.0.0.1 serving tmp_path/served."""
    served = tmp_path / "served"
    served.mkdir()
    _CountingHandler.requests = 0
    server = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0),
        functools.partial(_CountingHandler, directory=str(served)))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield served, f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        assert not thread.is_alive()


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a.weight": torch.randn(3, 4, generator=g),
            "b.bias": torch.randn(5, generator=g)}


def test_checkpoint_sources_http_and_file(tmp_path, monkeypatch,
                                          loopback_server):
    served, url = loopback_server
    cache = tmp_path / "cache"
    monkeypatch.setenv("MSA_CHECKPOINT_CACHE", str(cache))
    sd = _state()
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()}},
               served / "model.pth")
    for _ in range(2):
        got = load_state_dict_file(f"{url}/model.pth")
        assert got.keys() == sd.keys()
        assert all(torch.equal(got[k], sd[k]) for k in sd)
    assert _CountingHandler.requests == 1
    local = resolve_checkpoint_source(f"{url}/model.pth?token=1")
    assert _CountingHandler.requests == 2
    assert Path(local).parent == cache and local.endswith("_model.pth")
    assert not list(cache.glob("*.part"))

    path = tmp_path / "plain.pth"
    torch.save(sd, path)
    assert resolve_checkpoint_source(str(path)) == str(path)
    got = load_state_dict_file(f"file://{path}")
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    first = resolve_checkpoint_source(f"file://{path}")
    other = resolve_checkpoint_source(f"file://{path}",
                                      cache_dir=str(tmp_path / "elsewhere"))
    assert Path(other).parent == tmp_path / "elsewhere"
    path.unlink()
    assert resolve_checkpoint_source(f"file://{path}") == first
    assert Path(first).exists()


def test_convert_checkpoints_sam(tmp_path, capsys):
    sd = sam_layout(np.random.default_rng(0), 6, ENC["depth"],
                    ENC["embed_dim"], ENC["num_heads"], ENC["window_size"],
                    ENC["global_attn_indexes"])
    pth = sam_file(sd, tmp_path / "sam.pth")
    out = convert_checkpoints.main(["sam", pth, str(tmp_path / "sam.ckpt")])
    n = sum(v.size for v in sd.values())
    assert capsys.readouterr().out == (f"wrote {out} ({n / 1e6:.1f}M "
                                       f"values)\n")
    direct = ingest_sam_pth(pth, standalone=True)
    payload = restore_checkpoint(out)
    assert payload["state_dict"].keys() == direct.keys()
    assert all(torch.equal(payload["state_dict"][k], direct[k])
               for k in direct)
    ImageEncoderViT(**ENC).load_state_dict(
        load_state_dict_file(f"file://{out}"), strict=True)


def test_convert_checkpoints_full(tmp_path, capsys,
                                  fake_deliver):  # noqa: F811
    m = get_config("deliver_tiny")["model"]
    sd = synth_state_dict(cfg=m["backbone"], head_ch=m["head_channels"],
                          ncls=m["num_classes"])
    ref = {}
    for k, v in sd.items():
        v = np.abs(v) + 0.5 if k.endswith("running_var") else v
        ref[k] = torch.from_numpy(np.asarray(v))
        if k.endswith("running_mean"):  # as torch writes a BatchNorm
            ref[k[:-len("running_mean")] + "num_batches_tracked"] = (
                torch.tensor(0))
    pth = tmp_path / "ref.pth"
    torch.save({"state_dict": ref, "meta": {}}, pth)
    out = convert_checkpoints.main(["full", str(pth), str(tmp_path / "c"),
                                    "--config", "deliver_tiny"])
    direct = build_segmentor(m, "cpu", state_dict=load_state_dict_file(
        str(pth))).state_dict()
    got = restore_checkpoint(out)["state_dict"]
    assert got.keys() == direct.keys()
    assert all(torch.equal(got[k], direct[k]) for k in direct)
    n = sum(v.numel() for v in direct.values())
    assert capsys.readouterr().out == f"wrote {out} ({n / 1e6:.1f}M values)\n"
    scores = []
    for i, ckpt in enumerate((str(pth), out)):
        path = test_entry.main([
            "deliver_tiny", ckpt, "--data-root", fake_deliver, "--device",
            "cpu", "--no-bf16", "--out-dir", str(tmp_path / f"eval{i}"),
            "--max-samples", "2"])
        payload = json.loads(Path(path).read_text())
        scores.append({k: payload[k] for k in ("mIoU", "aAcc", "mAcc")})
    assert scores[0] == scores[1]


@pytest.fixture
def one_thread():
    """One torch thread for the test (the train entry's tests' habit under
    xdist's workers), the process's count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_and_test_entries_on_port_written_synthetic_data(tmp_path,
                                                               one_thread):
    data = tmp_path / "synth"
    make_synth_deliver.write(str(data), n=2, seed=1)
    work = tmp_path / "work"
    with flops.WorkCounter() as wc:
        runner = train_entry.main([
            "deliver_tiny", "--data-root", str(data), "--work-dir",
            str(work), "--device", "cpu", "--max-epochs", "1", "--seed",
            "1", "--cfg-options", "log_config.interval=1"])
    assert runner.state.step == 4
    # the kernels' entries are called as chip_smoke.py's phase 15 predicts
    # their launches on the card: 4 micro-steps and 8 eval forwards
    assert {k: v["calls"] for k, v in wc.kernels.items()} == (
        chip_smoke.tools_launches(4, 1, 8))
    best = work / "ckpts" / "best.pth"
    assert best.exists()
    out = test_entry.main([
        "deliver_tiny", str(best), "--data-root", str(data), "--device",
        "cpu", "--no-bf16", "--out-dir", str(tmp_path / "eval")])
    payload = json.loads(Path(out).read_text())
    assert np.isfinite(payload["mIoU"]) and 0 <= payload["mIoU"] <= 100
