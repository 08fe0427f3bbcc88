"""The port's entries on data-parallel ranks, on the CPU: two gloo ranks
on localhost at deliver_tiny (tests/_torch_ddp_worker.py), torch on one
thread.

- the evaluator: each rank scores its shard of 5 samples; the histograms
  summed over the ranks (flat and condition x case) equal one process's
  on all 5 exactly, as do the summaries, and equal the sum of the ranks'
  own;
- `tools/test.py` under torchrun's environment: rank 0 alone writes the
  result file, equal to the one-process run's;
- the runner (`tools/train.py:build_runner`): 6 raw samples through the
  train pipeline, 3 a rank an epoch, grad_accum 2, 2 epochs with a
  checkpoint and an eval each. Rank 0 alone writes checkpoints and the
  log; both ranks see the same eval summaries and end with the same
  weights; the epoch-0 checkpoint is taken partway through an
  accumulation (the ranks' summed gradients replaced by their mean on
  both, engine/runner.py), and a new runner on each rank that resumes from
  it ends epoch 1 with weights and BatchNorm statistics equal, bit for
  bit, to the run that saved it;
- `tools/train.py` on 2 ranks over an odd-sized train split (3 samples,
  one a micro-batch): each rank's loader shard is cut to the same number
  of batches, so both ranks take one step, checkpoint and evaluate, and
  neither waits for a collective the other never calls;
- two processes building the host core at once into one build directory
  (pid-tagged objects, an atomic rename) both load a working library.
"""
import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from tests import _torch_ddp_worker as w
from tests.test_torch_evaluator import fake_deliver  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_evaluator_sums_the_ranks_histograms(tmp_path):
    ranks = w.spawn("eval", tmp_path)
    want = w.evaluate(w.EvalSamples(5))
    for r in ranks:
        for key in ("flat", "nested"):
            np.testing.assert_array_equal(r["payload"][key],
                                          want["payload"][key])
            np.testing.assert_array_equal(
                ranks[0]["rank_payload"][key] + ranks[1]["rank_payload"][key],
                r["payload"][key])
        assert r["summary"] == want["summary"]
    # rank 0 scored samples 0, 2, 4 and rank 1 samples 1, 3
    pixels = [r["rank_payload"]["flat"][3].sum() for r in ranks]
    assert pixels[0] > pixels[1] > 0


def test_test_entry_on_two_ranks_writes_the_one_process_file(
        fake_deliver, tmp_path):  # noqa: F811
    from multimodal_sam_adapter_torch.tools import test as entry

    args = ["deliver_tiny", "random", "--data-root", fake_deliver,
            "--device", "cpu", "--no-bf16"]
    one = entry.main(args + ["--out-dir", str(tmp_path)])
    out = tmp_path / "ranks"
    out.mkdir()
    logs = w.run_ranks([sys.executable, "-m",
                        "multimodal_sam_adapter_torch.tools.test", *args,
                        "--out-dir", str(out), "--dist-backend", "gloo"])
    (written,) = os.listdir(out)
    assert "wrote" in logs[0] and "wrote" not in logs[1]
    with open(one) as f:
        want = json.load(f)
    with open(out / written) as f:
        got = json.load(f)
    for key in ("mIoU", "aAcc", "mAcc", "eval_results"):
        assert got[key] == want[key], key


def test_runner_on_two_ranks_resumes_bit_equal(tmp_path):
    ranks = w.spawn("runner", tmp_path / "out", tmp_path / "work")
    straight = tmp_path / "work" / "straight"
    assert sorted(os.listdir(straight / "ckpts")) == [
        "best.pth", "step_3.pth", "step_6.pth"]
    assert sorted(os.listdir(tmp_path / "work" / "resumed" / "ckpts")) == [
        "best.pth", "step_6.pth"]
    with open(straight / "train_log.jsonl") as f:
        records = [json.loads(line) for line in f]
    # one record a logged step and an eval an epoch, from rank 0 alone
    assert [r["step"] for r in records if "step" in r] == list(range(1, 7))
    assert [r["epoch"] for r in records if "eval" in r] == [0, 1]
    assert '"step": 1' in ranks[0]["log"]
    assert '"step"' not in ranks[1]["log"]
    a, b = ranks
    assert a["updates"] == b["updates"] == (3, 3)
    assert a["start_epoch"] == b["start_epoch"] == 1
    # the same eval summaries on both ranks: straight epochs 0, 1, resumed 1
    assert len(a["summaries"]) == 3 and a["summaries"] == b["summaries"]
    # a checkpoint partway through an accumulation holds the ranks' mean
    saved_opt = a["saved"][1]
    assert saved_opt["accum"]["mini_step"] == 1
    assert all(g is not None for g in saved_opt["accum"]["grads"])
    for r in ranks:
        for n, t in r["saved"][0].items():          # what was saved ...
            assert torch.equal(t, r["restored"][0][n]), n   # ... restored
        for g, h in zip(r["saved"][1]["accum"]["grads"],
                        r["restored"][1]["accum"]["grads"]):
            assert torch.equal(g, h)
        for n, t in a["straight"].items():
            assert torch.equal(r["straight"][n], t), n
            assert torch.equal(r["resumed"][n], t), n
    moved = [n for n, t in a["straight"].items()
             if n.endswith("running_var")
             and not torch.equal(t, a["saved"][0][n])]
    assert moved


@pytest.fixture(scope="module")
def odd_deliver(tmp_path_factory):
    """fake_deliver's layout with an odd-sized train split: 3 training and
    2 validation samples of 80x80."""
    root = tmp_path_factory.mktemp("odd_deliver")
    rng = np.random.default_rng(1)
    for split, n in (("training", 3), ("validation", 2)):
        for d in ("images", "annotations", "lidar"):
            os.makedirs(root / "samples" / d / split, exist_ok=True)
        for i in range(n):
            stem = f"{('sun', 'rain')[i % 2]}_{split}_{i}"
            for d, suffix, img in (
                    ("images", "rgb", rng.integers(0, 255, (80, 80, 3))),
                    ("lidar", "lidar", rng.integers(0, 255, (80, 80, 3))),
                    ("annotations", "semantic",
                     rng.integers(0, 25, (80, 80)))):
                cv2.imwrite(str(root / "samples" / d / split /
                                f"{stem}_{suffix}_front.png"),
                            img.astype(np.uint8))
    return str(root)


def test_train_entry_on_two_ranks_with_an_odd_split(odd_deliver, tmp_path):
    work = tmp_path / "work"
    logs = w.run_ranks([
        sys.executable, "-m", "multimodal_sam_adapter_torch.tools.train",
        "deliver_tiny", "--data-root", odd_deliver, "--work-dir", str(work),
        "--device", "cpu", "--no-bf16", "--max-epochs", "1",
        "--dist-backend", "gloo", "--cfg-options", "data.samples_per_gpu=1",
        "data.grad_accum=1", "log_config.interval=1"])
    with open(work / "train_log.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records if "step" in r] == [1]
    assert [r["epoch"] for r in records if "eval" in r] == [0]
    assert sorted(os.listdir(work / "ckpts")) == ["best.pth", "step_1.pth"]
    assert '"step": 1' in logs[0] and '"step"' not in logs[1]


def test_two_processes_build_the_host_core_at_once(tmp_path):
    code = (
        "import sys; from pathlib import Path; import numpy as np; "
        "from multimodal_sam_adapter_torch.data import native; "
        "native.BUILD_ROOT = Path(sys.argv[1]); "
        "img = np.arange(4 * 5 * 6, dtype=np.float32).reshape(4, 5, 6); "
        "out = native.normalize_pad_native(img, (3, 3), [(1, 2, 3), "
        "(0, 0, 0)], [(2, 2, 2), (1, 1, 1)], (True, False), (True, False), "
        "(6, 8)); "
        "ref = native.normalize_pad_numpy(img, (3, 3), [(1, 2, 3), "
        "(0, 0, 0)], [(2, 2, 2), (1, 1, 1)], (True, False), (True, False), "
        "(6, 8)); "
        "assert np.array_equal(out, ref); print('ok')")
    env = dict(os.environ, PYTHONPATH=str(w.ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0 and out.strip().endswith("ok"), out
    (build,) = os.listdir(tmp_path)
    assert os.listdir(tmp_path / build) == ["libmsa_pipeline.so"]
