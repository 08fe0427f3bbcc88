"""A run of each kind of cell with the timed path broken underneath must
come out not correct; a sound run must come out correct. The runs skip
the look for a card and drive the rest of a run on the CPU at
deliver_tiny's sizes (float32), judged against each cell's limits as
committed."""
from __future__ import annotations

import re

import pytest
import torch

from port_bench import harness
from port_bench.tests.bench_tiny import tiny_loaded

SEED = 2 ** 31 + 11
PREDICT = [("deliver_serve", "whole_dim"), ("deliver_eval_b4", "whole_dim"),
           ("muses3_slide", "slide")]


def run(workload, mode):
    return harness.run(workload, SEED, 0.5, False, "cpu",
                       tiny_loaded(workload, mode))["result"]


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload,mode", PREDICT + [("deliver_train",
                                                      "whole_dim")])
def test_sound_run_is_correct(workload, mode):
    out = run(workload, mode)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("workload,mode", PREDICT)
def test_an_answer_altered_is_caught(workload, mode, monkeypatch):
    from multimodal_sam_adapter_torch.engine.inference import InferenceEngine

    predict = InferenceEngine.predict

    def altered(self, img, *a, **k):
        out = predict(self, img, *a, **k)
        rows = out.shape[1] // 4
        out[:, :rows] = (out[:, :rows] + 1) % self.model.num_classes
        return out

    monkeypatch.setattr(InferenceEngine, "predict", altered)
    assert not run(workload, mode)["correct"]


def test_half_the_batch_left_out_is_caught(monkeypatch):
    from multimodal_sam_adapter_torch.engine.inference import InferenceEngine

    predict = InferenceEngine.predict

    def half(self, img, *a, **k):
        out = predict(self, img[: img.shape[0] // 2], *a, **k)
        return torch.cat([out, out])

    monkeypatch.setattr(InferenceEngine, "predict", half)
    assert not run("deliver_eval_b4", "whole_dim")["correct"]


def test_a_step_that_leaves_the_state_unchanged_is_caught(monkeypatch):
    from multimodal_sam_adapter_torch.engine.optim import LayerDecayAdamW

    def unchanged(self):
        self.updates += 1
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p]["nu"] = (p.grad.float() / self.grad_accum_steps
                                       ) ** 2 * (1 - self.betas[1])
                p.grad = None

    monkeypatch.setattr(LayerDecayAdamW, "_update", unchanged)
    out = run("deliver_train", "whole_dim")
    assert not out["correct"]
    assert out["checks"]["change_gap_median"]["value"] > 0.9


def test_a_layer_decay_off_by_one_is_caught(monkeypatch):
    """The ViT blocks' learning-rate scale one layer off (times the decay
    rate once more): a fault of one group of leaves, a tenth of their
    change."""
    from multimodal_sam_adapter_torch.engine import optim

    scales = optim.layer_decay_scales
    block = re.compile(r"(?:^|\.)blocks\.\d+\.")

    def off_by_one(named, num_layers, rate):
        return {n: s * rate if block.search(n) else s
                for n, s in scales(named, num_layers, rate).items()}

    monkeypatch.setattr(optim, "layer_decay_scales", off_by_one)
    assert not run("deliver_train", "whole_dim")["correct"]
