"""The port's phase spans (utils/profiling.py:annotate) on the CPU at
deliver_tiny: under a torch.profiler, `InferenceEngine.predict` in
'whole_dim' and in 'slide', a micro-step of `make_train_step` that only
accumulates and one that updates, and the epoch runner each emit their
`msa.*` spans with these names, this nesting and this order; with no
profiler running, none of them constructs a `record_function`."""
import json

import numpy as np
import pytest
import torch

from multimodal_sam_adapter_torch.configs.registry import get_config
from multimodal_sam_adapter_torch.engine.inference import InferenceEngine
from multimodal_sam_adapter_torch.engine.runner import EpochRunner
from multimodal_sam_adapter_torch.engine.train import (init_train_state,
                                                       make_train_step)
from multimodal_sam_adapter_torch.models.segmentor import build_segmentor
from tests._torch_parity import one_thread

one_thread()

CFG = get_config("deliver_tiny")
MODEL = CFG["model"]
POST = ("msa.predict.post", "msa.predict")
PREDICT = {
    "whole_dim": [("msa.predict", None), ("msa.predict.h2d", "msa.predict"),
                  ("msa.predict.forward", "msa.predict"), POST, POST, POST,
                  ("msa.predict.d2h", "msa.predict")],
    # slide: the window stack, the scatter-add, the valid-band crop, the
    # softmax and the argmax
    "slide": [("msa.predict", None), ("msa.predict.stage", "msa.predict"),
              ("msa.predict.h2d", "msa.predict"),
              ("msa.predict.forward", "msa.predict"), POST, POST, POST, POST,
              ("msa.predict.d2h", "msa.predict")],
}
STEP = [("msa.train_step", None),
        ("msa.train_step.forward", "msa.train_step"),
        ("msa.train_step.backward", "msa.train_step"),
        ("msa.train_step.update", "msa.train_step")]


def traced_spans(fn, tmp_path):
    """(name, parent's name) of every `msa.*` span that `fn()` emits under
    a CPU torch.profiler, in the order they open, read from the exported
    Chrome trace; the parent is the innermost `msa.*` span around it."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted((float(e["ts"]), -float(e["dur"]), e["name"])
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"
                   and e["name"].startswith("msa."))
    out, stack = [], []
    for ts, neg_dur, name in spans:
        while stack and stack[-1][1] <= ts:
            stack.pop()
        out.append((name, stack[-1][0] if stack else None))
        stack.append((name, ts - neg_dur))
    return out


@pytest.fixture(scope="module")
def model():
    g = torch.Generator().manual_seed(0)
    return build_segmentor(MODEL, "cpu", generator=g)


def _engine(model, mode):
    test_cfg = (CFG["test_cfg"] if mode == "whole_dim" else
                get_config("muses_tiny")["test_cfg"])
    assert test_cfg["mode"] == mode
    return InferenceEngine(model, test_cfg)


@pytest.mark.parametrize("mode, hw", [("whole_dim", (64, 64)),
                                      ("slide", (64, 96))])
def test_predict_emits_its_phases(model, mode, hw, tmp_path):
    engine = _engine(model, mode)
    img = torch.randn((1,) + hw + (6,), generator=torch.Generator()
                      .manual_seed(1))
    got = traced_spans(lambda: engine.predict(img), tmp_path)
    assert got == PREDICT[mode]


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(0)
    return [dict(img=rng.standard_normal((1, 64, 64, 6)).astype(np.float32),
                 gt=rng.integers(0, MODEL["num_classes"], (1, 64, 64)))
            for _ in range(2)]


def _train_state():
    return init_train_state(MODEL, "cpu", seed=0, optimizer_kwargs=dict(
        CFG["optimizer"], grad_accum_steps=2, steps_per_epoch=1))


def test_micro_steps_emit_forward_backward_update(batches, tmp_path):
    """The update span is there on every micro-step: the first of an
    accumulation of two only counts, the second updates."""
    state = _train_state()
    step = make_train_step(state.model, state.optimizer)
    for updates, batch in zip((False, True), batches):
        t = {k: torch.from_numpy(v) for k, v in batch.items()}
        outs = []
        got = traced_spans(lambda: outs.append(step(state, t)), tmp_path)
        assert outs[0]["updated"] is updates
        assert got == STEP


class _Loader:
    def __init__(self, batches):
        self.batches = batches

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def test_the_runner_emits_data_checkpoint_and_eval(batches, tmp_path):
    """One epoch of one batch: the batch's `msa.data`, the step's own
    `msa.train_step` (the runner opens no span of its own around it), the
    epoch's checkpoint and evaluation, and the best checkpoint inside
    nothing."""
    state = _train_state()
    runner = EpochRunner(state, make_train_step(state.model, state.optimizer),
                         _Loader(batches[:1]), str(tmp_path / "work"),
                         max_epochs=1, eval_fn=lambda s: {"mIoU": 1.0},
                         log_interval=1)
    got = traced_spans(runner.run, tmp_path)
    assert got == ([("msa.data", None)] + STEP
                   + [("msa.data", None), ("msa.checkpoint", None),
                      ("msa.eval", None), ("msa.checkpoint", None)])


def test_no_span_is_constructed_without_a_profiler(model, batches,
                                                   monkeypatch):
    def refuse(name, *args):
        raise AssertionError(f"record_function({name!r}) constructed")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    for mode, hw in (("whole_dim", (64, 64)), ("slide", (64, 96))):
        out = _engine(model, mode).predict(torch.zeros((1,) + hw + (6,)))
        assert out.shape == (1,) + hw
    state = _train_state()
    step = make_train_step(state.model, state.optimizer)
    step(state, {k: torch.from_numpy(v) for k, v in batches[0].items()})
    assert state.step == 1
