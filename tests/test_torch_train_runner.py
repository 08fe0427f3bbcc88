"""The port's training runner on the CPU at deliver_tiny: the optimizer
state across a resume (F4), checkpoints (engine/checkpoint.py), the epoch
runner's resume, and pretrained ingestion against the JAX package's.

F4: `LayerDecayAdamW` keeps its micro-batch count, its update count and a
running accumulation's gradients outside torch's optimizer state; its
`state_dict` must carry them, or a resumed run restarts the schedule and
Adam's bias correction and drops the gradients summed so far. Held here
bit-equal: micro-steps interrupted by a save and a load into a new model
and optimizer against the same micro-steps run straight. The module runs
torch on one thread: with several, the CPU's parallel reductions are not
bit-reproducible from run to run (two straight runs differ in the 7th
digit of the loss by the 5th micro-step), and under a parallel test run
one thread is also the faster.
"""
import io

import numpy as np
import pytest
import torch

from multimodal_sam_adapter_torch.configs.registry import get_config
from multimodal_sam_adapter_torch.engine import checkpoint as ck
from multimodal_sam_adapter_torch.engine.runner import (EarlyStopping,
                                                        TrainLogger)
from multimodal_sam_adapter_torch.engine.train import (init_train_state,
                                                       make_train_step)
from multimodal_sam_adapter_torch.models.segmentor import build_segmentor
from multimodal_sam_adapter_torch.utils import profiling

CFG = get_config("deliver_tiny")
MODEL = CFG["model"]
IDX = MODEL["backbone"]["interaction_indexes"]


def _batches(n, B=1, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        gt = rng.integers(0, MODEL["num_classes"], (B, 64, 64))
        gt[rng.random((B, 64, 64)) < 0.1] = 255
        out.append(dict(img=torch.from_numpy(
            rng.standard_normal((B, 64, 64, 6)).astype(np.float32)),
            gt=torch.from_numpy(gt)))
    return out


def _state(accum, seed=0):
    return init_train_state(MODEL, "cpu", seed=seed, optimizer_kwargs=dict(
        CFG["optimizer"], grad_accum_steps=accum, steps_per_epoch=2))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _assert_bit_equal(a, b):
    assert a.keys() == b.keys()
    for n in a:
        assert torch.equal(a[n], b[n]), n


# --------------------------------------------------------------------- F4

def test_optimizer_state_resumes_mid_accumulation():
    """3 micro-steps at grad_accum_steps 2 (one update, then one micro-batch
    accumulated), the model's and optimizer's state_dicts through a
    weights_only torch file into a new model and optimizer, 3 more: every
    parameter and loss bit-equal to 6 micro-steps run straight."""
    batches = _batches(6)
    straight = _state(2)
    step = make_train_step(straight.model, straight.optimizer)
    want = [step(straight, b)["loss"] for b in batches]

    first = _state(2)
    step = make_train_step(first.model, first.optimizer)
    got = [step(first, b)["loss"] for b in batches[:3]]
    buf = io.BytesIO()
    torch.save({"model": first.model.state_dict(),
                "optimizer": first.optimizer.state_dict()}, buf)
    buf.seek(0)
    saved = torch.load(buf, weights_only=True)

    second = _state(2, seed=1)             # other weights, then the load
    second.model.load_state_dict(saved["model"])
    second.optimizer.load_state_dict(saved["optimizer"])
    second.step, second.seed = first.step, first.seed   # the dropout keys
    step = make_train_step(second.model, second.optimizer)
    got += [step(second, b)["loss"] for b in batches[3:]]

    assert [x.item() for x in got] == [x.item() for x in want]
    _assert_bit_equal(_params(second.model), _params(straight.model))
    assert second.optimizer.updates == straight.optimizer.updates == 3


def test_optimizer_state_dict_carries_the_accumulation():
    state = _state(3)
    step = make_train_step(state.model, state.optimizer)
    for b in _batches(2):
        step(state, b)
    sd = state.optimizer.state_dict()
    assert sd["accum"]["mini_step"] == 2 and sd["accum"]["updates"] == 0
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    assert len(sd["accum"]["grads"]) == len(params)
    for p, g in zip(params, sd["accum"]["grads"]):
        assert g is not None and torch.equal(g, p.grad)
    # restored moments keep their dtypes: the first moment is bfloat16
    step(state, _batches(1, seed=3)[0])
    fresh = _state(3, seed=1)
    fresh.optimizer.load_state_dict(state.optimizer.state_dict())
    st = fresh.optimizer.state
    assert {v["mu"].dtype for v in st.values()} == {torch.bfloat16}
    assert {v["nu"].dtype for v in st.values()} == {torch.float32}
    assert fresh.optimizer.mini_step == 0 and fresh.optimizer.updates == 1
    assert all(p.grad is None for p in fresh.model.parameters())


# -------------------------------------------------------------- checkpoints

@pytest.fixture(scope="module")
def tiny_state():
    state = _state(1)
    step = make_train_step(state.model, state.optimizer)
    step(state, _batches(1)[0])
    return state


def test_checkpoints_prune_keep_best_and_find_latest(tiny_state, tmp_path):
    d = tmp_path / "ckpts"
    assert ck.latest_checkpoint(str(d)) is None
    s = tiny_state
    for n in (3, 10, 7):
        ck.save_checkpoint(str(d), s.model, s.optimizer, n, {"epoch": 0},
                           max_keep=2)
    best = ck.save_checkpoint(str(d), s.model, s.optimizer, 7, {}, tag="best")
    assert sorted(p.name for p in d.iterdir()) == [
        "best.pth", "step_10.pth", "step_7.pth"]
    assert ck.latest_checkpoint(str(d)) == str(d / "step_10.pth")
    assert best == str(d / "best.pth")
    ck.save_checkpoint(str(d), s.model, s.optimizer, 11, {}, max_keep=0)
    assert len(list(d.glob("step_*.pth"))) == 3


def test_checkpoint_reads_with_weights_only_and_in_the_test_entry(
        tiny_state, tmp_path):
    """The whole file loads with weights_only=True (meta of plain types),
    in the reference's mmcv form, and the test entry's reader gives the
    model's state_dict, which loads strictly into a new segmentor."""
    s = tiny_state
    meta = {"config_name": "deliver_tiny", "CLASSES": ["a", "b"],
            "PALETTE": [[1, 2, 3]], "seed": 0, "deterministic": False,
            "epoch": 1, "iter": 4}
    path = ck.save_checkpoint(str(tmp_path), s.model, s.optimizer, 4, meta)
    payload = torch.load(path, weights_only=True)
    assert set(payload) == {"meta", "state_dict", "optimizer"}
    assert payload["meta"] == dict(meta, step=4)
    assert ck.restore_checkpoint(path)["meta"]["step"] == 4
    sd = ck.load_state_dict_file(path)
    _assert_bit_equal(sd, s.model.state_dict())
    model = build_segmentor(MODEL, "cpu", state_dict=sd)
    _assert_bit_equal(model.state_dict(), s.model.state_dict())
    with pytest.raises(RuntimeError, match="not a train checkpoint"):
        torch.save({"state_dict": sd}, tmp_path / "bare.pth")
        ck.restore_checkpoint(str(tmp_path / "bare.pth"))


class RawSamples:
    """In-memory raw train samples (80 x 80 BGR + LiDAR, 0-255), as a
    dataset's __getitem__ returns them."""

    def __init__(self, n, seed=0):
        rng = np.random.default_rng(seed)
        self.samples = [dict(
            img=rng.uniform(0, 255, (80, 80, 6)).astype(np.float32),
            gt=rng.integers(0, MODEL["num_classes"], (80, 80)).astype(
                np.uint8), meta={"stem": f"s{i}"}) for i in range(n)]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def _runner(work, accum, seed=0, epochs=2):
    from multimodal_sam_adapter_torch.tools.train import build_runner

    cfg = get_config("deliver_tiny")
    cfg["data"] = dict(samples_per_gpu=1, grad_accum=accum)
    cfg["runner"]["max_epochs"] = epochs
    cfg["checkpoint"]["max_keep_ckpts"] = 3
    return build_runner(cfg, RawSamples(3), str(work), device="cpu",
                        seed=seed, bf16=False)


def test_runner_resume_mid_accumulation_is_bit_equal(tmp_path):
    """3 micro-batches an epoch, grad_accum 2: the accumulation that starts
    at epoch 0's last micro-batch ends in epoch 1. One epoch, a checkpoint,
    then a new runner that auto-resumes and runs epoch 1: parameters
    bit-equal to two epochs run straight."""
    straight = _runner(tmp_path / "a", 2)
    straight.run()
    first = _runner(tmp_path / "b", 2, epochs=1)
    first.run()
    assert first.state.optimizer.mini_step == 1
    second = _runner(tmp_path / "b", 2, seed=0)
    path = second.resume(auto=True)
    assert path.endswith("step_3.pth") and second.start_epoch == 1
    assert second.state.step == 3 and second.state.optimizer.mini_step == 1
    second.run()
    assert second.state.step == straight.state.step == 6
    _assert_bit_equal(_params(second.state.model), _params(straight.state.model))
    assert ck.latest_checkpoint(str(tmp_path / "b" / "ckpts")).endswith(
        "step_6.pth")


def test_runner_load_weights_keeps_a_fresh_optimizer(tiny_state, tmp_path):
    path = ck.save_checkpoint(str(tmp_path), tiny_state.model,
                              tiny_state.optimizer, 1, {})
    runner = _runner(tmp_path / "w", 1)
    assert runner.resume(None, auto=True) is None     # nothing there yet
    runner.load_weights(path)
    _assert_bit_equal(runner.state.model.state_dict(),
                      tiny_state.model.state_dict())
    assert runner.state.step == 0 and runner.state.optimizer.updates == 0
    assert not runner.state.optimizer.state


def test_early_stopping_and_logger(tmp_path):
    es = EarlyStopping(patience=2)
    assert [es.update({"mIoU": v}) for v in (1.0, 2.0, 2.0, 1.5)] == [
        False, False, False, True]
    assert not EarlyStopping().update({"aAcc": 1.0})
    log = TrainLogger(str(tmp_path), interval=3, tensorboard=False)

    class Lazy:
        reads = 0

        def __float__(self):
            Lazy.reads += 1
            return 0.5

    for step in range(1, 8):
        log.log_step(step, 0, {"loss": Lazy()})
    log.log_eval(0, {"mIoU": 1.5})
    log.close()
    lines = (tmp_path / "train_log.jsonl").read_text().splitlines()
    assert [eval(x).get("step") for x in lines] == [1, 3, 6, None]
    assert Lazy.reads == 3          # read only on the logged steps


def test_step_timer_annotate_and_trace(tmp_path):
    t = profiling.StepTimer(alpha=0.5)
    assert t.tick() is None and t.tick() >= 0
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("span_under_test"):
            torch.ones(4).sum()
    assert "span_under_test" in (tmp_path / "trace.json").read_text()


# ------------------------------------------------------- pretrained ingestion

@pytest.fixture(scope="module")
def zero_variables():
    """The JAX deliver_tiny variables' shapes as zero arrays, and the port's
    state_dict of the same zeros."""
    import jax
    import jax.numpy as jnp

    from multimodal_sam_adapter_torch.engine.convert import state_dict_from_jax
    from multimodal_sam_adapter_tpu.models.segmentor import EncoderDecoder

    jm = EncoderDecoder(num_classes=MODEL["num_classes"],
                        head_channels=MODEL["head_channels"],
                        backbone_cfg=MODEL["backbone"])
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 6)), train=False))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    return zeros, state_dict_from_jax(zeros, IDX)


def _synthetic(port_sd, prefix, rename, extra, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in port_sd.items():
        if k.startswith(prefix) and (name := rename(k[len(prefix):])):
            out[name] = torch.from_numpy(
                rng.standard_normal(tuple(v.shape)).astype(np.float32))
    out.update(extra)
    return out


def test_pretrained_ingestion_equals_jax(zero_variables, tmp_path):
    """A SAM-layout .pth (the whole SAM: image_encoder.*, neck, prompt
    encoder) and an mmpretrain ConvNeXt .pth (backbone.*, head, final
    norm) at deliver_tiny's widths: JAX ingest_* + merge_pretrained +
    state_dict_from_jax equal to the port's ingestion and merge."""
    from multimodal_sam_adapter_torch.engine.convert import state_dict_from_jax
    from multimodal_sam_adapter_tpu.engine import checkpoint as jck

    zeros, port_zero = zero_variables
    sam = _synthetic(
        port_zero, "backbone.",
        lambda k: None if k.startswith(("spm.", "interactions", "level",
                                        "up.", "norm")) else
        f"image_encoder.{k}",
        {"image_encoder.neck.0.weight": torch.ones(4, 32, 1, 1),
         "prompt_encoder.pe": torch.ones(3)}, 0)
    cnx = _synthetic(
        port_zero, "backbone.spm.twin_conv.",
        lambda k: ("backbone." + k.replace("downsample_layers_x",
                                           "downsample_layers")
                   .replace("stages_x", "stages").replace("norm_x", "norm"))
        if "_x" in k else None,
        {"backbone.head.fc.weight": torch.ones(10, 320),
         "backbone.norm.weight": torch.ones(320)}, 1)
    torch.save({"state_dict": sam}, tmp_path / "sam.pth")
    torch.save({"meta": {"epoch": 300}, "state_dict": cnx},
               tmp_path / "convnext.pth")

    params = dict(zeros["params"])
    params["backbone"] = jck.merge_pretrained(
        params["backbone"], jck.ingest_sam_pth(str(tmp_path / "sam.pth"), IDX))
    params["backbone"]["spm"]["twin_conv"] = jck.merge_pretrained(
        params["backbone"]["spm"]["twin_conv"],
        jck.ingest_convnext_pth(str(tmp_path / "convnext.pth")))
    want = state_dict_from_jax({"params": params,
                                "batch_stats": zeros["batch_stats"]}, IDX)

    pre = ck.ingest_sam_pth(str(tmp_path / "sam.pth"), IDX)
    pre.update(ck.ingest_convnext_pth(str(tmp_path / "convnext.pth")))
    got = ck.merge_pretrained(port_zero, pre)
    _assert_bit_equal(got, want)
    n_sam = sum(k.startswith("image_encoder.blocks") for k in sam)
    assert n_sam == 4 * 14 and len(pre) == 3 + n_sam + 2 * (len(cnx) - 2)
    changed = [k for k in got if not torch.equal(got[k], port_zero[k])]
    assert sorted(changed) == sorted(pre)


def test_ingestion_refuses_unknown_keys_and_shapes(zero_variables, tmp_path):
    _, port_zero = zero_variables
    torch.save({"image_encoder.blocks.0.attn.foo": torch.ones(1)},
               tmp_path / "a.pth")
    with pytest.raises(KeyError, match="unmapped ViT block key"):
        ck.ingest_sam_pth(str(tmp_path / "a.pth"), IDX)
    torch.save({"blocks.9.norm1.weight": torch.ones(32)}, tmp_path / "b.pth")
    with pytest.raises(ValueError, match="not covered"):
        ck.ingest_sam_pth(str(tmp_path / "b.pth"), IDX)
    torch.save({"stem.weight": torch.ones(1)}, tmp_path / "c.pth")
    with pytest.raises(KeyError, match="unmapped ConvNeXt key"):
        ck.ingest_convnext_pth(str(tmp_path / "c.pth"))
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.merge_pretrained(port_zero, {"backbone.pos_embed": torch.ones(3)})
    with pytest.raises(KeyError, match="not in model"):
        ck.merge_pretrained(port_zero, {"backbone.nope": torch.ones(3)})
