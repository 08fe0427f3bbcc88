"""The port's train entry (tools/train.py) on the CPU at deliver_tiny,
against the JAX package's train path, and its parameter init against the
JAX package's.

- The init (models/init.py): the JAX package's own initial variables for
  deliver_tiny, through the weight bridge, against the port's
  `init_weights_`: every parameter covered by a rule; constants (zeros,
  ones, layer scales, the injectors' gamma, the MSDA offset bias) exactly
  equal; drawn tensors of 4096 or more elements within 10% of the JAX
  tensor's standard deviation, smaller ones pooled by rule; truncated draws
  inside their bounds in both packages.
- The slice: the port's `tools.train` (fake DELIVER on disk, float32,
  dropout and drop path 0 through --cfg-options, the initial weights
  through --load-from) against the JAX package's DataLoader,
  TrainPipeline, init_train_state, make_train_step and EpochRunner on the
  same data and seed (the JAX pipeline resizing with the port's bilinear
  resize, so that both train on the same images; the two resizes are
  compared in tests/test_torch_train_data.py), 4 micro-steps: each loss
  within rtol 1e-4. From seeded N(0, 0.05) weights every parameter is
  within 1e-4 + 1e-3 |p| after the last update (largest difference
  5.2e-6). From the JAX package's own initial weights, whose zero gates
  leave some first gradients at round-off level, at most 0.5% of the
  elements are beyond that (0.28%) and all within two Adam steps.
- The entry end to end: the same run's checkpoints, an auto-resume for a
  third epoch, and `tools.test` on `best.pth`.
"""
import json
import os
import re

import numpy as np
import pytest
import torch

from multimodal_sam_adapter_torch.configs.registry import get_config
from multimodal_sam_adapter_torch.engine.checkpoint import restore_checkpoint
from multimodal_sam_adapter_torch.engine.convert import state_dict_from_jax
from multimodal_sam_adapter_torch.models.init import init_table
from multimodal_sam_adapter_torch.models.segmentor import build_segmentor
from multimodal_sam_adapter_torch.tools import test as test_entry
from multimodal_sam_adapter_torch.tools import train as train_entry
from tests._torch_parity import randomize
from tests.test_torch_evaluator import fake_deliver  # noqa: F401 (fixture)

SEED = 3
NO_DROP = {"model.backbone.drop_path_rate": 0.0,
           "model.backbone.conv_drop_path_rate": 0.0,
           "model.backbone.drop_rate": 0.0, "model.dropout_ratio": 0.0,
           "log_config.interval": 1}
IDX = get_config("deliver_tiny")["model"]["backbone"]["interaction_indexes"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread: under a parallel test run, faster than
    threads that contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _losses(work):
    with open(os.path.join(work, "train_log.jsonl")) as f:
        recs = [json.loads(x) for x in f]
    return [(r["step"], r["loss"]) for r in recs if "loss" in r]


@pytest.fixture(scope="module")
def jax_run(fake_deliver, tmp_path_factory):  # noqa: F811
    """The JAX package's train path, float32, 2 epochs (4 micro-steps),
    twice with one jitted step: from its own initial variables, and from
    seeded N(0, 0.05) variables (tests/_torch_parity.py:randomize). Each
    run's initial variables and final parameters (through the weight
    bridge) and its per-step losses."""
    import jax

    import multimodal_sam_adapter_torch.data.pipelines as tpipelines
    import multimodal_sam_adapter_tpu.data.pipelines as jpipelines
    from multimodal_sam_adapter_tpu.configs.registry import (
        apply_overrides, get_config as jax_config)
    from multimodal_sam_adapter_tpu.data import DataLoader, build_dataset
    from multimodal_sam_adapter_tpu.engine.runner import EpochRunner
    from multimodal_sam_adapter_tpu.engine.train import (init_train_state,
                                                         make_train_step)
    from multimodal_sam_adapter_tpu.models.segmentor import EncoderDecoder

    cfg = jax_config("deliver_tiny")
    apply_overrides(cfg, {k: str(v) for k, v in NO_DROP.items()})
    ds = build_dataset(cfg["dataset"], fake_deliver)
    loader = DataLoader(ds, jpipelines.TrainPipeline(
        cfg["train_pipeline"], cfg["dataset"]["modalities_ch"]),
        batch_size=cfg["data"]["samples_per_gpu"], shuffle=True, seed=SEED)
    m = cfg["model"]
    model = EncoderDecoder(num_classes=m["num_classes"],
                           head_channels=m["head_channels"],
                           dropout_ratio=m["dropout_ratio"],
                           backbone_cfg=m["backbone"])
    opt = dict(cfg["optimizer"], steps_per_epoch=len(loader),
               grad_accum_steps=cfg["data"]["grad_accum"])
    state = init_train_state(model, (1, 64, 64, 6), jax.random.PRNGKey(SEED),
                             optimizer_kwargs=opt)
    to_np = lambda t: jax.tree.map(np.asarray, jax.device_get(t))  # noqa
    variables = {"params": to_np(state.params),
                 "batch_stats": to_np(state.batch_stats)}
    step = make_train_step(model)
    runs = {}
    for name, v in (("jax_init", variables),
                    ("random", randomize(variables, SEED))):
        work = str(tmp_path_factory.mktemp(f"jax_{name}"))
        runner = EpochRunner(
            state.replace(step=np.asarray(0, np.int32), params=v["params"],
                          batch_stats=v["batch_stats"],
                          opt_state=state.tx.init(v["params"])),
            step, loader, work, max_epochs=cfg["runner"]["max_epochs"],
            ckpt_interval=1000, log_interval=1,
            rng=jax.random.PRNGKey(SEED + 1))
        with pytest.MonkeyPatch.context() as mp:
            # the port's bilinear resize in the JAX pipeline: both
            # packages then train on the same images
            mp.setattr(jpipelines, "_resize_multichannel",
                       lambda img, wh, interpolation="bilinear":
                       tpipelines.resize_bilinear_hwc(img, wh))
            final = runner.run()
        runs[name] = dict(
            initial=state_dict_from_jax(v, IDX), losses=_losses(work),
            final=state_dict_from_jax(
                {"params": to_np(final.params),
                 "batch_stats": to_np(final.batch_stats)}, IDX))
    return runs


def _port_train(jax_run, name, fake_deliver, tmp_path_factory):  # noqa: F811
    """tools.train on the same data from the JAX run's initial weights
    (--load-from), float32, no dropout."""
    d = tmp_path_factory.mktemp(f"port_{name}")
    init = str(d / "init.pth")
    torch.save({"state_dict": jax_run[name]["initial"]}, init)
    work = str(d / "work")
    runner = train_entry.main(
        ["deliver_tiny", "--data-root", fake_deliver, "--work-dir", work,
         "--device", "cpu", "--no-bf16", "--seed", str(SEED),
         "--max-epochs", "2", "--load-from", init, "--cfg-options",
         *[f"{k}={v}" for k, v in NO_DROP.items()]])
    return dict(work=work, runner=runner, losses=_losses(work))


@pytest.fixture(scope="module")
def port_run(jax_run, fake_deliver, tmp_path_factory):  # noqa: F811
    return _port_train(jax_run, "jax_init", fake_deliver, tmp_path_factory)


# ------------------------------------------------------------------- init

def test_init_matches_the_jax_init(jax_run):
    cfg = get_config("deliver_tiny")["model"]
    model = build_segmentor(cfg, "cpu", generator=torch.Generator()
                            .manual_seed(0), init="jax")
    table = init_table(model, cfg["backbone"])
    want = jax_run["jax_init"]["initial"]
    names = [n for n, _ in model.named_parameters()]
    assert sorted(table) == sorted(names)          # every parameter covered
    pooled = {}
    n_const = n_drawn = 0
    for n, p in model.named_parameters():
        got, ref, rule = p.detach().numpy(), want[n].numpy(), table[n]
        assert got.shape == ref.shape, n
        if rule.kind in ("const", "msda_bias"):
            np.testing.assert_array_equal(got, ref, err_msg=n)
            n_const += 1
            continue
        n_drawn += 1
        assert rule.kind in ("normal", "trunc_normal"), (n, rule)
        assert np.abs(got).max() <= rule.bound, n
        assert np.abs(ref).max() <= rule.bound * (1 + 1e-6), n
        if ref.size >= 4096:
            assert abs(got.std() / ref.std() - 1) < 0.1, (n, got.std(),
                                                           ref.std())
        key = (re.sub(r"\d+", "N", n), rule.kind)
        pooled.setdefault(key, [[], []])
        pooled[key][0].append(got.ravel() / rule.std)
        pooled[key][1].append(ref.ravel() / rule.std)
    for key, (got, ref) in pooled.items():
        got, ref = np.concatenate(got), np.concatenate(ref)
        tol = 0.1 if ref.size >= 1024 else 0.25
        # the JAX draws have the rule's std, and so do the port's
        assert abs(ref.std() - 1) < tol and abs(got.std() - 1) < tol, (
            key, ref.size, ref.std(), got.std())
    assert n_const > 300 and n_drawn > 200
    for name, buf in model.named_buffers():
        if name.endswith("running_var"):
            assert torch.equal(buf, torch.ones_like(buf)), name
        elif name.endswith(("running_mean", "num_batches_tracked")):
            assert not buf.any(), name


# ------------------------------------------------------------------ slice

def _compare(jax_side, port_side):
    """Losses within rtol 1e-4; per parameter element |port - jax| against
    1e-4 + 1e-3 |jax|. Returns (elements beyond, elements, tensors with
    elements beyond, the largest difference, the port's runner)."""
    want, got = jax_side["losses"], port_side["losses"]
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 2, 3, 4]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=1e-4)
    runner = port_side["runner"]
    model = runner.state.model
    beyond, total, worst, tensors = 0, 0, 0.0, []
    for n, p in model.named_parameters():
        ref = jax_side["final"][n]
        err = (p.detach() - ref).abs()
        out = err > 1e-4 + 1e-3 * ref.abs()
        beyond += int(out.sum())
        total += err.numel()
        worst = max(worst, float(err.max()))
        if out.any():
            tensors.append(n)
    # the training moved the weights off the initial ones
    assert not torch.equal(model.get_parameter("decode_head.conv_seg.weight"),
                           jax_side["initial"]["decode_head.conv_seg.weight"])
    return beyond, total, tensors, worst, runner


def test_train_entry_matches_the_jax_train_path(jax_run, fake_deliver,  # noqa: F811
                                                tmp_path_factory):
    """From seeded N(0, 0.05) weights, where every gradient carries signal:
    every parameter element within 1e-4 + 1e-3 |p| after the 4th update."""
    port = _port_train(jax_run, "random", fake_deliver, tmp_path_factory)
    beyond, total, tensors, worst, _ = _compare(jax_run["random"], port)
    print(f"random init: largest parameter difference {worst:.3g}")
    assert beyond == 0, tensors


def test_train_entry_from_the_jax_init_matches_the_jax_train_path(
        jax_run, port_run):
    """From the JAX package's own initial weights. Its zero gates (the
    neck's fuse and local-encoder scales, MSDA's zero kernels) leave some
    first gradients at round-off level, about 1e-11 (the two packages'
    signs agree on half their elements), and Adam turns each into a full
    step of either sign: there the parameters part by up to two Adam
    steps. Every element within that, and at most 0.5% of the elements
    beyond 1e-4 + 1e-3 |p| (0.28% measured, in 24 of 699 tensors)."""
    beyond, total, tensors, worst, runner = _compare(jax_run["jax_init"],
                                                     port_run)
    opt = runner.state.optimizer
    budget = 2 * sum(opt.schedule(t) for t in range(opt.updates))
    print(f"JAX init: {beyond} of {total} elements beyond 1e-4 + 1e-3|p|, "
          f"in {len(tensors)} tensors; largest difference {worst:.3g}, "
          f"two Adam steps' budget {budget:.3g}")
    assert worst <= 1.01 * budget
    assert beyond <= 5e-3 * total, (beyond, total, tensors)


def test_train_entry_checkpoints_resume_and_test(port_run, fake_deliver,  # noqa: F811
                                                 tmp_path, capsys):
    work = port_run["work"]
    ckpts = sorted(os.listdir(os.path.join(work, "ckpts")))
    assert ckpts == ["best.pth", "step_4.pth"]
    payload = restore_checkpoint(os.path.join(work, "ckpts", "step_4.pth"))
    meta = payload["meta"]
    assert (meta["config_name"], meta["epoch"], meta["step"], meta["seed"]) \
        == ("deliver_tiny", 1, 4, SEED)
    assert len(meta["CLASSES"]) == meta["config"]["model"]["num_classes"]
    assert payload["optimizer"]["accum"] == {"mini_step": 0, "updates": 4}
    evals = [json.loads(x) for x in open(os.path.join(work,
                                                      "train_log.jsonl"))
             if '"eval"' in x]
    assert len(evals) == 2 and "mIoU" in evals[0]["eval"]

    runner = train_entry.main(
        ["deliver_tiny", "--data-root", fake_deliver, "--work-dir", work,
         "--device", "cpu", "--no-bf16", "--seed", str(SEED),
         "--max-epochs", "3", "--auto-resume", "--cfg-options",
         "log_config.interval=1"])
    assert "resumed from" in capsys.readouterr().out
    assert runner.state.step == 6 and runner.state.optimizer.updates == 6
    assert [s for s, _ in _losses(work)][-2:] == [5, 6]
    assert "step_6.pth" in os.listdir(os.path.join(work, "ckpts"))

    out = test_entry.main(["deliver_tiny",
                           os.path.join(work, "ckpts", "best.pth"),
                           "--data-root", fake_deliver, "--device", "cpu",
                           "--no-bf16", "--out-dir", str(tmp_path)])
    with open(out) as f:
        assert np.isfinite(json.load(f)["mIoU"])


def test_train_entry_refuses_cuda_without_a_card(fake_deliver, tmp_path):  # noqa: F811
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA card"):
        train_entry.main(["deliver_tiny", "--data-root", fake_deliver,
                          "--work-dir", str(tmp_path)])
