"""Ranks for the port's data-parallel CPU tests (tests/test_torch_ddp*.py).

`spawn(task, out_dir, ...)` starts `world` processes of this file over a
gloo process group on localhost, each with torchrun's environment (RANK,
WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT on a
free port) and one torch thread, waits for them within a time limit of
its own (then kills them and fails), and returns each rank's results, the
dict the task saved to `<out_dir>/rank<r>.pt`, with its output under
"log". The tasks build their inputs from seeds, and the tests build the
single-process references from the same functions, so every rank holds
rows rank x B ... of the reference's global batch.

A task returns only what its test reads: a tensor that a test compares
bit for bit with another comes back as its `digest` (dtype, shape and a
hash of its bytes), and only the tensors a tolerance check reads come
back whole, so a spawn writes megabytes, not the model-sized states of
every run.

The file imports torch and the port only, never JAX.
"""
import hashlib
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> dict:
    env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
               LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
               MASTER_ADDR="localhost", MASTER_PORT=str(port),
               OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    env.pop("XLA_FLAGS", None)
    return env


def run_ranks(cmd, world: int = 2, timeout: float = SPAWN_TIMEOUT,
              cwd=None):
    """Run `cmd` as `world` ranks; returns their outputs. A rank that
    fails, or ranks still running after `timeout` seconds (killed then),
    fail the caller with every rank's output. The free port is probed
    before rank 0 binds it: if another process took it in between, the
    ranks run once more on another."""
    try:
        return _run_ranks(cmd, world, timeout, cwd)
    except AssertionError as e:
        if "ddress already in use" not in str(e):
            raise
        return _run_ranks(cmd, world, timeout, cwd)


def _run_ranks(cmd, world, timeout, cwd):
    port = _free_port()
    procs = [subprocess.Popen(cmd, cwd=cwd or ROOT,
                              env=rank_env(r, world, port),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs, timed_out = [], False
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            timed_out = True
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        logs.append(out)
    bad = timed_out or any(p.returncode != 0 for p in procs)
    if bad:
        raise AssertionError(
            ("ranks timed out after %ss\n" % timeout if timed_out else "")
            + "\n".join(f"--- rank {r} (rc {p.returncode}):\n{log[-4000:]}"
                        for r, (p, log) in enumerate(zip(procs, logs))))
    return logs


def spawn(task: str, out_dir, *args, world: int = 2,
          timeout: float = SPAWN_TIMEOUT):
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    logs = run_ranks([sys.executable, str(Path(__file__).resolve()), task,
                      str(out_dir), *map(str, args)], world, timeout)
    results = []
    for r, log in enumerate(logs):
        res = torch.load(out_dir / f"rank{r}.pt", weights_only=False)
        res["log"] = log
        results.append(res)
    return results


# ------------------------------------------------------------ shared inputs

def tiny_model(dropout: bool = True):
    """deliver_tiny's model, with_cp on; drop path and dropout at the
    config's rates, or all at 0."""
    from multimodal_sam_adapter_torch.configs.registry import get_config

    m = get_config("deliver_tiny")["model"]
    bb = dict(m["backbone"], with_cp=True)
    if not dropout:
        bb.update(drop_path_rate=0.0, conv_drop_path_rate=0.0, drop_rate=0.0)
        return dict(m, backbone=bb, dropout_ratio=0.0)
    return dict(m, backbone=bb)


OPT = dict(base_lr=2e-4, weight_decay=0.05, num_layers=4,
           layer_decay_rate=0.8, steps_per_epoch=2, max_epochs=3,
           warmup_epochs=1, warmup_ratio=0.1)


def global_batches(n: int, B: int = 2, seed: int = 0, size: int = 64):
    """n micro-batches of B samples: normalised inputs and labels with ~10%
    ignored pixels, from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        gt = rng.integers(0, 25, (B, size, size))
        gt[rng.random((B, size, size)) < 0.1] = 255
        img = (rng.standard_normal((B, size, size, 6)) * 0.5).astype(
            np.float32)
        out.append(dict(img=torch.from_numpy(img), gt=torch.from_numpy(gt)))
    return out


def digest(obj):
    """`obj` with every tensor replaced by (dtype, shape, sha256 of its
    bytes): equal digests are bit-equal tensors of one dtype and shape.
    Dicts, lists and tuples are walked; anything else is kept."""
    if torch.is_tensor(obj):
        t = obj.detach().cpu().contiguous()
        return (str(t.dtype), tuple(t.shape), hashlib.sha256(
            t.reshape(-1).view(torch.uint8).numpy().tobytes()).hexdigest())
    if isinstance(obj, dict):
        return {k: digest(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(digest(v) for v in obj)
    return obj


def keep(run: dict, *keys):
    """The entries `keys` of a `train_run` result."""
    return {k: run[k] for k in keys}


def local(batch, rank: int, world: int):
    """This rank's rows of every tensor of `batch`."""
    B = next(iter(batch.values())).shape[0] // world
    return {k: v[rank * B:(rank + 1) * B] for k, v in batch.items()}


def train_run(model_cfg, batches, accum: int, state_dict=None,
              opt=OPT, seed: int = 1, zero: bool = False, resume=None):
    """`make_train_step` on `batches` from the seeded random init (or
    `state_dict`), the model wrapped for data parallelism when there is a
    process group, the optimizer sharded by ZeRO with `zero`, the model,
    optimizer and step loaded from `resume` (a `saved` entry) first.
    Returns the losses, the gradients the optimizer saw at each update,
    the parameters after each update, the BatchNorm statistics after the
    last micro-step and, after each update, `saved`: the model's and the
    optimizer's state (a ZeRO optimizer's consolidated on rank 0, None on
    the others) and the step."""
    from multimodal_sam_adapter_torch.engine.train import (init_train_state,
                                                           make_train_step)
    from multimodal_sam_adapter_torch.parallel import wrap_model
    from multimodal_sam_adapter_torch.parallel.zero import shard_optimizer

    state = init_train_state(model_cfg, "cpu", seed=0, state_dict=state_dict,
                             init="random", optimizer_kwargs=dict(
                                 opt, grad_accum_steps=accum))
    state.seed = seed
    if zero:
        state.optimizer = shard_optimizer(state.optimizer)
    if resume is not None:
        state.model.load_state_dict(resume["model"])
        state.optimizer.load_state_dict(resume["optimizer"])
        state.step = resume["step"]
    named = dict(state.model.named_parameters())
    grads, params, losses, saved = [], [], [], []

    def before_step(optimizer, args, kwargs):
        if optimizer.mini_step + 1 == accum:      # this call updates
            grads.append({n: p.grad.clone() for n, p in named.items()})

    state.optimizer.register_step_pre_hook(before_step)
    step = make_train_step(wrap_model(state.model), state.optimizer)
    for b in batches:
        out = step(state, b)
        losses.append(out["loss"].item())
        if out["updated"]:
            params.append({n: p.detach().clone() for n, p in named.items()})
            saved.append(snapshot(state))
    stats = {n: b.clone() for n, b in state.model.named_buffers()}
    out = dict(losses=losses, grads=grads, params=params, stats=stats,
               saved=saved)
    if zero:
        opt = state.optimizer
        out["owner"] = opt.owner
        out["sizes"] = [p.numel() for p in opt._params()]
        out["held"] = [i for i, p in enumerate(opt._params())
                       if opt.state[p]]
    return out


def snapshot(state):
    """The model's state, the optimizer's (a ZeRO optimizer's gathered on
    rank 0 by every rank; None on the others) and the step, as copies."""
    import copy

    from multimodal_sam_adapter_torch.parallel import rank_world

    opt = state.optimizer
    if hasattr(opt, "consolidate_state_dict"):
        opt.consolidate_state_dict()
        if rank_world()[0] != 0:
            opt = None
    return dict(model={k: v.clone() for k, v in
                       state.model.state_dict().items()},
                optimizer=None if opt is None else copy.deepcopy(
                    opt.state_dict()),
                step=state.step)


class EvalSamples:
    """In-memory normalised 64x64 samples with DELIVER-like conditions and
    cases (some samples 'ordinary')."""
    CLASSES = tuple(f"c{i}" for i in range(25))
    CONDITIONS = ("cloud", "sun")
    CASES = ("motionblur", "overexposure")

    def __init__(self, n: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        cases = (None, "motionblur", "overexposure")
        self.samples = []
        for i in range(n):
            gt = rng.integers(0, 25, (64, 64)).astype(np.uint8)
            gt[rng.random((64, 64)) < 0.1] = 255
            self.samples.append(dict(
                img=rng.standard_normal((64, 64, 6)).astype(np.float32),
                gt=gt, meta=dict(condition=self.CONDITIONS[i % 2],
                                 case=cases[i % 3], stem=f"s{i}")))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        s = self.samples[i]
        return dict(img=s["img"].copy(), gt=s["gt"].copy(),
                    meta=dict(s["meta"]))


class RawSamples:
    """In-memory raw 80x80 train samples (BGR + LiDAR levels 0-255, labels
    in 16-pixel blocks) for the config's train pipeline."""
    CLASSES = tuple(f"c{i}" for i in range(25))
    PALETTE = tuple((i, i, i) for i in range(25))

    def __init__(self, n: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.samples = []
        for i in range(n):
            blocks = rng.integers(0, 25, (5, 5), dtype=np.uint8)
            gt = np.ascontiguousarray(np.repeat(np.repeat(blocks, 16, 0), 16,
                                                1))
            img = rng.integers(0, 256, (80, 80, 6)).astype(np.float32)
            self.samples.append(dict(img=img, gt=gt, meta={"stem": f"t{i}"}))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def eval_model():
    from multimodal_sam_adapter_torch.models.segmentor import build_segmentor

    return build_segmentor(tiny_model(), "cpu",
                           generator=torch.Generator().manual_seed(0))


def evaluate(dataset, **kw):
    from multimodal_sam_adapter_torch.engine.evaluator import Evaluator
    from multimodal_sam_adapter_torch.engine.inference import InferenceEngine

    engine = InferenceEngine(eval_model(), {"mode": "whole"})
    return Evaluator(engine, dataset, 25, case_aware=True).run(
        progress_every=0, **kw)


def runner_cfg():
    from multimodal_sam_adapter_torch.configs.registry import get_config

    cfg = get_config("deliver_tiny")
    cfg["data"].update(samples_per_gpu=1, grad_accum=2)
    cfg["runner"]["max_epochs"] = cfg["optimizer"]["max_epochs"] = 2
    cfg["checkpoint"].update(interval=1, max_keep_ckpts=2)
    cfg["evaluation"]["interval"] = 1
    cfg["log_config"] = {"interval": 1}
    return cfg


# ------------------------------------------------------------------- tasks

def task_step(rank, world):
    """Test 1, its negative case (the BatchNorm's all-reduce taken out),
    test 2, and the BatchNorm layer alone (test 4)."""
    import multimodal_sam_adapter_torch.nn.layers as layers

    model = tiny_model()
    batches = [local(b, rank, world) for b in global_batches(4)]
    out = {"one": keep(train_run(model, batches[:1], 1),
                       "losses", "grads", "stats"),
           "accum": keep(train_run(model, batches, 2), "losses", "params")}
    real = layers.rank_world
    layers.rank_world = lambda: (0, 1)
    try:
        out["unsynced"] = keep(train_run(model, batches[:1], 1),
                               "losses", "grads", "stats")
    finally:
        layers.rank_world = real
    x, dy = bn_inputs()
    out["bn"] = bn_run(local({"x": x}, rank, world)["x"],
                       local({"x": dy}, rank, world)["x"])
    return out


def bn_inputs(seed: int = 3):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(4, 8, 5, 6, generator=g) * 2 + 1
    dy = torch.randn(4, 8, 5, 6, generator=g)
    return x, dy


def bn_run(x, dy):
    """The port's BatchNorm2d in train mode on x (running statistics from
    0 / 1), y . dy backward: y, dx, the weight's and bias's gradients (this
    rank's share) and the running statistics."""
    from multimodal_sam_adapter_torch.nn.layers import BatchNorm2d

    bn = BatchNorm2d(x.shape[1]).train()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(4))
        bn.bias.normal_(0, 0.1, generator=torch.Generator().manual_seed(5))
    x = x.clone().requires_grad_()
    y = bn(x)
    y.backward(dy)
    return dict(y=y.detach(), dx=x.grad, dweight=bn.weight.grad,
                dbias=bn.bias.grad, running_mean=bn.running_mean.clone(),
                running_var=bn.running_var.clone())


def task_jax(rank, world, state_dict_path, batch_path):
    """Test 3: one step (grad_accum 1) on this rank's half of the JAX
    parity batch, from the weights in `state_dict_path`, dropout at 0."""
    sd = torch.load(state_dict_path, weights_only=True)
    batch = torch.load(batch_path, weights_only=True)
    return keep(train_run(tiny_model(dropout=False),
                          [local(batch, rank, world)], 1, state_dict=sd),
                "losses", "grads", "params", "stats")


def task_eval(rank, world):
    """Test 5: the evaluator over 5 samples, each rank its shard."""
    res = evaluate(EvalSamples(5))
    return {k: res[k] for k in ("payload", "rank_payload", "summary")}


def task_runner(rank, world, work):
    """Test 6: build_runner on 6 raw samples (3 a rank an epoch), grad_accum
    2, 2 epochs with a checkpoint and an eval each, then a new runner
    resumes from the epoch-0 checkpoint (taken partway through an
    accumulation) into a second work dir and runs epoch 1. The test
    compares the states bit for bit: they come back as digests."""
    from multimodal_sam_adapter_torch.tools.train import build_runner

    cfg = runner_cfg()
    summaries = []

    def runner_in(work_dir):
        runner = build_runner(cfg, RawSamples(6), work_dir, device="cpu",
                              seed=0, bf16=False, val_ds=EvalSamples(3, 1))
        eval_fn = runner.eval_fn

        def recorded(state):
            summaries.append(eval_fn(state))
            return summaries[-1]

        runner.eval_fn = recorded
        return runner

    def weights(runner):
        return {n: t.clone() for n, t in runner.state.model.state_dict()
                .items()}

    straight = runner_in(os.path.join(work, "straight"))
    saved = []
    save = straight._save

    def recorded_save(epoch, tag=None):
        path = save(epoch, tag)
        if tag is None and epoch == 0:
            saved.append((weights(straight), straight.state.optimizer
                          .state_dict()))
        return path

    straight._save = recorded_save
    straight.run()
    straight.logger.close()
    ckpt = os.path.join(work, "straight", "ckpts", "step_3.pth")
    resumed = runner_in(os.path.join(work, "resumed"))
    resumed.resume(ckpt)
    restored = (weights(resumed), resumed.state.optimizer.state_dict())
    resumed.run()
    resumed.logger.close()
    return digest(dict(straight=weights(straight), resumed=weights(resumed),
                       saved=saved[0], restored=restored,
                       summaries=summaries, start_epoch=resumed.start_epoch,
                       updates=(straight.state.optimizer.updates,
                                resumed.state.optimizer.updates)))


def task_zero(rank, world, work, state_dict_path, batch_path):
    """ZeRO over the ranks (tests/test_torch_parallel_zero.py): the DDP
    step, grad_accum 2, two updates, with the unsharded and the sharded
    optimizer; resumes after the first update from each one's saved state
    into the other; the sharded step from the JAX parity weights on this
    rank's half of the JAX batch (grad_accum 1, dropout 0). The tests
    compare the first four runs bit for bit: they come back as digests;
    the JAX run's losses and parameters, held to a tolerance, whole."""
    import torch.distributed as dist

    model = tiny_model()
    batches = [local(b, rank, world) for b in global_batches(4)]
    runs = {"plain": train_run(model, batches, 2),
            "zero": train_run(model, batches, 2, zero=True)}
    for src, dst in (("zero", "plain"), ("plain", "zero")):
        path = Path(work) / f"{src}_update1.pt"
        if rank == 0:
            torch.save(runs[src]["saved"][0], path)
        dist.barrier()
        runs[f"{src}_to_{dst}"] = train_run(
            model, batches[2:], 2, zero=dst == "zero",
            resume=torch.load(path, weights_only=True))
        dist.barrier()
        if rank == 0:
            path.unlink()
    out = digest(runs)
    sd = torch.load(state_dict_path, weights_only=True)
    batch = torch.load(batch_path, weights_only=True)
    out["jax"] = keep(train_run(tiny_model(dropout=False),
                                [local(batch, rank, world)], 1,
                                state_dict=sd, zero=True),
                      "losses", "params")
    return out


def task_tp(rank, world, state_dict_path, x_path):
    """The tensor-parallel eval forward (tests/test_torch_parallel_tp.py)
    of deliver_tiny from the JAX parity weights, on a (data 2, model 2)
    and a (data 1, model 4) mesh: this rank's rows of the batch, the
    logits, the all-reduces, the head counts the kernels were called
    with."""
    from multimodal_sam_adapter_torch.models.segmentor import build_segmentor
    from multimodal_sam_adapter_torch.parallel.tp import (make_mesh,
                                                          shard_segmentor_)

    sd = torch.load(state_dict_path, weights_only=True)
    x = torch.load(x_path, weights_only=True)
    out = {}
    for data, model in ((2, 2), (1, 4)):
        mesh = make_mesh(data, model)
        net = shard_segmentor_(build_segmentor(tiny_model(dropout=False),
                                               "cpu", state_dict=sd), mesh)
        with torch.no_grad():
            logits = net(local({"x": x}, mesh.data_rank, data)["x"])
        bb = net.backbone
        out[(data, model)] = dict(
            logits=logits, all_reduces=mesh.all_reduces,
            data_rank=mesh.data_rank, model_rank=mesh.model_rank,
            heads=dict(vit=bb.blocks[0].attn.num_heads,
                       injector=bb.interactions[0].injector.attn.n_heads,
                       extractor=bb.interactions[0].extractor.attn.n_heads))
    return out


TASKS = {"step": task_step, "jax": task_jax, "eval": task_eval,
         "runner": task_runner, "zero": task_zero, "tp": task_tp}


def main(argv):
    task, out_dir, *args = argv
    torch.set_num_threads(1)
    from multimodal_sam_adapter_torch.parallel import (close_distributed,
                                                       init_distributed)

    rank, world = init_distributed("gloo")
    try:
        out = TASKS[task](rank, world, *args)
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        close_distributed()


if __name__ == "__main__":
    main(sys.argv[1:])
