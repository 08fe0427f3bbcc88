"""Ranks for the port's data-parallel CPU tests (tests/test_torch_ddp*.py).

`spawn(task, out_dir, ...)` starts `world` processes of this file over a
gloo process group on localhost, each with torchrun's environment (RANK,
WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT on a
free port; the port's parallel/ddp.py:launch_ranks) and one torch
thread, waits for them within a time limit of its own (then kills them
and fails), and returns each rank's results, the dict the task saved to
`<out_dir>/rank<r>.pt`, with its output under "log". The tasks build
their inputs from seeds, and the tests build the single-process
references from the same functions, so every rank holds rows rank x B
... of the reference's global batch.

A task returns only what its test reads: a tensor that a test compares
bit for bit with another comes back as its `digest` (dtype, shape and a
hash of its bytes), and only the tensors a tolerance check reads come
back whole, so a spawn writes megabytes, not the model-sized states of
every run.

The file imports torch and the port only, never JAX.
"""
import hashlib
import os
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT = 120


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
    from multimodal_sam_adapter_torch.parallel.ddp import launch_ranks

    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    env.pop("XLA_FLAGS", None)
    ranks = launch_ranks(cmd, world, timeout, env=env, cwd=cwd or ROOT)
    codes = [rc for rc, _ in ranks]
    if codes != [0] * world:
        raise AssertionError(
            (f"ranks timed out after {timeout}s\n" if None in codes else "")
            + "\n".join(f"--- rank {r} (rc {rc}):\n{log[-4000:]}"
                        for r, (rc, log) in enumerate(ranks)))
    return [log for _, log in ranks]


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
              opt=OPT, seed: int = 1, zero: bool = False, resume=None,
              mesh=None, wrap=None, after_step=None):
    """`make_train_step` on `batches` from the seeded random init (or
    `state_dict`), the model wrapped for data parallelism when there is a
    process group, the optimizer sharded by ZeRO with `zero`, the model,
    optimizer and step loaded from `resume` (a `saved` entry) first.
    With a tensor-parallel `mesh` (parallel/tp.py) the model is sharded
    over it, wrapped over its data group (or by `wrap`), the gradients and
    parameters returned are the gathered (unsharded) ones, and `counts`
    holds each micro-step's (forward, recompute, backward) all-reduces;
    `after_step(i, state)` runs after micro-step i.
    Returns the losses, the gradients the optimizer saw at each update,
    the parameters after each update, the BatchNorm statistics after the
    last micro-step and, after each update, `saved`: the model's and the
    optimizer's state (a ZeRO optimizer's consolidated on rank 0, None on
    the others; none under a mesh) and the step; with a mesh, `state`."""
    from multimodal_sam_adapter_torch.engine.train import (init_train_state,
                                                           make_train_step)
    from multimodal_sam_adapter_torch.parallel import wrap_model
    from multimodal_sam_adapter_torch.parallel.tp import (gather_over_model,
                                                          sharded_plan)
    from multimodal_sam_adapter_torch.parallel.zero import shard_optimizer

    state = init_train_state(model_cfg, "cpu", seed=0, state_dict=state_dict,
                             init="random", optimizer_kwargs=dict(
                                 opt, grad_accum_steps=accum), mesh=mesh)
    state.seed = seed
    if zero:
        state.optimizer = shard_optimizer(state.optimizer)
    if resume is not None:
        state.model.load_state_dict(resume["model"])
        state.optimizer.load_state_dict(resume["optimizer"])
        state.step = resume["step"]
    named = dict(state.model.named_parameters())
    plan = sharded_plan(state.model)

    def whole(n, t):
        t = t.detach().clone()
        return gather_over_model(t, plan[n], mesh) if n in plan else t

    grads, params, losses, saved, counts = [], [], [], [], []

    def before_step(optimizer, args, kwargs):
        if optimizer.mini_step + 1 == accum:      # this call updates
            grads.append({n: whole(n, p.grad) for n, p in named.items()})

    state.optimizer.register_step_pre_hook(before_step)
    if wrap is None:
        wrap = lambda m: wrap_model(  # noqa: E731
            m, None if mesh is None else mesh.data_group)
    step = make_train_step(wrap(state.model), state.optimizer, mesh=mesh)
    for i, b in enumerate(batches):
        if mesh is not None:
            mesh.reset_counts()
        out = step(state, b)
        losses.append(out["loss"].item())
        if mesh is not None:
            counts.append((mesh.all_reduces, mesh.recompute_all_reduces,
                           mesh.backward_all_reduces))
        if out["updated"]:
            params.append({n: whole(n, p) for n, p in named.items()})
            if mesh is None:
                saved.append(snapshot(state))
        if after_step is not None:
            after_step(i, state)
    stats = {n: b.clone() for n, b in state.model.named_buffers()}
    out = dict(losses=losses, grads=grads, params=params, stats=stats,
               saved=saved)
    if mesh is not None:
        out.update(counts=counts, state=state)
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


# a tiny SAM image encoder (models/sam_vit.py:ImageEncoderViT) for the
# tensor-parallel forward of tests/test_torch_sam_encoder.py: a 6 x 6 token
# grid, windows of 4 (padded), block 1 global
TINY_ENCODER = dict(patch_size=16, embed_dim=32, depth=3, num_heads=2,
                    window_size=4, global_attn_indexes=(1,),
                    pretrained_size=96)


def task_tp(rank, world, state_dict_path, x_path, kind="segmentor",
            m2f_state_dict_path=None, m2f_x_path=None):
    """The tensor-parallel eval forward (tests/test_torch_parallel_tp.py)
    of deliver_tiny from the JAX parity weights, on a (data 2, model 2)
    and a (data 1, model 4) mesh: this rank's rows of the batch, the
    logits, the all-reduces, the head counts the kernels were called
    with; given the m2f paths, also deliver_tiny_m2f's forward on the
    (data 2, model 2) mesh (`m2f`), with its pixel decoder's heads. kind
    "encoder": TINY_ENCODER's forward on a (data 1, model world) mesh
    (tests/test_torch_sam_encoder.py): the tokens, the all-reduces, the
    heads."""
    from multimodal_sam_adapter_torch.models.sam_vit import ImageEncoderViT
    from multimodal_sam_adapter_torch.models.segmentor import build_segmentor
    from multimodal_sam_adapter_torch.parallel.tp import (make_mesh,
                                                          shard_segmentor_)

    sd = torch.load(state_dict_path, weights_only=True)
    x = torch.load(x_path, weights_only=True)
    if kind == "encoder":
        mesh = make_mesh(1, world)
        enc = ImageEncoderViT(**TINY_ENCODER)
        enc.load_state_dict(sd, strict=True)
        enc = shard_segmentor_(enc.eval(), mesh)
        with torch.no_grad():
            tokens, Hp, Wp = enc(x)
        return dict(tokens=tokens, grid=(Hp, Wp),
                    all_reduces=mesh.all_reduces,
                    heads=[b.attn.num_heads for b in enc.blocks])
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
    if m2f_state_dict_path is not None:
        from multimodal_sam_adapter_torch.configs.registry import get_config

        mesh = make_mesh(2, 2)
        net = shard_segmentor_(build_segmentor(
            get_config("deliver_tiny_m2f")["model"], "cpu",
            state_dict=torch.load(m2f_state_dict_path, weights_only=True)),
            mesh)
        x = torch.load(m2f_x_path, weights_only=True)
        with torch.no_grad():
            logits = net(local({"x": x}, mesh.data_rank, 2)["x"])
        layer = net.decode_head.pixel_decoder.encoder.layers[0]
        out["m2f"] = dict(logits=logits, all_reduces=mesh.all_reduces,
                          data_rank=mesh.data_rank,
                          heads=layer.attentions[0].n_heads)
    return out


def rel_l2(got, want):
    """name -> |got - want| / |want| (L2) of each tensor of `want`."""
    return {n: ((got[n] - t).norm() / t.norm()).item()
            for n, t in want.items()}


def task_tp_train(rank, world, work, state_dict_path, batch_path,
                  ref_path):
    """The train step under tensor parallelism on a (data 2, model 2)
    mesh (tests/test_torch_train_parity.py), one sample a data rank:
    (1) `jax`: grad_accum 1, dropout 0, from the JAX parity weights on the
    JAX batch; rank 0 returns the gathered gradients and parameters whole,
    with the shard shapes and the head counts. (2) `accum`: deliver_tiny
    with drop path on, grad_accum 2, two updates, held to the one-process
    run of `ref_path` (each tensor's relative L2 after each update), with
    the all-reduce counts and digests of the gathered parameters; after
    its third micro-step the state is gathered (`gather_train_state`),
    loaded into a fresh sharded model and optimizer (`shard_train_state`)
    and taken through the fourth micro-step; after the run the gathered
    state on rank 0 beside the unsharded optimizer's given the gathered
    gradients, and written as a checkpoint. (3) the same first update
    with the backward's model-group sum taken out, and (4) with DDP over
    every rank: relative L2 only."""
    import torch.distributed as dist

    import multimodal_sam_adapter_torch.parallel.tp as tp
    from multimodal_sam_adapter_torch.engine.checkpoint import (
        write_checkpoint)
    from multimodal_sam_adapter_torch.engine.train import (init_train_state,
                                                           make_train_step)
    from multimodal_sam_adapter_torch.parallel import wrap_model

    mesh = tp.make_mesh(2, world // 2)
    d = mesh.data_rank
    out = {"data_rank": d, "model_rank": mesh.model_rank}
    sd = torch.load(state_dict_path, weights_only=True)
    batch = torch.load(batch_path, weights_only=True)
    run = train_run(tiny_model(dropout=False), [local(batch, d, 2)], 1,
                    state_dict=sd, mesh=mesh)
    bb = run["state"].model.backbone
    out["jax"] = dict(
        losses=run["losses"], counts=run["counts"],
        shapes={n: tuple(p.shape) for n, p in
                run["state"].model.named_parameters()},
        plan=tp.sharded_plan(run["state"].model),
        heads=dict(vit=bb.blocks[0].attn.num_heads,
                   injector=bb.interactions[0].injector.attn.n_heads,
                   extractor=bb.interactions[0].extractor.attn.n_heads),
        digest=digest(keep(run, "grads", "params")))
    if rank == 0:
        out["jax"].update(keep(run, "grads", "params", "stats"))
    del run, sd

    ref = torch.load(ref_path, weights_only=True)
    batches = [local(b, d, 2) for b in global_batches(4)]
    model = tiny_model()
    mid = {}

    def save_mid(i, state):
        if i == 2:      # partway through the second accumulation
            mid["state"] = tp.gather_train_state(state.model,
                                                 state.optimizer, mesh)
            mid["model"] = digest(state.model.state_dict())
            mid["optimizer"] = digest(state.optimizer.state_dict())

    run = train_run(model, batches, 2, mesh=mesh, after_step=save_mid)
    state = run.pop("state")
    fresh = init_train_state(model, "cpu", seed=5, init="random",
                             optimizer_kwargs=dict(OPT, grad_accum_steps=2),
                             mesh=mesh)
    tp.shard_train_state(fresh.model, fresh.optimizer, *mid["state"], mesh)
    restored = (digest(fresh.model.state_dict()),
                digest(fresh.optimizer.state_dict()))
    fresh.seed, fresh.step = 1, 3
    make_train_step(wrap_model(fresh.model, mesh.data_group),
                    fresh.optimizer, mesh=mesh)(fresh, batches[3])
    resumed = {n: whole_param(t, mesh)
               for n, t in fresh.model.named_parameters()}
    full_sd, full_osd = tp.gather_train_state(state.model, state.optimizer,
                                              mesh)
    out["accum"] = dict(
        losses=run["losses"], counts=run["counts"],
        rel=[rel_l2(got, want) for got, want in zip(run["params"], ref)],
        params=digest(run["params"]),
        restored_equal=restored == (mid["model"], mid["optimizer"]),
        resumed_equal=digest(resumed) == digest(run["params"][-1]),
        state=digest(full_osd))
    if rank == 0:
        # the unsharded optimizer from the same init, given the gathered
        # gradients of each update
        plain = init_train_state(model, "cpu", seed=0, init="random",
                                 optimizer_kwargs=dict(OPT,
                                                       grad_accum_steps=2))
        for grads in run["grads"]:
            for n, p in plain.model.named_parameters():
                p.grad = grads[n].clone()
            plain.optimizer.mini_step = 1
            plain.optimizer.step()
        out["accum"].update(
            plain_state=digest(plain.optimizer.state_dict()),
            plain_params=digest(dict(plain.model.named_parameters())),
            gathered_params=digest({n: full_sd[n] for n, _ in
                                    plain.model.named_parameters()}),
            ckpt=write_checkpoint(work, full_sd, full_osd, state.step,
                                  {"mesh": [mesh.data, mesh.model]}))
    del run, state, fresh, mid
    dist.barrier()

    real = tp._sum_gradient
    tp._sum_gradient = lambda g, mesh: g
    try:
        run = train_run(model, batches[:2], 2, mesh=mesh)
    finally:
        tp._sum_gradient = real
    out["no_backward_sum"] = rel_l2(run["params"][0], ref[0])
    run = train_run(model, batches[:2], 2, mesh=mesh, wrap=wrap_model)
    out["ddp_over_world"] = rel_l2(run["params"][0], ref[0])
    return out


def whole_param(t, mesh):
    """A parameter of a sharded model, gathered when it is split."""
    from multimodal_sam_adapter_torch.parallel.tp import gather_over_model

    split = getattr(t, "tp_split", None)
    t = t.detach().clone()
    return t if split is None else gather_over_model(t, split, mesh)


TASKS = {"step": task_step, "jax": task_jax, "eval": task_eval,
         "runner": task_runner, "zero": task_zero, "tp": task_tp,
         "tp_train": task_tp_train}


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
