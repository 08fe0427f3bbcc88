"""The train-mode segmentor against the JAX package's, float32 on the CPU:
`EncoderDecoder.loss` at deliver_tiny's geometry (`_flagship_model(tiny=
True)`), its gradient for every parameter, and the BatchNorm running
statistics it leaves, against JAX's `model.apply(..., method=model.loss,
mutable=["batch_stats"])`. Drop path and dropout at 0 (their masks come
from different generators in the two packages); with_cp on in both.

Every variable is drawn from a seeded numpy generator into the JAX tree
and reaches the port through the weight bridge (engine/convert.py); the
gradients come back through it too.

The same global batch on two gloo ranks of the port, one sample each
(tests/_torch_ddp_worker.py, its step through DistributedDataParallel),
against JAX's single-process step on it (its loss and gradient, then its
optax update, as the oracle of tests/test_multiprocess_train.py) with
that test's tolerances: loss rtol 1e-5, parameters after the update rtol
1e-3 / atol 2.5e-4; and the BatchNorm statistics rtol 1e-5 / atol 1e-7.

Tolerances: loss rtol 1e-4; per parameter, max |g_port - g_jax| <= 1e-3 x
max |g_jax| + 1e-6. BatchNorm: the port's BatchNorm2d updates its running
mean and variance as flax does (the biased batch variance), so both equal
JAX's within rtol 1e-5 / atol 1e-7.

Tensor parallelism (parallel/tp.py): one spawn of four gloo ranks on a
(data 2, model 2) mesh (tests/_torch_ddp_worker.py's `tp_train` task),
one sample a data rank.

- From the JAX parity weights on the JAX batch, dropout 0, grad_accum 1:
  the data ranks' mean loss, the gathered gradients, the gathered
  parameters after the optax update and the BatchNorm statistics against
  JAX's unsharded step, with the two-rank test's tolerances (JAX's
  tensor-parallel step computes the same function: under `-m slow` the
  port is also held against it on four virtual devices); each rank's
  shard shapes as `tp_plan` says, the ViT on 1 head a rank and MSDA on 2.
- deliver_tiny with drop path at the config's rates, grad_accum 2, two
  updates, against the port's one-process step on the global batch:
  every parameter within 1e-4 relative L2 after each update (the bar of
  tests/test_torch_ddp.py), the data ranks bit-equal, and each
  micro-step's model-group all-reduces: 24 row-parallel sums forward
  (2 a ViT block, 1 an injector, 2 an extractor), 24 again in the
  `with_cp` recompute, 42 gradient sums backward (the ViT's x, MLP input
  and two rel-pos tables, MSDA's query and value input, ConvFFN's input).
- The same comparison fails with the backward's model-group sum taken
  out, and with DistributedDataParallel over every rank in place of the
  data group (it averages model rank 0's shares with model rank 1's).
- The state: gathered partway through an accumulation and loaded into a
  fresh sharded model and optimizer, bit for bit, and the next micro-step
  from it bit-equal to the straight run's; after the updates, the
  gathered optimizer state and parameters bit-equal to the unsharded
  optimizer's given the gathered gradients, and a checkpoint of it read
  back into the unsharded model and optimizer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_sam_adapter_torch.configs.registry import get_config
from multimodal_sam_adapter_torch.engine.convert import state_dict_from_jax
from multimodal_sam_adapter_torch.models.segmentor import build_segmentor
from multimodal_sam_adapter_torch.nn.layers import set_dropout_key
from multimodal_sam_adapter_tpu.engine import optim as jopt
from multimodal_sam_adapter_tpu.models.segmentor import (
    EncoderDecoder as JaxEncoderDecoder)
from tests import _torch_ddp_worker as ddp_worker
from tests._torch_parity import randomize

MODEL = get_config("deliver_tiny")["model"]
BACKBONE = dict(MODEL["backbone"], drop_path_rate=0.0,
                conv_drop_path_rate=0.0, drop_rate=0.0, with_cp=True)
CFG = dict(MODEL, backbone=BACKBONE, dropout_ratio=0.0)
IDX = BACKBONE["interaction_indexes"]
B, S = 2, BACKBONE["img_size"]


@pytest.fixture(scope="module")
def both():
    jm = JaxEncoderDecoder(num_classes=CFG["num_classes"],
                           head_channels=CFG["head_channels"],
                           dropout_ratio=0.0, backbone_cfg=BACKBONE)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, S, S, 6)), train=False))
    variables = randomize(shapes, 1)
    rng = np.random.default_rng(0)
    img = (rng.standard_normal((B, S, S, 6)) * 0.5).astype(np.float32)
    gt = rng.integers(0, CFG["num_classes"], (B, S, S)).astype(np.int32)
    gt[rng.random((B, S, S)) < 0.1] = 255

    def loss_fn(params, stats):
        (loss, _), upd = jm.apply(
            {"params": params, "batch_stats": stats}, jnp.asarray(img),
            jnp.asarray(gt), method=jm.loss, mutable=["batch_stats"])
        return loss, upd["batch_stats"]

    with jax.default_matmul_precision("highest"):
        (loss, stats), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(variables["params"],
                                    variables["batch_stats"])
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    want_grads = state_dict_from_jax(
        {"params": to_np(grads), "batch_stats": to_np(stats)}, IDX)

    model = build_segmentor(CFG, "cpu", state_dict=state_dict_from_jax(
        variables, IDX)).train()
    old = {n: b.clone() for n, b in model.named_buffers()}
    seen = {}

    def pixels(name):
        def hook(module, args):
            seen.setdefault(name, args[0].numel() // args[0].shape[1])
        return hook

    hooks = [m.register_forward_pre_hook(pixels(name))
             for name, m in model.named_modules()
             if isinstance(m, torch.nn.BatchNorm2d)]
    set_dropout_key(model, 0)
    got_loss, logits = model.loss(torch.from_numpy(img),
                                  torch.from_numpy(gt))
    got_loss.backward()
    for h in hooks:
        h.remove()
    return dict(loss=(got_loss.item(), float(loss)), logits=logits,
                model=model, want=want_grads, old=old, pixels=seen,
                variables=variables, jax_grads=grads, img=img, gt=gt)


def test_loss_matches_jax(both):
    got, want = both["loss"]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert both["logits"].shape == (B, S, S, CFG["num_classes"])


def test_every_parameter_gradient_matches_jax(both):
    model, want = both["model"], both["want"]
    n = 0
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        w = want[name].numpy()
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= 1e-3 * np.abs(w).max() + 1e-6, (name, err,
                                                      np.abs(w).max())
        n += 1
    assert n == len(want) - 3 * len(both["pixels"])  # 3 buffers a norm


def test_batchnorm_running_statistics_match_jax(both):
    """Every train-mode BatchNorm updated its running mean and its running
    variance as flax does: the variance with the biased batch variance
    (torch's own BatchNorm would take the unbiased one, n / (n - 1) times
    larger, 1 / 7 at the stride-32 map below)."""
    model, want, old = both["model"], both["want"], both["old"]
    assert len(both["pixels"]) == 13   # neck 4, backbone 4, head 5
    for name in both["pixels"]:
        for stat in ("running_mean", "running_var"):
            key = f"{name}.{stat}"
            np.testing.assert_allclose(
                model.get_buffer(key).numpy(), want[key].numpy(), rtol=1e-5,
                atol=1e-7, err_msg=key)
            assert not torch.equal(want[key], old[key]), key
        assert model.get_buffer(f"{name}.num_batches_tracked").item() == 1
    # deliver_tiny's stride-32 map: 2 x 2 pixels, batch 2
    assert both["pixels"]["backbone.norm4"] == 8


@pytest.fixture(scope="module")
def two_ranks(both, tmp_path_factory):
    d = tmp_path_factory.mktemp("ddp_jax")
    torch.save(state_dict_from_jax(both["variables"], IDX), d / "sd.pt")
    torch.save({"img": torch.from_numpy(both["img"]),
                "gt": torch.from_numpy(both["gt"]).long()}, d / "batch.pt")
    return ddp_worker.spawn("jax", d, d / "sd.pt", d / "batch.pt")


@pytest.fixture(scope="module")
def jax_updated(both):
    """The parameters after JAX's optax update of the global batch's
    gradients (and the BatchNorm statistics before it), as a state dict."""
    params = both["variables"]["params"]
    tx = jopt.make_optimizer(params, grad_accum_steps=1, **ddp_worker.OPT)

    @jax.jit
    def update(g, p):
        upd, _ = tx.update(g, tx.init(p), p)
        return optax.apply_updates(p, upd)

    new = jax.tree.map(np.asarray, update(both["jax_grads"], params))
    return state_dict_from_jax(
        {"params": new, "batch_stats": jax.tree.map(
            np.asarray, both["variables"]["batch_stats"])}, IDX)


def assert_jax_step(both, want, losses, got):
    """One step of the ranks (their `losses`; `got`: a rank's gradients,
    parameters after the update and statistics) against JAX's."""
    np.testing.assert_allclose(np.mean(losses), both["loss"][1], rtol=1e-5)
    (params,) = got["params"]
    for name, t in params.items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                   rtol=1e-3, atol=2.5e-4, err_msg=name)
    for name in both["pixels"]:
        for stat in ("running_mean", "running_var"):
            key = f"{name}.{stat}"
            np.testing.assert_allclose(
                got["stats"][key].numpy(), both["want"][key].numpy(),
                rtol=1e-5, atol=1e-7, err_msg=key)
    (grads,) = got["grads"]
    for name, g in grads.items():
        w = both["want"][name].numpy()
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-3 * np.abs(w).max() + 1e-6, (name, err)


def test_two_ranks_match_the_jax_global_batch_step(both, two_ranks,
                                                   jax_updated):
    for r in two_ranks:
        assert_jax_step(both, jax_updated,
                        [q["losses"][0] for q in two_ranks], r)


# ------------------------------------------------------ tensor parallelism

@pytest.fixture(scope="module")
def tp_reference():
    """The port's one-process step on the global batch of the TP ranks'
    accumulation run (drop path on, grad_accum 2, two updates), on one
    torch thread as the ranks run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return ddp_worker.train_run(ddp_worker.tiny_model(),
                                    ddp_worker.global_batches(4), 2)
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tp_ranks(both, tp_reference, tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_train")
    torch.save(state_dict_from_jax(both["variables"], IDX), d / "sd.pt")
    torch.save({"img": torch.from_numpy(both["img"]),
                "gt": torch.from_numpy(both["gt"]).long()}, d / "batch.pt")
    torch.save(tp_reference["params"], d / "ref.pt")
    return ddp_worker.spawn("tp_train", d, d, d / "sd.pt", d / "batch.pt",
                            d / "ref.pt", world=4)


def test_tp_ranks_match_the_jax_global_batch_step(both, tp_ranks,
                                                  jax_updated):
    assert sorted((r["data_rank"], r["model_rank"]) for r in tp_ranks) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    # each data rank's loss, the same on its model ranks
    losses = [r["jax"]["losses"][0] for r in tp_ranks if r["model_rank"] == 0]
    assert_jax_step(both, jax_updated, losses, tp_ranks[0]["jax"])
    for r in tp_ranks:
        assert r["jax"]["digest"] == tp_ranks[0]["jax"]["digest"]


def test_tp_ranks_hold_their_shares(tp_ranks):
    from multimodal_sam_adapter_torch.parallel.tp import shard, tp_plan

    full = build_segmentor(CFG, "cpu", generator=torch.Generator()
                           .manual_seed(0))
    plan = tp_plan(full, 2)
    assert len(plan) == 124
    params = dict(full.named_parameters())
    for r in tp_ranks:
        got = r["jax"]
        assert got["plan"] == plan
        assert got["heads"] == dict(vit=1, injector=2, extractor=2)
        for name, shape in got["shapes"].items():
            want = (shard(params[name], plan[name], r["model_rank"], 2).shape
                    if name in plan else params[name].shape)
            assert shape == tuple(want), name
        # 24 row-parallel sums forward, 42 gradient sums backward; the
        # recompute stops after the last tensor the backward needs, which
        # without drop path comes before the last extractor's sums
        ((fwd, recompute, bwd),) = got["counts"]
        assert (fwd, bwd) == (24, 42) and recompute <= 24


def test_tp_ranks_match_the_one_process_step(tp_ranks, tp_reference):
    want = tp_reference["losses"]
    for m in range(2):
        got = [np.mean([r["accum"]["losses"][i] for r in tp_ranks
                        if r["model_rank"] == m]) for i in range(4)]
        np.testing.assert_allclose(got, want, rtol=1e-5)
    for r in tp_ranks:
        assert len(r["accum"]["rel"]) == 2
        for k, rel in enumerate(r["accum"]["rel"]):
            assert len(rel) == len(tp_reference["params"][k])
            worst = max(rel, key=rel.get)
            assert rel[worst] <= 1e-4, (k, worst, rel[worst])
        # data ranks (and model ranks) hold the same gathered parameters
        assert r["accum"]["params"] == tp_ranks[0]["accum"]["params"]
        assert r["accum"]["counts"] == [(24, 24, 42)] * 4


@pytest.mark.parametrize("mutant", ["no_backward_sum", "ddp_over_world"])
def test_the_tp_check_sees_a_broken_step(tp_ranks, mutant):
    """The backward's model-group sum taken out (each rank's input
    gradient holds only its own heads' share), or DDP over every rank:
    the first update's parameters leave the 1e-4 bar."""
    for r in tp_ranks:
        rel = r[mutant]
        assert max(rel.values()) > 1e-4, mutant


def test_tp_train_state_gathers_and_shards_back(tp_ranks):
    from multimodal_sam_adapter_torch.engine.checkpoint import (
        restore_checkpoint)
    from multimodal_sam_adapter_torch.engine.optim import make_optimizer

    for r in tp_ranks:
        assert r["accum"]["restored_equal"] and r["accum"]["resumed_equal"]
        assert r["accum"]["state"] == tp_ranks[0]["accum"]["state"]
    got = tp_ranks[0]["accum"]
    assert got["state"] == got["plain_state"]
    assert got["gathered_params"] == got["plain_params"]
    # the checkpoint, unsharded, loads into the unsharded model and
    # optimizer strictly
    payload = restore_checkpoint(got["ckpt"])
    assert payload["meta"]["step"] == 4
    model = build_segmentor(ddp_worker.tiny_model(), "cpu",
                            state_dict=payload["state_dict"])
    opt = make_optimizer(model, **dict(ddp_worker.OPT, grad_accum_steps=2))
    opt.load_state_dict(payload["optimizer"])
    assert opt.updates == 2
    assert ddp_worker.digest(opt.state_dict()) == got["state"]
    assert ddp_worker.digest(dict(model.named_parameters())) == got[
        "plain_params"]


@pytest.mark.slow
def test_tp_ranks_match_the_jax_tensor_parallel_step(both, tp_ranks):
    """JAX's own tensor-parallel step (__graft_entry__.py's dryrun recipe:
    a (data 2, model 2) mesh of four virtual CPU devices, shard_params_tp,
    engine/train.py:make_train_step) on the same weights and batch, grad_
    accum 1, dropout 0: the TP ranks' loss, updated parameters and
    BatchNorm statistics within the two-rank test's tolerances."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from multimodal_sam_adapter_tpu.engine.train import (TrainState,
                                                         make_train_step)
    from multimodal_sam_adapter_tpu.parallel.mesh import make_mesh
    from multimodal_sam_adapter_tpu.parallel.tp import shard_params_tp

    mesh = make_mesh(("data", "model"), shape=(2, 2),
                     devices=jax.devices()[:4])
    jm = JaxEncoderDecoder(num_classes=CFG["num_classes"],
                           head_channels=CFG["head_channels"],
                           dropout_ratio=0.0, backbone_cfg=BACKBONE)
    params = shard_params_tp(both["variables"]["params"], mesh)
    stats = jax.device_put(both["variables"]["batch_stats"],
                           NamedSharding(mesh, P()))
    tx = jopt.make_optimizer(params, grad_accum_steps=1, **ddp_worker.OPT)
    state = TrainState.create(params, stats, tx)
    rows = NamedSharding(mesh, P("data"))
    batch = {"img": jax.device_put(jnp.asarray(both["img"]), rows),
             "gt": jax.device_put(jnp.asarray(both["gt"]), rows)}
    with jax.default_matmul_precision("highest"):
        new, metrics = make_train_step(jm, donate=False)(
            state, batch, jax.random.PRNGKey(1))
    want = state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, new.params),
         "batch_stats": jax.tree.map(np.asarray, new.batch_stats)}, IDX)
    losses = [r["jax"]["losses"][0] for r in tp_ranks
              if r["model_rank"] == 0]
    np.testing.assert_allclose(np.mean(losses), float(metrics["loss"]),
                               rtol=1e-5)
    got = tp_ranks[0]["jax"]
    (params,) = got["params"]
    for name, t in params.items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                   rtol=1e-3, atol=2.5e-4, err_msg=name)
    for name in both["pixels"]:
        for stat in ("running_mean", "running_var"):
            key = f"{name}.{stat}"
            np.testing.assert_allclose(got["stats"][key].numpy(),
                                       want[key].numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=key)
