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


def test_two_ranks_match_the_jax_global_batch_step(both, two_ranks):
    params = both["variables"]["params"]
    tx = jopt.make_optimizer(params, grad_accum_steps=1, **ddp_worker.OPT)

    @jax.jit
    def update(g, p):
        upd, _ = tx.update(g, tx.init(p), p)
        return optax.apply_updates(p, upd)

    new = jax.tree.map(np.asarray, update(both["jax_grads"], params))
    want = state_dict_from_jax(
        {"params": new, "batch_stats": jax.tree.map(
            np.asarray, both["variables"]["batch_stats"])}, IDX)
    np.testing.assert_allclose(
        np.mean([r["losses"][0] for r in two_ranks]), both["loss"][1],
        rtol=1e-5)
    for r in two_ranks:
        (got,) = r["params"]
        for name, t in got.items():
            np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                       rtol=1e-3, atol=2.5e-4, err_msg=name)
        for name in both["pixels"]:
            for stat in ("running_mean", "running_var"):
                key = f"{name}.{stat}"
                np.testing.assert_allclose(
                    r["stats"][key].numpy(), both["want"][key].numpy(),
                    rtol=1e-5, atol=1e-7, err_msg=key)
        (grads,) = r["grads"]
        for name, g in grads.items():
            w = both["want"][name].numpy()
            err = np.abs(g.numpy() - w).max()
            assert err <= 1e-3 * np.abs(w).max() + 1e-6, (name, err)
