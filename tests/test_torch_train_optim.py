"""The port's optimizer (engine/optim.py) against the JAX package's optax
chain, on deliver_tiny's parameters, float32 on the CPU.

JAX trees reach the port's parameter names through the weight bridge
(engine/convert.py:state_dict_from_jax): a tree of per-leaf constants
(a layer-decay scale, a weight-decay flag, a freeze factor) maps onto
tensors that hold the same constant, so each port parameter's value is
read back from the tensor of its name. Parameters and gradients are drawn
from a seeded numpy generator.

Tolerances: the schedule within float32 rounding (rtol 1e-6); parameters
after the updates within 1e-6 absolute (both keep the first moment in
bfloat16).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_sam_adapter_torch.configs.registry import get_config
from multimodal_sam_adapter_torch.engine import optim as topt
from multimodal_sam_adapter_torch.engine.convert import state_dict_from_jax
from multimodal_sam_adapter_torch.models.segmentor import (EncoderDecoder,
                                                            build_segmentor)
from multimodal_sam_adapter_tpu.engine import optim as jopt
from multimodal_sam_adapter_tpu.models.segmentor import (
    EncoderDecoder as JaxEncoderDecoder)

CFG = get_config("deliver_tiny")["model"]
IDX = CFG["backbone"]["interaction_indexes"]
NUM_LAYERS = CFG["backbone"]["depth"]          # 4: layer ids 0 ... 5
OPT = dict(base_lr=2e-4, weight_decay=0.05, num_layers=NUM_LAYERS,
           layer_decay_rate=0.8, steps_per_epoch=2, max_epochs=3,
           warmup_epochs=1, warmup_ratio=0.1)


@pytest.fixture(scope="module")
def jax_shapes():
    jm = JaxEncoderDecoder(num_classes=CFG["num_classes"],
                           head_channels=CFG["head_channels"],
                           backbone_cfg=CFG["backbone"])
    return jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 6)), train=False))


@pytest.fixture(scope="module")
def port_named():
    with torch.device("meta"):
        model = EncoderDecoder(CFG["num_classes"], CFG["head_channels"],
                               CFG["backbone"])
    return list(model.named_parameters())


def _to_port(params, shapes):
    stats = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                         shapes["batch_stats"])
    return state_dict_from_jax({"params": params, "batch_stats": stats}, IDX)


def _constants(tree, shapes):
    """A tree of per-leaf constants -> {port name: the constant}."""
    full = jax.tree.map(lambda c, s: np.full(s.shape, float(c), np.float32),
                        tree, shapes["params"])
    out = {}
    for name, t in _to_port(full, shapes).items():
        if name.rsplit(".", 1)[-1] in ("running_mean", "running_var",
                                       "num_batches_tracked"):
            continue
        values = torch.unique(t)
        assert len(values) == 1, name
        out[name] = values.item()
    return out


def _random(shapes, seed, std):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (rng.standard_normal(s.shape) * std).astype(np.float32),
        shapes["params"])


def test_layer_decay_scales_and_decay_flags_equal_jax(jax_shapes,
                                                      port_named):
    p = jax_shapes["params"]
    want_scale = _constants(
        jopt.layer_decay_scales(p, NUM_LAYERS, 0.8), jax_shapes)
    want_decay = _constants(jopt.weight_decay_mask(p), jax_shapes)
    got_scale = topt.layer_decay_scales(port_named, NUM_LAYERS, 0.8)
    got_decay = topt.weight_decay_mask(port_named)
    assert set(got_scale) == set(want_scale)
    for name, _ in port_named:
        assert np.float32(got_scale[name]) == want_scale[name], name
        assert float(got_decay[name]) == want_decay[name], name
    # every layer id occurs: embeddings and twin trunk, each block, the rest
    ids = {topt.vit_layer_id(n, NUM_LAYERS) for n, _ in port_named}
    assert ids == set(range(NUM_LAYERS + 2))
    assert {d for d in got_decay.values()} == {True, False}


def test_freeze_masks_equal_jax(jax_shapes, port_named):
    p = jax_shapes["params"]
    for want_tree, got in (
            (jopt.freeze_backbone_mask(p),
             topt.freeze_backbone_mask(port_named)),
            (jopt.twin_convnext_freeze_mask(p, 2),
             topt.twin_convnext_freeze_mask(port_named, 2))):
        want = _constants(want_tree, jax_shapes)
        assert {n: got[n] for n, _ in port_named} == want
        assert set(want.values()) == {0.0, 1.0}


@pytest.mark.parametrize("by_epoch", [True, False])
def test_schedule_equals_jax(by_epoch):
    kw = dict(base_lr=2e-4, steps_per_epoch=7, max_epochs=5, power=0.9,
              min_lr=1e-6, warmup_epochs=2, warmup_ratio=0.1,
              by_epoch=by_epoch)
    want = jopt.poly_schedule_with_exp_warmup(**kw)
    got = topt.poly_schedule_with_exp_warmup(**kw)
    warmup, last = 2 * 7, 5 * 7 - 1
    for step in (0, warmup - 1, warmup, last):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)


@pytest.mark.parametrize("accum,micro", [(1, 3), (2, 2), (2, 4)],
                         ids=["three_updates", "one_accumulation",
                              "two_accumulations"])
def test_updates_equal_optax(accum, micro, jax_shapes):
    """`micro` micro-batches' gradients through the optimizer with
    grad_accum_steps `accum`: the port's parameters equal optax's after
    each (three updates cross the end of the warmup and move the bf16
    first moment off zero)."""
    params = _random(jax_shapes, 0, 0.05)
    grads = [_random(jax_shapes, 1 + i, 1e-3) for i in range(micro)]
    tx = jopt.make_optimizer(params, grad_accum_steps=accum, **OPT)
    state = tx.init(params)

    @jax.jit
    def update(g, state, params):
        upd, state = tx.update(g, state, params)
        return optax.apply_updates(params, upd), state

    model = build_segmentor(dict(CFG, dropout_ratio=0.1), "cpu",
                            state_dict=_to_port(params, jax_shapes))
    opt = topt.make_optimizer(model, grad_accum_steps=accum, **OPT)
    named = dict(model.named_parameters())
    for i, g in enumerate(grads):
        params, state = update(g, state, params)
        for name, t in _to_port(g, jax_shapes).items():
            if name in named:
                t = t.clone()
                named[name].grad = (t if named[name].grad is None
                                    else named[name].grad + t)
        assert opt.step() == ((i + 1) % accum == 0)
        want = _to_port(jax.tree.map(np.asarray, params), jax_shapes)
        worst = max((named[n].detach() - want[n]).abs().max().item()
                    for n in named)
        assert worst <= 1e-6, (i, worst)
    assert opt.updates == micro // accum
