"""bf16 MSDA reference points: the port keeps them float32 (K3 / K4 take
float32 points, models/adapter.py:_reference_points), the JAX package
rounds them to the compute dtype in the injector and the extractor
(multimodal_sam_adapter_tpu/models/adapter.py, `.astype(query.dtype)`)
and in the Mask2Former pixel decoder.

- On a grid side that is a power of two up to 128 the points (2k + 1) /
  (2 side) hold at most 8 significant bits, so bf16 holds them exactly:
  deliver_tiny's 64^2 and the flagship's 1024^2 (a 64 grid, a 128 / 64 /
  32 pyramid) round nothing. FMB's 800^2 (a 50 grid) does, by up to
  2^-9 of [0, 1].
- Where they round (deliver_tiny's widths at 96^2: a 6 grid, a 12 / 6 / 3
  pyramid, shifts up to 1.3e-3), each package's bf16 logits with rounded
  and with float32 points (JAX's given to its MSDeformAttention through
  flax's method interceptor, nothing in the JAX package changed; the
  port's through its `_reference_points`) and the port's against JAX's
  stay within the repo's bf16 bar (kernel_checks.TOLERANCES, 1e-2 of
  max|logits|), every class alike. Measured on the CPU, one torch
  thread, in two runs (XLA's host devices 1 and 8): each package's own
  spread 0 or 1.7e-3, the port 1.7e-3 or 4.8e-3 from JAX either way, one
  or two bf16 steps of the largest logit. The port stays float32 on
  purpose.
"""
import flax.linen as nn
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from multimodal_sam_adapter_torch.configs.registry import get_config
from multimodal_sam_adapter_torch.engine.convert import state_dict_from_jax
from multimodal_sam_adapter_torch.models import adapter as port_adapter
from multimodal_sam_adapter_torch.models.adapter import reference_points
from multimodal_sam_adapter_torch.models.segmentor import build_segmentor
from multimodal_sam_adapter_tpu.engine.convert_full import (
    convert_full_checkpoint)
from multimodal_sam_adapter_tpu.models import adapter as jax_adapter
from multimodal_sam_adapter_tpu.models.segmentor import (
    EncoderDecoder as JaxEncoderDecoder)
from multimodal_sam_adapter_tpu.nn import layers as jax_layers
from multimodal_sam_adapter_tpu.ops.msda import MSDeformAttention
from tests.test_convert_full import synth_state_dict


def _rounding(shapes):
    r = reference_points(shapes)
    return float(np.abs(r - r.astype(ml_dtypes.bfloat16).astype(
        np.float32)).max())


def _geometry(side, patch=16):
    """The injector's query grid and the pyramid of a side^2 input."""
    g = side // patch
    return [(g, g)], [(2 * g, 2 * g), (g, g), (g // 2, g // 2)]


@pytest.mark.parametrize("side,exact", [(64, True), (1024, True),
                                        (800, False), (96, False)])
def test_bf16_rounds_the_points_only_off_power_of_two_grids(side, exact):
    for shapes in _geometry(side):
        err = _rounding(shapes)
        assert (err == 0) == exact, (side, shapes, err)
        assert err <= 2.0 ** -9


def _f32_points(next_fun, args, kwargs, context):
    """JAX's MSDeformAttention called with the exact float32 points of its
    injector's / extractor's query grid in place of the rounded ones."""
    mod = context.module
    if isinstance(mod, MSDeformAttention) and context.method_name == (
            "__call__"):
        parent = mod.parent
        shapes = ([parent.query_hw] if isinstance(
            parent, jax_adapter.Injector) else parent.query_shapes)
        ref = jnp.broadcast_to(jnp.asarray(
            jax_adapter.reference_points(shapes)), args[1].shape)
        args = (args[0], ref.astype(jnp.float32)) + tuple(args[2:])
    return next_fun(*args, **kwargs)


@pytest.fixture
def one_thread():
    """One torch thread: multi-threaded bf16 reductions are not
    reproducible from one thread count to another. The process's count
    is restored after the test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_port_bf16_logits_against_jax_rounded_and_float32_points(
        monkeypatch, one_thread):
    side = 96
    # the port's GELU is exact erf in every dtype; JAX's bf16 one tanh
    monkeypatch.setattr(jax_layers, "_FORCE_EXACT_GELU", True)
    m = get_config("deliver_tiny")["model"]
    bcfg = dict(m["backbone"], img_size=side, pretrained_size=side)
    assert _rounding(_geometry(side)[1]) > 1e-3
    sd = synth_state_dict(cfg=bcfg, head_ch=m["head_channels"],
                          ncls=m["num_classes"])
    for k in sd:
        if k.endswith("running_var"):
            sd[k] = np.abs(sd[k]) + 0.5
    tree = convert_full_checkpoint(sd, bcfg["interaction_indexes"])
    x = (np.random.default_rng(0).standard_normal((2, side, side, 6))
         * 0.5).astype(np.float32)
    jm = JaxEncoderDecoder(num_classes=m["num_classes"],
                           head_channels=m["head_channels"],
                           backbone_cfg=bcfg, dtype=jnp.bfloat16)
    variables = {"params": tree["params"],
                 "batch_stats": tree["batch_stats"]}
    xb = jnp.asarray(x, jnp.bfloat16)

    def forward():
        return np.asarray(jax.jit(lambda v, xx: jm.apply(
            v, xx, train=False))(variables, xb), np.float32)

    rounded = forward()
    with nn.intercept_methods(_f32_points):
        exact = forward()
    model = build_segmentor(
        dict(m, backbone=bcfg), "cpu", state_dict=state_dict_from_jax(
            tree, bcfg["interaction_indexes"])).to(torch.bfloat16)

    def port_forward():
        with torch.no_grad():
            return model(torch.from_numpy(x).to(
                torch.bfloat16)).float().numpy()

    port = port_forward()
    f32_points = port_adapter._reference_points
    monkeypatch.setattr(port_adapter, "_reference_points",
                        lambda *a: f32_points(*a).to(torch.bfloat16).float())
    port_rounded = port_forward()

    scale = np.abs(exact).max()

    def dist(a, b):
        return np.abs(a - b).max() / scale

    # the repo's bf16 bar (kernel_checks.TOLERANCES)
    for a, b in ((rounded, exact), (port_rounded, port), (port, rounded),
                 (port, exact)):
        assert dist(a, b) <= 1e-2
        assert (a.argmax(-1) == b.argmax(-1)).mean() >= 0.99
