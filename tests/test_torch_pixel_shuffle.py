"""K6 on the CPU: the port's plain fused f1 assembly against the JAX
package's Pallas kernel (interpret mode), the port's eval backbone (whose
f1 goes through K6) against the JAX backbone with its own fused f1
(MSA_UP_FUSED=1, forced onto the Pallas path in interpret mode), and the
fused f1 against the module composition it replaces.

The JAX kernel takes NHWC maps and the (C, 2, 2, O) dot-ready weight; the
port takes NCHW maps and torch's ConvTranspose2d weight (C, O, 2, 2), the
same values transposed. Tolerances: the op at 1e-4 (float32 sums in
another order); the backbone at rtol 1e-3 / atol 2e-4, the full-model bar.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_sam_adapter_torch.models.backbone as tbackbone
from multimodal_sam_adapter_torch.engine.convert import state_dict_from_jax
from multimodal_sam_adapter_torch.models.segmentor import build_segmentor
from multimodal_sam_adapter_torch.ops import kernels
from multimodal_sam_adapter_torch.ops.pixel_shuffle import (
    pixel_shuffle_up_bn, pixel_shuffle_up_bn_plain)
from multimodal_sam_adapter_tpu.engine.convert_full import (
    convert_full_checkpoint)
from multimodal_sam_adapter_tpu.models.segmentor import (
    EncoderDecoder as JaxEncoderDecoder)
from multimodal_sam_adapter_tpu.ops.pixel_shuffle import (
    pixel_shuffle_up_bn as jax_pixel_shuffle_up_bn)
from tests._torch_parity import nchw, nhwc
from tests.test_convert_full import HEAD_CH, IMG, NCLS, synth_state_dict
from tests.test_model_forward import TINY_BACKBONE

TOL = dict(rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("B,H,W,C,O", [(1, 4, 4, 16, 8), (2, 3, 5, 24, 16)])
def test_plain_matches_pallas_kernel(B, H, W, C, O):
    r = np.random.default_rng(C + O)
    c2 = r.standard_normal((B, H, W, C)).astype(np.float32)
    weight = (r.standard_normal((C, O, 2, 2)) * C ** -0.5).astype(np.float32)
    c1 = r.standard_normal((B, 2 * H, 2 * W, O)).astype(np.float32)
    x1 = r.standard_normal((B, 2 * H, 2 * W, O)).astype(np.float32)
    scale = (1 + 0.5 * r.standard_normal(O)).astype(np.float32)
    shift = r.standard_normal(O).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_pixel_shuffle_up_bn(
            jnp.asarray(c2), jnp.asarray(weight.transpose(0, 2, 3, 1)),
            jnp.asarray(c1), jnp.asarray(x1), jnp.asarray(scale),
            jnp.asarray(shift), interpret=True))
    args = (nchw(c2), torch.from_numpy(weight), nchw(c1), nchw(x1),
            torch.from_numpy(scale), torch.from_numpy(shift))
    kernels.reset_launches()
    got = pixel_shuffle_up_bn(*args)
    assert kernels.LAUNCHES["pixel_shuffle_up_bn"] == 0  # CPU: plain
    torch.testing.assert_close(got, pixel_shuffle_up_bn_plain(*args))
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def tiny_models():
    sd = synth_state_dict()
    for k in sd:
        if k.endswith("running_var"):
            sd[k] = np.abs(sd[k]) + 0.5
    idx = TINY_BACKBONE["interaction_indexes"]
    tree = convert_full_checkpoint(sd, idx)
    port = build_segmentor(
        dict(num_classes=NCLS, head_channels=HEAD_CH, backbone=TINY_BACKBONE),
        "cpu", state_dict=state_dict_from_jax(tree, idx))
    jm = JaxEncoderDecoder(num_classes=NCLS, head_channels=HEAD_CH,
                           backbone_cfg=TINY_BACKBONE)
    variables = {"params": tree["params"], "batch_stats": tree["batch_stats"]}
    x = (np.random.default_rng(3).standard_normal((1, IMG, IMG, 6))
         * 0.5).astype(np.float32)
    return port, jm, variables, x


def test_eval_backbone_matches_jax_fused_f1(tiny_models, monkeypatch):
    port, jm, variables, x = tiny_models
    monkeypatch.setenv("MSA_UP_FUSED", "1")
    monkeypatch.setenv("MSA_FORCE_TPU_IMPL", "1")
    monkeypatch.setenv("MSA_PALLAS_INTERPRET", "1")
    with jax.default_matmul_precision("highest"):
        want = jm.apply(variables, jnp.asarray(x), train=False,
                        method=jm.features)
    with torch.no_grad():
        got = port.backbone(torch.from_numpy(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_fused_f1_gives_the_logits_of_the_composition(tiny_models,
                                                      monkeypatch):
    """The state_dict loads strictly (the fixture) and the folded BN affine
    reproduces norm1(up(c2) + c1 + x1) through the whole model."""
    port, _, _, x = tiny_models
    xt = torch.from_numpy(x)
    with torch.no_grad():
        fused = port(xt)
    bb = port.backbone

    def composed(c2, weight, c1, x1, scale, shift):
        assert weight is bb.up.weight
        return bb.norm1(bb.up(c2) + c1 + x1)

    monkeypatch.setattr(tbackbone, "pixel_shuffle_up_bn", composed)
    with torch.no_grad():
        want = port(xt)
    torch.testing.assert_close(fused, want, rtol=1e-5, atol=1e-5)
