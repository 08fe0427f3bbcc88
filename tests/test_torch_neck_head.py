"""Port parity: the twin ConvNeXt, the RoadFormer2 fusion neck and the
SegFormer head against the JAX package, float32 on the CPU, with every
parameter drawn from a seeded generator and carried by the weight bridge.

Tolerance 1e-4 relative / 1e-5 absolute: the same float32 convolutions,
norms and channel attentions summed in another order (the JAX neck also
runs its grouped convs as block-diagonal dense convs, and its head fuses
the concat conv before the resize; both are equal in exact arithmetic).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from multimodal_sam_adapter_torch.engine import convert
from multimodal_sam_adapter_torch.models.fusion_neck import RoadFormer2Neck
from multimodal_sam_adapter_torch.models.segformer_head import SegformerHead
from multimodal_sam_adapter_torch.models.twin_convnext import TwinConvNeXt
from multimodal_sam_adapter_tpu.models import fusion_neck as jneck
from multimodal_sam_adapter_tpu.models import segformer_head as jhead
from multimodal_sam_adapter_tpu.models import twin_convnext as jtwin
from tests._torch_parity import load, nchw, nhwc, randomize

TOL = dict(rtol=1e-4, atol=1e-5)
ATTO = (40, 80, 160, 320)


def _feats(chans, sizes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, s, s, c)).astype(np.float32)
            for c, s in zip(chans, sizes)]


def test_twin_convnext_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    y = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    jm = jtwin.TwinConvNeXt(arch="atto")
    v = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                          jnp.asarray(y)), 1)
    with jax.default_matmul_precision("highest"):
        want = jm.apply(v, jnp.asarray(x), jnp.asarray(y))
    p = v["params"]
    pairs = [*convert.convnext_branch(p["branch_x"], "m", "x"),
             *convert.convnext_branch(p["branch_y"], "m", "y")]
    tm = load(TwinConvNeXt("atto"), pairs)
    with torch.no_grad():
        got = tm(nchw(x), nchw(y))
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_fusion_neck_matches_jax():
    chans = [2 * c for c in ATTO]
    sizes = (16, 8, 4, 2)
    feats = _feats(chans, sizes, seed=2)
    jm = jneck.RoadFormer2Neck(in_channels=chans)
    jf = [jnp.asarray(f) for f in feats]
    v = randomize(jm.init(jax.random.PRNGKey(0), jf, train=False), 3,
                  std=0.2)
    with jax.default_matmul_precision("highest"):
        want = jm.apply(v, jf, train=False)
    tm = load(RoadFormer2Neck(chans, [s * s for s in sizes]),
              convert.fusion_neck(v["params"], v["batch_stats"], "m"))
    with torch.no_grad():
        got = tm([nchw(f) for f in feats])
    # the neck's outputs reach |30| at these weights: absolute float32
    # rounding of ~1e-6 relative
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_segformer_head_matches_jax():
    feats = _feats([32] * 4, (16, 8, 4, 2), seed=4)
    jm = jhead.SegformerHead(num_classes=7, channels=16)
    jf = [jnp.asarray(f) for f in feats]
    v = randomize(jm.init(jax.random.PRNGKey(0), jf, train=False), 5,
                  std=0.2)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jm.apply(v, jf, train=False))
    tm = load(SegformerHead(32, 7, 16),
              convert.segformer_head(v["params"], v["batch_stats"], "m"))
    with torch.no_grad():
        got = nhwc(tm([nchw(f) for f in feats]))
    assert got.shape == want.shape == (2, 16, 16, 7)
    np.testing.assert_allclose(got, want, **TOL)
