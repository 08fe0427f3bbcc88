"""Port parity: the Mask2Former head's modules (models/mask2former/) against
the JAX package's, float32 on the CPU, at feat 32, 8 queries, 2 decoder
and 1 encoder layers, 8 heads, 5 classes, on a 64^2 stride-4 pyramid
(64, 32, 16, 8) at batch 2.

The head's weights are a reference-layout Mask2Former state dict drawn
from a seeded numpy generator (`synth_state_dict`, the keys of the
reference checkpoint): the port loads it strictly, the JAX package reads
it through its own engine/convert_m2f.py:convert_mask2former_head. The
pixel decoder's and the decoder's outputs on the JAX side come from
flax's captured intermediates of one forward.

Tolerance rtol 1e-3 / atol 2e-4, the bar of the full-model parity tests.
The cross-attention masks are thresholds (sigmoid of a resized mask logit
> 0.5): the weights are drawn so that every resized logit of the JAX
forward lies at least `MASK_MARGIN` x max|logit| from 0, twenty times the
largest difference of the two packages' mask logits (1e-6 x max here),
and the tests assert that margin, so that a round-off difference cannot
flip a mask bit. The decoder is also
held layer by layer with JAX's masks fed in.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sam_adapter_torch.engine import convert
from multimodal_sam_adapter_torch.engine.optim import (vit_layer_id,
                                                       wants_weight_decay)
from multimodal_sam_adapter_torch.models.init import init_table, init_weights_
from multimodal_sam_adapter_torch.models.mask2former import (
    Mask2FormerHead, MaskFormerHead, MSDeformAttnPixelDecoder,
    SinePositionalEncoding, semantic_inference)
from multimodal_sam_adapter_torch.models.mask2former.positional_encoding import (  # noqa: E501
    sine_positional_encoding)
from multimodal_sam_adapter_torch.models.mask2former.transformer_decoder import (  # noqa: E501
    Mask2FormerDecoder, attention_keep)
from multimodal_sam_adapter_tpu.engine import optim as joptim
from multimodal_sam_adapter_tpu.engine.convert_m2f import (
    convert_mask2former_head)
from multimodal_sam_adapter_tpu.models import mask2former as jm2f
from multimodal_sam_adapter_tpu.models.mask2former import (
    positional_encoding as jpe)
from multimodal_sam_adapter_tpu.utils.interpolate import (
    resize_bilinear as jresize)
from tests._torch_parity import load, nchw, randomize

TOL = dict(rtol=1e-3, atol=2e-4)
C, Q, K, HEADS, POINTS = 32, 8, 5, 8, 4
N_DEC, N_ENC, FFN_ENC, FFN_DEC = 2, 1, 1024, 2048
SIZES = (64, 32, 16, 8)          # strides 4, 8, 16, 32
B = 2
MASK_MARGIN = 2e-5


def synth_state_dict(C=C, Q=Q, K=K, in_ch=C, n_dec=N_DEC, n_enc=N_ENC,
                     seed=0, std=0.2):
    """A reference-layout Mask2FormerHead state dict (the keys and shapes
    of the reference checkpoint, 3 levels, 8 heads, 4 points), every
    tensor from N(0, std) but the norm gains (1 + N(0, std))."""
    rng = np.random.default_rng(seed)
    shapes = {}

    def lin(key, o, i, bias=True):
        shapes[f"{key}.weight"] = (o, i)
        if bias:
            shapes[f"{key}.bias"] = (o,)

    def norm(key, c):
        shapes[f"{key}.weight"] = shapes[f"{key}.bias"] = (c,)

    for n in ("query_embed", "query_feat"):
        shapes[f"{n}.weight"] = (Q, C)
    shapes["level_embed.weight"] = (3, C)
    lin("cls_embed", K + 1, C)
    for j in (0, 2, 4):
        lin(f"mask_embed.{j}", C, C)
    norm("transformer_decoder.post_norm", C)
    for i in range(n_dec):
        t = f"transformer_decoder.layers.{i}"
        for a in range(2):
            shapes[f"{t}.attentions.{a}.attn.in_proj_weight"] = (3 * C, C)
            shapes[f"{t}.attentions.{a}.attn.in_proj_bias"] = (3 * C,)
            lin(f"{t}.attentions.{a}.attn.out_proj", C, C)
        for n in range(3):
            norm(f"{t}.norms.{n}", C)
        lin(f"{t}.ffns.0.layers.0.0", FFN_DEC, C)
        lin(f"{t}.ffns.0.layers.1", C, FFN_DEC)
    pd = "pixel_decoder"
    for i in range(3):
        shapes[f"{pd}.input_convs.{i}.conv.weight"] = (C, in_ch, 1, 1)
        shapes[f"{pd}.input_convs.{i}.conv.bias"] = (C,)
        norm(f"{pd}.input_convs.{i}.gn", C)
    for i in range(n_enc):
        t = f"{pd}.encoder.layers.{i}"
        lin(f"{t}.attentions.0.sampling_offsets", HEADS * 3 * POINTS * 2, C)
        lin(f"{t}.attentions.0.attention_weights", HEADS * 3 * POINTS, C)
        lin(f"{t}.attentions.0.value_proj", C, C)
        lin(f"{t}.attentions.0.output_proj", C, C)
        lin(f"{t}.ffns.0.layers.0.0", FFN_ENC, C)
        lin(f"{t}.ffns.0.layers.1", C, FFN_ENC)
        for n in range(2):
            norm(f"{t}.norms.{n}", C)
    shapes[f"{pd}.level_encoding.weight"] = (3, C)
    shapes[f"{pd}.lateral_convs.0.conv.weight"] = (C, in_ch, 1, 1)
    norm(f"{pd}.lateral_convs.0.gn", C)
    shapes[f"{pd}.output_convs.0.conv.weight"] = (C, C, 3, 3)
    norm(f"{pd}.output_convs.0.gn", C)
    shapes[f"{pd}.mask_feature.weight"] = (C, C, 1, 1)
    shapes[f"{pd}.mask_feature.bias"] = (C,)
    sd = {}
    for k, shape in shapes.items():
        v = rng.standard_normal(shape).astype(np.float32) * std
        if ("norm" in k or ".gn." in k) and k.endswith("weight"):
            v = v + 1.0
        sd[k] = v
    return sd


def _feats(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, s, s, C)).astype(np.float32)
            for s in SIZES]


def _jax_keeps(masks, memories):
    """The cross-attention masks of each decoder layer from JAX's own
    predictions (its resize, sigmoid > 0.5, the empty-mask fallback), as
    (B, Q, h * w) bool, and the smallest |resized logit| among them over
    the largest."""
    keeps, margin = [], np.inf
    for i in range(N_DEC):
        hw = memories[i % 3].shape[1:3]
        m = np.asarray(jresize(jnp.asarray(masks[i]).transpose(0, 2, 3, 1),
                               hw)).transpose(0, 3, 1, 2)
        margin = min(margin, float(np.abs(m).min() / np.abs(m).max()))
        k = np.asarray(jax.nn.sigmoid(jnp.asarray(m)) > 0.5).reshape(
            B, Q, -1)
        keeps.append(k | ~k.any(-1, keepdims=True))
    return keeps, margin


@pytest.fixture(scope="module")
def m2f():
    """The JAX head on the synthetic reference checkpoint: its tree, its
    predictions and the captured pixel-decoder / decoder outputs."""
    sd = synth_state_dict()
    tree = convert_mask2former_head(sd)
    feats = _feats()
    jh = jm2f.Mask2FormerHead(num_classes=K, feat_channels=C, num_queries=Q,
                              num_decoder_layers=N_DEC,
                              num_encoder_layers=N_ENC)

    def run(params, f):
        return jh.apply({"params": params}, f, capture_intermediates=True,
                        mutable=["intermediates"])

    with jax.default_matmul_precision("highest"):
        (cls, masks), inter = jax.jit(run)(tree, [jnp.asarray(f)
                                                  for f in feats])
    inter = inter["intermediates"]
    mf, mems = inter["pixel_decoder"]["__call__"][0]
    keeps, margin = _jax_keeps(masks, mems)
    return dict(sd=sd, tree=tree, feats=feats, head=jh,
                cls=[np.asarray(c) for c in cls],
                masks=[np.asarray(m) for m in masks],
                mask_features=np.asarray(mf),
                memories=[np.asarray(m) for m in mems],
                keeps=keeps, margin=margin)


def _port_head(sd):
    head = Mask2FormerHead(C, K, C, Q, N_DEC, N_ENC)
    head.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                         strict=True)
    return head.eval()


def test_sine_encoding_matches_jax():
    for h, w, f in ((8, 8, 16), (5, 7, 64), (32, 57, 256)):
        want = np.asarray(jpe.sine_positional_encoding(h, w, f))
        got = sine_positional_encoding(h, w, f).numpy()
        assert got.dtype == np.float32 and got.shape == (h, w, 2 * f)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    got = SinePositionalEncoding(16)(6, 4, dtype=torch.bfloat16)
    want = jpe.SinePositionalEncoding(16)(6, 4, dtype=jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_reference_checkpoint_loads_strictly(m2f):
    head = _port_head(m2f["sd"])
    assert set(head.state_dict()) == set(m2f["sd"])


def test_attention_masks_clear_the_margin(m2f):
    assert m2f["margin"] >= MASK_MARGIN, (
        f"a resized mask logit lies within {m2f['margin']:.2e} x max|logit| "
        f"of the threshold, < {MASK_MARGIN}")
    # the masks do select: some keys dropped, some kept
    share = np.mean([k.mean() for k in m2f["keeps"]])
    assert 0.05 < share < 0.95


def test_pixel_decoder_matches_jax(m2f):
    pd = MSDeformAttnPixelDecoder(C, C, N_ENC)
    sd = {k[len("pixel_decoder."):]: torch.from_numpy(v)
          for k, v in m2f["sd"].items() if k.startswith("pixel_decoder.")}
    pd.load_state_dict(sd, strict=True)
    with torch.no_grad():
        mf, mems = pd([nchw(f) for f in m2f["feats"]])
    np.testing.assert_allclose(mf.permute(0, 2, 3, 1).numpy(),
                               m2f["mask_features"], **TOL)
    assert [tuple(m.shape[-2:]) for m in mems] == [(8, 8), (16, 16),
                                                   (32, 32)]
    for got, want in zip(mems, m2f["memories"]):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                                   **TOL)


def test_decoder_layers_match_jax_given_its_masks(m2f):
    """The decoder on JAX's pixel-decoder outputs, each layer's cross-
    attention mask fed in from JAX's predictions: every layer's class and
    mask logits."""
    dec = Mask2FormerDecoder(K, C, HEADS, N_DEC, Q)
    keys = set(dec.state_dict())
    dec.load_state_dict({k: torch.from_numpy(v)
                         for k, v in m2f["sd"].items() if k in keys},
                        strict=True)
    mems = [nchw(m) for m in m2f["memories"]]
    pos = [sine_positional_encoding(m.shape[2], m.shape[3], C // 2)
           for m in mems]
    keeps = [torch.from_numpy(k) for k in m2f["keeps"]]
    with torch.no_grad():
        preds, used = dec.decode(nchw(m2f["mask_features"]), mems, pos,
                                 keeps)
    assert all(u is k for u, k in zip(used, keeps))
    assert len(preds) == N_DEC + 1
    for (cls, masks), wc, wm in zip(preds, m2f["cls"], m2f["masks"]):
        np.testing.assert_allclose(cls.numpy(), wc, **TOL)
        np.testing.assert_allclose(masks.numpy(), wm, **TOL)


def test_attention_keep_equals_jax_bias():
    """attention_keep against JAX's _attn_bias formula on logits that
    clear the margin after the resize, with a query whose mask is empty
    (kept everywhere) and one whose mask is full."""
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 6, 16, 16)).astype(np.float32) * 3
    logits[0, 1] = -np.abs(logits[0, 1]) - 0.5      # empty mask
    logits[1, 2] = np.abs(logits[1, 2]) + 0.5       # full mask
    for hw in ((8, 8), (4, 4), (16, 16), (32, 32)):
        r = np.asarray(jresize(jnp.asarray(logits).transpose(0, 2, 3, 1),
                               hw)).transpose(0, 3, 1, 2)
        keep = r.reshape(2, 6, -1) > 0
        # the margin: no resized logit within 1e-3 of 0
        near = np.abs(r) < 1e-3
        assert near.mean() < 0.01
        r_safe = np.where(near, 1.0, r)
        want = np.asarray(jax.nn.sigmoid(jnp.asarray(r_safe)) > 0.5)
        want = want.reshape(2, 6, -1)
        want = want | ~want.any(-1, keepdims=True)
        got = attention_keep(torch.from_numpy(logits), hw).numpy()
        ok = ~near.reshape(2, 6, -1)
        np.testing.assert_array_equal(got[ok], want[ok])
        assert got[0, 1].all() and not keep[0, 1].any()
        assert got[1, 2].all()


def test_head_matches_jax(m2f):
    head = _port_head(m2f["sd"])
    with torch.no_grad():
        cls, masks = head([nchw(f) for f in m2f["feats"]])
    assert len(cls) == len(masks) == N_DEC + 1
    for got, want in zip(cls, m2f["cls"]):
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    for got, want in zip(masks, m2f["masks"]):
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    for got, want in zip(head.record["attn_masks"], m2f["keeps"]):
        np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jm2f.Mask2FormerHead.semantic_inference(
        jnp.asarray(m2f["cls"][-1]), jnp.asarray(m2f["masks"][-1])))
    got = semantic_inference(cls[-1], masks[-1])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **TOL)


def test_head_takes_pinned_masks(m2f):
    """Masks pinned in place of the computed ones reach the layers: all
    keys kept changes the predictions, JAX's own masks change nothing."""
    head = _port_head(m2f["sd"])
    feats = [nchw(f) for f in m2f["feats"]]
    with torch.no_grad():
        _, ref = head(feats)
        head.pinned = {"attn_masks": [torch.from_numpy(k)
                                      for k in m2f["keeps"]]}
        _, same = head(feats)
        head.pinned = {"attn_masks": [torch.ones_like(torch.from_numpy(k))
                                      for k in m2f["keeps"]]}
        _, other = head(feats)
    assert torch.equal(same[-1], ref[-1])
    assert not torch.allclose(other[-1], ref[-1], **TOL)


def test_semantic_inference_is_float32_under_autocast():
    rng = np.random.default_rng(2)
    cls = torch.from_numpy(rng.standard_normal((2, 4, 6)).astype(np.float32))
    masks = torch.from_numpy(rng.standard_normal((2, 4, 5, 5)).astype(
        np.float32))
    want = semantic_inference(cls, masks)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = semantic_inference(cls.bfloat16(), masks.bfloat16())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), semantic_inference(cls.bfloat16(),
                                        masks.bfloat16()).numpy())
    assert want.shape == (2, 5, 5, 5)


def test_maskformer_head_matches_jax():
    feats = _feats(seed=3)
    jh = jm2f.MaskFormerHead(num_classes=K, feat_channels=C, num_queries=Q,
                             num_decoder_layers=2)
    jf = [jnp.asarray(f) for f in feats]
    v = randomize(jax.jit(jh.init)(jax.random.PRNGKey(0), jf), 7, std=0.2)
    with jax.default_matmul_precision("highest"):
        cls, masks = jax.jit(jh.apply)(v, jf)
    th = load(MaskFormerHead(C, K, C, Q, 2),
              convert.maskformer_head(v["params"], "m"))
    with torch.no_grad():
        got_cls, got_masks = th([nchw(f) for f in feats])
    np.testing.assert_allclose(got_cls[0].numpy(), np.asarray(cls[0]), **TOL)
    np.testing.assert_allclose(got_masks[0].numpy(), np.asarray(masks[0]),
                               **TOL)
    # the names the Mask2Former keys give the modules both heads have
    names = set(th.state_dict())
    assert "transformer_decoder.post_norm.weight" in names
    assert "transformer_decoder.layers.1.attentions.0.attn.in_proj_weight" \
        in names
    assert not any("encoder.layers" in n for n in names)


# ---------------------------------------------------------------- the bridge

@pytest.fixture(scope="module")
def jax_init():
    """JAX's own init of the head, twice (keys 0 and 1)."""
    jh = jm2f.Mask2FormerHead(num_classes=K, feat_channels=C, num_queries=Q,
                              num_decoder_layers=N_DEC,
                              num_encoder_layers=N_ENC)
    jf = [jnp.zeros((1, s, s, C)) for s in SIZES]
    init = jax.jit(jh.init)
    return [jax.tree_util.tree_map(np.asarray,
                                   init(jax.random.PRNGKey(k), jf)["params"])
            for k in (0, 1)]


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_bridge_round_trip_gives_jax_tree_back(jax_init):
    tree = randomize(jax_init[0], 11)
    sd = convert.to_state_dict(convert.mask2former_head(tree, "decode_head"))
    ref = {k[len("decode_head."):]: v.numpy() for k, v in sd.items()}
    back = dict(_leaves(convert_mask2former_head(ref)))
    want = dict(_leaves(tree))
    assert set(back) == set(want)
    for path, v in want.items():
        np.testing.assert_array_equal(back[path], v, err_msg=str(path))
    # every key the bridge emits is one the converter consumes: without it
    # the conversion fails or loses a leaf
    for key in ref:
        part = {k: v for k, v in ref.items() if k != key}
        try:
            lost = set(want) - set(dict(_leaves(
                convert_mask2former_head(part))))
        except KeyError:
            continue
        assert lost, f"{key} is not read by convert_mask2former_head"
    # and the port's module holds exactly those keys
    head = Mask2FormerHead(C, K, C, Q, N_DEC, N_ENC)
    assert set(head.state_dict()) == set(ref)


def test_jax_init_rules_cover_every_head_parameter(jax_init):
    """init="jax": each parameter drawn by the rule of its JAX counterpart.
    Deterministic JAX initializers (equal under two keys: zeros, ones, the
    MSDA offset grid) are matched exactly; random ones by their standard
    deviation (within 25%, every such tensor here has >= 96 entries)."""
    a, b = ({k[2:]: v for k, v in convert.mask2former_head(t, "m")}
            for t in jax_init)
    head = Mask2FormerHead(C, K, C, Q, N_DEC, N_ENC)
    table = init_table(head, {})
    assert set(table) == set(a)
    init_weights_(head, {}, torch.Generator().manual_seed(0))
    for name, p in head.named_parameters():
        got = p.detach().numpy()
        if np.array_equal(a[name], b[name]):
            np.testing.assert_array_equal(got, a[name], err_msg=name)
        else:
            want = np.std(np.concatenate([a[name].ravel(), b[name].ravel()]))
            assert abs(got.std() / want - 1) < 0.25, (name, got.std(), want)
            assert table[name].kind in ("normal", "trunc_normal"), name


def test_optimizer_groups_equal_jax_on_the_head(jax_init):
    """Layer ids and weight decay of every head parameter, by the port's
    rules on its names, equal JAX's rules on the leaves that the bridge
    maps to it (the packed in_proj on the three q / k / v leaves)."""
    num_layers = 24
    leaves = list(_leaves(jax_init[0]))
    ids = {path: np.full(v.shape, i, np.float32)
           for i, (path, v) in enumerate(leaves)}

    def nest(flat):
        tree = {}
        for path, v in flat.items():
            node = tree
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = v
        return tree

    head = Mask2FormerHead(C, K, C, Q, N_DEC, N_ENC)
    params = dict(head.named_parameters())
    for name, arr in convert.mask2former_head(nest(ids), "decode_head"):
        p = params[name[len("decode_head."):]]
        paths = [leaves[int(i)][0] for i in np.unique(arr)]
        for path in paths:
            jpath = "decode_head/" + "/".join(path)
            leaf = dict(leaves)[path]
            assert vit_layer_id(name, num_layers) == joptim.vit_layer_id(
                jpath, num_layers) == num_layers + 1, name
            assert wants_weight_decay(name, p) == \
                joptim.wants_weight_decay(jpath, leaf), (name, jpath)
