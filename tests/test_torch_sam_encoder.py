"""The standalone SAM image encoder (models/sam_vit.py:ImageEncoderViT) in
the port against the JAX package's, float32 on the CPU.

A SAM-layout state dict, built as tests/test_sam_parity.py:make_sam_state
builds one, with the `image_encoder.` prefix and a `neck.*` entry as a
SAM checkpoint holds them, reaches the JAX module through
convert_sam_encoder(sd, standalone=True) and the port through
engine/checkpoint.py:ingest_sam_pth(path, standalone=True):

- tokens and grid equal, rtol 1e-3 / atol 2e-4 (tests/test_torch_model.py's
  bar), on make_sam_state's own 2 x 2 grid and on a 6 x 6 grid with
  windows of 4 (padded) and one global block;
- off the pretrained grid: a 128 x 112 input on the 96^2 weights (an
  8 x 7 grid), the position embedding resized bicubically in both, the
  global block's rel-pos tables resized;
- the port's map of a JAX ImageEncoderViT tree (engine/convert.py:
  sam_encoder) gives the state dict ingestion gives; the port loads it
  strictly; ingestion drops `neck.*` and refuses a key it does not know;
- the tensor-parallel forward of the 6 x 6 encoder on two gloo ranks
  (tests/_torch_ddp_worker.py's `tp` task), each rank's tokens against
  the JAX forward at the same tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_sam_adapter_torch.engine.checkpoint import ingest_sam_pth
from multimodal_sam_adapter_torch.engine.convert import sam_encoder
from multimodal_sam_adapter_torch.models.sam_vit import ImageEncoderViT
from multimodal_sam_adapter_tpu.engine.convert import convert_sam_encoder
from multimodal_sam_adapter_tpu.models.sam_vit import (
    ImageEncoderViT as JaxImageEncoderViT)
from tests import _torch_ddp_worker as w
from tests._torch_parity import nchw
from tests.test_sam_parity import (DEPTH, IMG, NH, PATCH, WIN,
                                   make_sam_state)

TOL = dict(rtol=1e-3, atol=2e-4)
ENC = w.TINY_ENCODER


def sam_layout(rng, grid, depth, dim, heads, window, global_idx):
    """make_sam_state's layout at another size: every block's rel-pos
    tables of 2 x window - 1 rows (2 x grid - 1 for the global ones)."""
    def t(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.2

    sd = {"pos_embed": t(1, grid, grid, dim),
          "patch_embed.proj.weight": t(dim, 3, PATCH, PATCH),
          "patch_embed.proj.bias": t(dim)}
    for i in range(depth):
        win = grid if i in global_idx else window
        for n in ("norm1", "norm2"):
            sd[f"blocks.{i}.{n}.weight"] = 1 + t(dim) * 0.1
            sd[f"blocks.{i}.{n}.bias"] = t(dim)
        for n, shape in (("attn.qkv", (3 * dim, dim)),
                         ("attn.proj", (dim, dim)),
                         ("mlp.lin1", (4 * dim, dim)),
                         ("mlp.lin2", (dim, 4 * dim))):
            sd[f"blocks.{i}.{n}.weight"] = t(*shape)
            sd[f"blocks.{i}.{n}.bias"] = t(shape[0])
        for n in ("rel_pos_h", "rel_pos_w"):
            sd[f"blocks.{i}.attn.{n}"] = t(2 * win - 1, dim // heads)
    return sd


def sam_file(sd, path):
    """`sd` saved as a whole SAM checkpoint saves its encoder: under
    `image_encoder.`, beside a neck and a mask decoder key."""
    full = {"image_encoder." + k: torch.from_numpy(v) for k, v in sd.items()}
    full["image_encoder.neck.0.weight"] = torch.zeros(4, 4, 1, 1)
    full["mask_decoder.iou_token.weight"] = torch.zeros(1, 4)
    torch.save(full, path)
    return str(path)


def jax_forward(sd, x, **cfg):
    model = JaxImageEncoderViT(**cfg)
    params = convert_sam_encoder(sd, standalone=True)
    with jax.default_matmul_precision("highest"):
        tokens, Hp, Wp = model.apply({"params": params}, jnp.asarray(x))
    return np.asarray(tokens), (Hp, Wp), params


def port_encoder(path, **cfg):
    model = ImageEncoderViT(**cfg)
    model.load_state_dict(ingest_sam_pth(path, standalone=True), strict=True)
    return model.eval()


CASES = {
    # make_sam_state itself: 2 x 2 grid, window 2, block 1 global
    "sam_parity": (dict(patch_size=PATCH, embed_dim=16, depth=DEPTH,
                        num_heads=NH, window_size=WIN,
                        global_attn_indexes=(1,), pretrained_size=IMG),
                   (IMG, IMG)),
    "padded_windows": (ENC, (96, 96)),
    "off_grid": (ENC, (128, 112)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_encoder_matches_jax(case, tmp_path):
    cfg, (H, W) = CASES[case]
    rng = np.random.default_rng(7)
    if case == "sam_parity":
        sd = make_sam_state(rng)
    else:
        sd = sam_layout(rng, cfg["pretrained_size"] // PATCH, cfg["depth"],
                        cfg["embed_dim"], cfg["num_heads"],
                        cfg["window_size"], cfg["global_attn_indexes"])
    x = rng.standard_normal((2, H, W, 3)).astype(np.float32)
    want, grid, params = jax_forward(sd, x, **cfg)
    model = port_encoder(sam_file(sd, tmp_path / "sam.pth"), **cfg)
    with torch.no_grad():
        got, Hp, Wp = model(nchw(x))
    assert (Hp, Wp) == grid == (H // PATCH, W // PATCH)
    if case == "off_grid":
        assert grid != (cfg["pretrained_size"] // PATCH,) * 2
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the JAX tree through the port's map: the state dict ingestion gives
    mapped = sam_encoder(params)
    assert mapped.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        assert torch.equal(mapped[k], v), k


def test_ingestion_is_strict(tmp_path):
    sd = make_sam_state(np.random.default_rng(1))
    got = ingest_sam_pth(sam_file(sd, tmp_path / "sam.pth"), standalone=True)
    assert sorted(got) == sorted(sd)             # neck and decoder dropped
    adapter = ingest_sam_pth(sam_file(sd, tmp_path / "sam.pth"),
                             ((0, 0), (1, 1)))
    assert sorted(adapter) == sorted("backbone." + k for k in sd)
    cfg = CASES["sam_parity"][0]
    model = ImageEncoderViT(**cfg)
    missing = dict(got)
    missing.pop("blocks.1.mlp.lin2.bias")
    with pytest.raises(RuntimeError, match="Missing key"):
        model.load_state_dict(missing, strict=True)
    bad = dict(sd, **{"blocks.0.attn.extra": np.zeros(2, np.float32)})
    with pytest.raises(KeyError, match="unmapped ViT block key"):
        ingest_sam_pth(sam_file(bad, tmp_path / "bad.pth"), standalone=True)
    bad = dict(sd, cls_token=np.zeros(2, np.float32))
    with pytest.raises(KeyError, match="unmapped SAM encoder key"):
        ingest_sam_pth(sam_file(bad, tmp_path / "bad.pth"), standalone=True)


def test_tensor_parallel_encoder_matches_jax(tmp_path):
    rng = np.random.default_rng(11)
    sd = sam_layout(rng, ENC["pretrained_size"] // PATCH, ENC["depth"],
                    ENC["embed_dim"], ENC["num_heads"], ENC["window_size"],
                    ENC["global_attn_indexes"])
    x = rng.standard_normal((2, 96, 96, 3)).astype(np.float32)
    want, _, _ = jax_forward(sd, x, **ENC)
    torch.save(ingest_sam_pth(sam_file(sd, tmp_path / "sam.pth"),
                              standalone=True), tmp_path / "sd.pt")
    torch.save(nchw(x), tmp_path / "x.pt")
    ranks = w.spawn("tp", tmp_path, tmp_path / "sd.pt", tmp_path / "x.pt",
                    "encoder", world=2)
    for r in ranks:
        assert r["grid"] == (6, 6)
        # each block's attention and MLP end in one all-reduce
        assert r["all_reduces"] == 2 * ENC["depth"]
        assert r["heads"] == [ENC["num_heads"] // 2] * ENC["depth"]
        np.testing.assert_allclose(r["tokens"].numpy(), want, **TOL)
