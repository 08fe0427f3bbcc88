"""The port's work counter (utils/flops.py) and its FLOPs / params tool
(tools/get_flops.py) against the JAX package's forward.

- Parameters: the port's segmentor has as many as the JAX tool's model
  (`__graft_entry__._flagship_model`, through `jax.eval_shape`), at
  `tiny=True` and at the flagship (459.05 M).
- The count does not depend on where it runs: the `meta` device and the
  CPU's plain path give the same totals at deliver_tiny's widths.
- Products outside the kernels: the convolutions and matmuls
  FlopCounterMode counts in the port equal, within 1e-6 relative, the
  `dot_general` + `conv_general_dilated` FLOPs of the JAX forward's jaxpr,
  layer group by layer group (JAX's name stack against the port's module
  path). The JAX package formulates some layers otherwise, so they are not
  compared: its LayerNorms take their moments with `dot_general`
  (`/ln`, `/norm*` scopes), its resizes are products (`_resize_hw`), the
  neck's global feature encoders fold the 1x1 and the depthwise qkv convs
  into one dense product (`gfe_*/attn`), and the SegFormer head's fusion
  conv runs on each level before the resize (`decode_head/fusion_conv`);
  the kernels' regions (the ViT attention's einsums, the MSDA sampling,
  the ConvNeXt blocks, the f1 assembly `backbone/up`) are K1-K6's.
  The compared groups and those two port layers hold every product the
  port counts. (FlopCounterMode adds an op to every module on the call
  stack, so only these disjoint groups are summed.)
- Each kernel's term is `kernel_checks.work`'s for its call, and the plain
  version's own ops are not counted on top.
- `kernel_checks.bound_ms` at the flagship shapes still gives the bounds
  of the formulas as they stood before they moved to utils/flops.py.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kernel_checks as kc
from __graft_entry__ import _flagship_model
from multimodal_sam_adapter_torch.tools import get_flops
from multimodal_sam_adapter_torch.utils import flops

REL = 1e-6
# kernel calls of one forward, by geometry
CALLS = {
    "tiny": dict(window_attention=2, flash_attention=2, msda_multi_level=4,
                 msda_single_level=6, convnext_block=24,
                 pixel_shuffle_up_bn=1),
    "flagship": dict(window_attention=20, flash_attention=4,
                     msda_multi_level=4, msda_single_level=6,
                     convnext_block=72, pixel_shuffle_up_bn=1),
}
PARAMS = {"tiny": 11_339_435, "flagship": 459_052_621}
HW = {"tiny": 64, "flagship": 1024}
# (JAX name-stack regex, port module-path regex) of the layer groups whose
# products the two packages formulate alike
GROUPS = {
    "vit_projections": (
        r"vit_block_\d+/(attn/(qkv|proj)|mlp/lin\d)$",
        r"backbone\.blocks\.\d+\.(attn\.(qkv|proj)|mlp\.lin\d)$"),
    "patch_embed": (r"backbone/patch_embed/proj$",
                    r"backbone\.patch_embed\.proj$"),
    "msda_projections": (
        r"(injector|extractor\d*)/attn/(value_proj|sampling_offsets|"
        r"attention_weights|output_proj)$",
        r"(injector|extractor|extra_extractors\.\d+)\.attn\.(value_proj|"
        r"sampling_offsets|attention_weights|output_proj)$"),
    "conv_ffn": (r"/ffn/(fc1|fc2|dwconv/dwconv)$",
                 r"\.ffn\.(fc1|fc2|dwconv\.dwconv)$"),
    "twin_stems_downsamples": (
        r"twin_conv/branch_[xy]/(stem_conv|down_conv\d)$",
        r"twin_conv\.downsample_layers_[xy]\.\d+\.\d+$"),
    "spm_fc": (r"spm/fc\d$", r"spm\.fc\d$"),
    "head_convs": (r"decode_head/(convs_\d+/conv|conv_seg)$",
                   r"decode_head\.(convs\.\d+\.conv|conv_seg)$"),
    "neck_local": (
        r"smart_fusion/local_(rgb|sne)\d+/(dw|expand|project)$",
        r"smart_fusion\.local_feature_encoder_(rgb|sne)\.\d+\."
        r"bottleneckBlock\.\d+$"),
    "neck_detail": (
        r"smart_fusion/detail\d+/",
        r"smart_fusion\.detail_feature_extractions\.\d+\."
        r"(project_in|dwconv|project_out)$"),
    "neck_fuse": (r"smart_fusion/fuse\d+/[a-z,]+->",
                  r"smart_fusion\.fuse_blocks\.\d+$"),
    "neck_enhance": (r"smart_fusion/enh",
                     r"smart_fusion\.enhance_blocks\.\d+\.conv_atten\.conv$"),
    "neck_coord_attention": (
        r"smart_fusion/ca\d+/",
        r"smart_fusion\.ca_blocks\.\d+\.coord_atten\.(conv1|conv_h|conv_w)$"),
}
# port layers formulated otherwise in JAX (see the module's docstring)
NOT_COMPARED = (r"smart_fusion\.global_feature_encoder_(rgb|sne)\.\d+\.attn$",
                r"decode_head\.fusion_conv\.conv$")


def _jax_model(geometry):
    return _flagship_model(dtype=jnp.bfloat16, tiny=geometry == "tiny")


def _jax_input(geometry):
    return jnp.zeros((1, HW[geometry], HW[geometry], 6), jnp.bfloat16)


def _jax_variables(model, img):
    return jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), img, train=False))


def _eqn_flops(e) -> float:
    """2 x multiply-adds of a dot_general or conv_general_dilated."""
    if e.primitive.name == "dot_general":
        (_, rc), (_, rb) = e.params["dimension_numbers"]
        lhs, rhs = e.invars[0].aval.shape, e.invars[1].aval.shape
        free = [d for i, d in enumerate(rhs) if i not in rc and i not in rb]
        return 2.0 * np.prod(lhs, dtype=np.float64) * np.prod(
            free, dtype=np.float64)
    if e.primitive.name == "conv_general_dilated":
        rhs = e.invars[1].aval.shape
        out_feat = rhs[e.params["dimension_numbers"].rhs_spec[0]]
        return 2.0 * np.prod(e.outvars[0].aval.shape, dtype=np.float64) * (
            np.prod(rhs, dtype=np.float64) / out_feat)
    return 0.0


def _jax_products(geometry):
    """[(name stack, FLOPs)] of every product in the JAX forward's jaxpr
    outside its resizes."""
    model, img = _jax_model(geometry), _jax_input(geometry)
    closed = jax.make_jaxpr(lambda v, x: model.apply(v, x, train=False))(
        _jax_variables(model, img), img)
    found = []

    def walk(jaxpr):
        for e in jaxpr.eqns:
            f = _eqn_flops(e)
            if f:
                found.append((str(e.source_info.name_stack), f))
            if e.params.get("name") == "_resize_hw":
                continue
            for p in e.params.values():
                sub = getattr(p, "jaxpr", p)
                if hasattr(sub, "eqns"):
                    walk(sub)
    walk(closed.jaxpr)
    return found


@pytest.fixture(scope="module", params=["tiny", "flagship"])
def counted(request):
    """(geometry, params, WorkCounter) of the port's bf16 forward on meta."""
    geometry = request.param
    n, wc = get_flops.count(
        get_flops.model_config("deliver_rgblidar", geometry == "tiny"),
        (HW[geometry], HW[geometry]))
    return geometry, n, wc


def test_params_equal_the_jax_tools(counted):
    geometry, n, _ = counted
    model, img = _jax_model(geometry), _jax_input(geometry)
    want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(
        _jax_variables(model, img)["params"]))
    assert n == want == PARAMS[geometry]


def test_kernel_calls_of_one_forward(counted):
    geometry, _, wc = counted
    assert {k: v["calls"] for k, v in wc.kernels.items()} == CALLS[geometry]
    t = wc.totals()
    assert t["flops"] == pytest.approx(
        t["products"] + t["interpolations"] + t["tensor_ops"]
        + t["other_ops"], rel=1e-12)


def test_products_outside_the_kernels_equal_the_jaxpr(counted):
    geometry, _, wc = counted
    jax_products = _jax_products(geometry)
    port = {k: sum(v for op, v in d.items()
                   if op not in flops.INTERPOLATIONS)
            for k, d in wc.modules.items() if k != "Global"}
    compared = 0.0
    for group, (jax_re, port_re) in GROUPS.items():
        want = sum(f for ns, f in jax_products if re.search(jax_re, ns))
        got = sum(v for k, v in port.items() if re.search(port_re, k))
        assert want > 0, group
        assert got == pytest.approx(want, rel=REL), group
        compared += got
    others = sum(v for k, v in port.items()
                 if any(re.search(r, k) for r in NOT_COMPARED))
    assert compared + others == pytest.approx(wc.products, rel=1e-12)


def test_meta_and_cpu_counts_are_equal():
    cfg = get_flops.model_config("deliver_rgblidar", tiny=True)
    _, meta = get_flops.count(cfg, (64, 64), "meta")
    _, cpu = get_flops.count(cfg, (64, 64), "cpu")
    m, c = meta.totals(), cpu.totals()
    assert {k: v for k, v in m.items() if k != "bytes"} == {
        k: v for k, v in c.items() if k != "bytes"}
    assert meta.kernels == cpu.kernels
    # bytes are counted by aten op, and each device makes its cached
    # constants (the MSDA reference points) with ops of its own
    assert m["bytes"] == pytest.approx(c["bytes"], rel=1e-2)


def _cpu_cases():
    g = torch.Generator().manual_seed(0)
    f32 = torch.float32
    yield "window_attention", kc.attention_case("window_attention", f32, g,
                                                heads=1)
    yield "flash_attention", kc.attention_case("flash_attention", f32, g,
                                               grid=6, heads=2)
    for name in ("msda_multi_level", "msda_single_level"):
        yield name, kc.msda_case(name, f32, g, grid=(4, 4), heads=4,
                                 points=2, value_width=16)
    yield "convnext_block", kc.convnext_case(8, 16, f32, g)
    yield "pixel_shuffle_up_bn", kc.pixel_shuffle_case((4, 4), 32, f32, g)


@pytest.mark.parametrize("name", list(kc.KERNELS))
def test_each_kernel_adds_its_work_and_nothing_else(name):
    fn, args = dict(_cpu_cases())[name]
    with torch.no_grad(), flops.WorkCounter() as wc:
        out = fn(*args)
    assert kc.work is flops.work
    want = kc.work(name, args, out)
    assert wc.kernels == {name: dict(calls=1, **want)}
    assert wc.products == wc.interpolations == 0
    assert wc.bytes == want["bytes"]


def test_a_counter_does_not_nest():
    with flops.WorkCounter():
        with pytest.raises(RuntimeError):
            flops.WorkCounter().__enter__()


# kernel_checks.bound_ms at the flagship shapes, from the formulas as they
# stood in kernel_checks.py before they moved to utils/flops.py
BOUNDS = {
    ("window_attention", "bfloat16", None): (0.011984391641791046, "bytes"),
    ("window_attention", "float32", None): (0.06428331940298508,
                                            "operations"),
    ("flash_attention", "bfloat16", None): (0.07056948287158746,
                                            "operations"),
    ("flash_attention", "float32", None): (1.0657288253134327, "operations"),
    ("msda_multi_level", "bfloat16", None): (0.009263073432835821, "bytes"),
    ("msda_multi_level", "float32", None): (0.018496802388059702, "bytes"),
    ("msda_single_level", "bfloat16", None): (0.010341482985074627, "bytes"),
    ("msda_single_level", "float32", None): (0.02063161313432836, "bytes"),
    ("convnext_block", "bfloat16", (256, 96)): (0.013146325970149253,
                                                "operations"),
    ("convnext_block", "bfloat16", (128, 192)): (0.009771159166835188,
                                                 "operations"),
    ("convnext_block", "bfloat16", (64, 384)): (0.009771159166835188,
                                                "operations"),
    ("convnext_block", "bfloat16", (32, 768)): (0.009771159166835188,
                                                "operations"),
    ("convnext_block", "float32", (256, 96)): (0.15738030232835823,
                                               "operations"),
    ("convnext_block", "float32", (128, 192)): (0.15080713934328357,
                                                "operations"),
    ("convnext_block", "float32", (64, 384)): (0.14752055785074628,
                                               "operations"),
    ("convnext_block", "float32", (32, 768)): (0.1458772671044776,
                                               "operations"),
    ("pixel_shuffle_up_bn", "bfloat16", None): (0.1389675970394338,
                                                "operations"),
    ("pixel_shuffle_up_bn", "float32", None): (2.0553341631044777,
                                               "operations"),
}


def _output_like(name, args):
    """A meta tensor of the shape and dtype of kernel `name`'s output."""
    a = args[0]
    if name in ("window_attention", "flash_attention"):
        shape = (*a.shape[:-1], a.shape[-1] // 3)
    elif name.startswith("msda"):
        shape = (*args[3].shape[:2], a.shape[-1])
    elif name == "convnext_block":
        shape = a.shape
    else:
        B, _, H, W = a.shape
        shape = (B, args[1].shape[1], 2 * H, 2 * W)
    return torch.empty(shape, dtype=a.dtype, device="meta")


def test_flagship_bounds_are_unchanged(monkeypatch):
    """The flagship cases on `meta` tensors (no data); bound_ms reads
    utils/flops.py's formula."""
    monkeypatch.setattr(kc, "_randn", lambda shape, g, dtype, scale=1.0:
                        torch.empty(shape, dtype=dtype, device="meta"))
    g = torch.Generator()
    got = {}
    for name in kc.KERNELS:
        for dtype in (torch.bfloat16, torch.float32):
            for shape in kc.flagship_shapes(name):
                _, args = kc.flagship_case(name, dtype, g, shape)
                got[(name, str(dtype).split(".")[1], shape)] = kc.bound_ms(
                    name, args, _output_like(name, args))
    assert got.keys() == BOUNDS.keys()
    for key, (ms, by) in BOUNDS.items():
        assert got[key][1] == by, key
        assert got[key][0] == pytest.approx(ms, rel=1e-12), key


def test_get_flops_prints_the_jax_tools_lines(capsys):
    n, wc = get_flops.main(["deliver_rgblidar", "--tiny", "--shape", "64",
                            "64"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "params: 11.34 M"
    assert re.fullmatch(r"flops \(fwd, batch 1, 64x64\): \d+\.\d\d GFLOPs",
                        lines[1])
    assert re.fullmatch(r"hbm bytes accessed: \d+\.\d\d GB", lines[2])
    assert lines[3].startswith("split: {")
    assert n == PARAMS["tiny"] and wc.totals()["flops"] > 0
