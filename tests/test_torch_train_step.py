"""The port's train step on the CPU at deliver_tiny's geometry: activation
checkpointing with drop path on, the keyed dropout masks, and the step's
accumulate-then-update cycle (engine/train.py).

torch.utils.checkpoint restores torch's default generators for its
recompute, not an explicit generator: a mask drawn from one would differ
between the forward and the recompute and the gradient would be silently
wrong. The masks here are functions of (key, module), so a checkpointed
loss and an uncheckpointed one give equal gradients; the recompute also
leaves the BatchNorm running statistics as the forward left them.
"""
import copy

import pytest
import torch

from multimodal_sam_adapter_torch.configs.registry import get_config
from multimodal_sam_adapter_torch.engine.train import (init_train_state,
                                                       make_train_step)
from multimodal_sam_adapter_torch.models.segmentor import build_segmentor
from multimodal_sam_adapter_torch.nn.layers import (DropPath, KeyedDropout,
                                                    fold_in, set_dropout_key)
from multimodal_sam_adapter_torch.ops import (convnext_block, flash_attention,
                                              kernels, msda_cuda,
                                              pixel_shuffle, window_attention)

MODEL = get_config("deliver_tiny")["model"]
# rates high enough that every kind of mask drops something at batch 2
DROPPY = dict(MODEL, dropout_ratio=0.3, backbone=dict(
    MODEL["backbone"], drop_path_rate=0.5, conv_drop_path_rate=0.5,
    drop_rate=0.2))


def _batch(seed=0, B=2):
    g = torch.Generator().manual_seed(seed)
    gt = torch.randint(0, MODEL["num_classes"], (B, 64, 64), generator=g)
    gt[torch.rand((B, 64, 64), generator=g) < 0.1] = 255
    return torch.randn((B, 64, 64, 6), generator=g), gt


def _loss_and_grads(model, key):
    model.zero_grad(set_to_none=True)
    set_dropout_key(model, key)
    img, gt = _batch()
    loss, _ = model.loss(img, gt)
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in model.named_parameters()}


def test_checkpointed_and_plain_losses_give_equal_gradients():
    cp = build_segmentor(DROPPY, "cpu",
                         generator=torch.Generator().manual_seed(0)).train()
    plain = copy.deepcopy(cp)
    plain.backbone.with_cp = False
    assert cp.backbone.with_cp
    loss_cp, g_cp = _loss_and_grads(cp, 7)
    loss_plain, g_plain = _loss_and_grads(plain, 7)
    torch.testing.assert_close(loss_cp, loss_plain, rtol=0, atol=0)
    for name in g_plain:
        torch.testing.assert_close(g_cp[name], g_plain[name], rtol=1e-6,
                                   atol=1e-9, msg=name)
    for name, buf in plain.named_buffers():
        torch.testing.assert_close(cp.get_buffer(name), buf, rtol=0, atol=0,
                                   msg=name)
    # the masks are live: another key, another loss
    loss_other, _ = _loss_and_grads(plain, 8)
    assert loss_other != loss_plain


def test_masks_are_functions_of_the_key():
    x = torch.ones(8, 3, 5)
    drop, path = KeyedDropout(0.5), DropPath(0.5)
    for m in (drop, path):
        with pytest.raises(RuntimeError, match="dropout key"):
            m(x)
        m.seed = fold_in(3, 0)
        a, b = m(x), m(x)
        assert torch.equal(a, b) and set(a.unique().tolist()) == {0.0, 2.0}
        m.seed = fold_in(3, 1)
        assert not torch.equal(m(x), a)
        m.eval()
        assert m(x) is x
    # drop path drops whole samples
    m = DropPath(0.5).train()
    m.seed = fold_in(0, 0)
    y = m(x)
    assert all(len(y[i].unique()) == 1 for i in range(8))
    model = build_segmentor(DROPPY, "cpu",
                            generator=torch.Generator().manual_seed(0))
    set_dropout_key(model, 5)
    seeds = [m.seed for m in model.modules()
             if isinstance(m, KeyedDropout)]
    # the extractors' and blocks' drop paths, the token and head dropouts
    assert len(seeds) == len(set(seeds)) > 2 * 12 + 6
    assert fold_in(5, 0) == seeds[0] and fold_in(5, 1) != fold_in(6, 1)


def test_train_step_accumulates_then_updates():
    """grad_accum_steps 2: the first micro-batch only accumulates (the
    parameters stay, the gradients are kept), the second updates every
    parameter and clears the gradients; every micro-batch moves the
    BatchNorm running statistics. Weights from `random_init_`: the JAX
    init zeroes gates (the neck's local-encoder scales) behind which some
    parameters get no gradient at all. A conv bias in front of a
    train-mode BatchNorm has a true gradient of 0 (the norm takes away any
    shift of a channel): its computed gradient is round-off, and Adam's
    step from it (~lr x g / eps) may round away. Such a bias may stay put,
    and only when its whole step is within half an ulp of its value."""
    cfg = get_config("deliver_tiny")
    state = init_train_state(cfg["model"], "cpu", seed=0,
                             optimizer_kwargs=dict(cfg["optimizer"],
                                                   grad_accum_steps=2),
                             init="random")
    model = state.model
    assert model.training
    step = make_train_step(model, state.optimizer)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats = {n: b.clone() for n, b in model.named_buffers()
             if n.endswith("running_mean")}
    img, gt = _batch(1)
    out = step(state, dict(img=img, gt=gt))
    assert not out["updated"] and torch.isfinite(out["loss"])
    assert state.step == 1
    for n, p in model.named_parameters():
        assert torch.equal(p, params[n]) and p.grad is not None, n
    for n, b in stats.items():
        assert not torch.equal(model.get_buffer(n), b), n
    grads = {}
    state.optimizer.register_step_pre_hook(lambda *_: grads.update(
        {n: p.grad.clone() for n, p in model.named_parameters()}))
    out = step(state, dict(img=img, gt=gt))
    assert out["updated"] and state.step == 2
    assert state.optimizer.updates == 1
    opt = state.optimizer
    for n, p in model.named_parameters():
        assert p.grad is None, n
        if torch.equal(p, params[n]):
            # the bias of a conv whose output a BatchNorm takes, and a
            # step within half an ulp (p.sub_ rounds back to p)
            conv = model.get_submodule(n.rsplit(".", 1)[0])
            assert n.endswith(".bias") and isinstance(conv, torch.nn.Conv2d)
            group = next(g for g in opt.param_groups
                         if any(q is p for q in g["params"]))
            g = grads[n] / opt.grad_accum_steps
            b1, b2 = opt.betas
            mu = (1 - b1) * g / (1 - b1)
            nu = (1 - b2) * g * g / (1 - b2)
            step_size = opt.schedule(0) * group["lr_scale"] * (
                mu / (nu.sqrt() + opt.eps) + group["weight_decay"] * p)
            a = p.detach().abs()
            ulp = torch.nextafter(a, torch.full_like(a, float("inf"))) - a
            assert (step_size.abs() <= 0.505 * ulp).all(), n
            assert g.abs().max() <= 1e-6 * max(
                t.abs().max() for t in grads.values()), n


def test_forward_stays_eval_only_and_loss_runs_in_eval_too():
    model = build_segmentor(MODEL, "cpu",
                            generator=torch.Generator().manual_seed(0))
    img, gt = _batch()
    with torch.no_grad():
        loss, logits = model.loss(img, gt)
    assert torch.isfinite(loss) and logits.shape == (2, 64, 64, 25)
    model.train()
    with pytest.raises(NotImplementedError, match="eval mode only"):
        model(img)


def test_train_loss_through_the_functions_equals_the_plain_path(
        monkeypatch):
    """The tiny model in train mode with CPU tensors sent down the kernel
    branch: every K1-K5 call goes through its autograd Function (whose
    forward here runs the plain version in the kernel's place), inside the
    checkpointed regions, whose recomputes call each kernel once more.
    Loss and gradients equal the plain path's; K6 is never reached."""
    model = build_segmentor(DROPPY, "cpu",
                            generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():   # serving first leaves nothing in the way
        model(_batch()[0])
    model.train()
    loss_p, g_p = _loss_and_grads(model, 3)
    calls = {}

    def counted(name, plain):
        def launch(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            with torch.no_grad():
                return plain(*args, **kwargs)
        return launch

    def never(*args, **kwargs):
        pytest.fail("reached K6 or the kernel library")

    monkeypatch.setattr(kernels, "on_kernel_device", lambda x: True)
    monkeypatch.setattr(kernels, "library", never)
    monkeypatch.setattr(pixel_shuffle, "pixel_shuffle_up_bn_cuda", never)
    for mod, call, plain in (
            (window_attention, "window_attention_kernel",
             window_attention.window_attention_plain),
            (flash_attention, "flash_attention_kernel",
             flash_attention.flash_attention_plain),
            (msda_cuda, "ms_deform_attn_cuda", msda_cuda.ms_deform_attn_plain),
            (convnext_block, "convnext_delta_kernel",
             convnext_block.convnext_delta_plain)):
        monkeypatch.setattr(mod, call, counted(call, plain))
    loss_k, g_k = _loss_and_grads(model, 3)
    # deliver_tiny a forward: 2 windowed and 2 global blocks, 4 + 6 MSDA
    # calls, 2 x 12 ConvNeXt blocks; each twice (forward, recompute)
    assert calls == {"window_attention_kernel": 4,
                     "flash_attention_kernel": 4, "ms_deform_attn_cuda": 20,
                     "convnext_delta_kernel": 48}
    torch.testing.assert_close(loss_k, loss_p, rtol=1e-6, atol=0)
    # the same arithmetic in another order (the backward recomputes):
    # float32 rounding, above a floor for the gradients that are zero in
    # exact arithmetic (a conv bias in front of a BatchNorm: ~1e-12)
    for name in g_p:
        err = (g_k[name] - g_p[name]).abs().max().item()
        assert err <= 1e-4 * g_p[name].abs().max().item() + 1e-9, (name, err)
