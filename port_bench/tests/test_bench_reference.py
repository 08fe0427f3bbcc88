"""The plain reference against the program's plain path (the CPU runs the
program's plain versions of its kernels) at deliver_tiny's sizes: the eval
forward, the OHEM loss and every gradient in train mode under one dropout
key, and one layer-decay AdamW update from the same gradients."""
from __future__ import annotations

import copy
import statistics

import torch

from port_bench.reference import model as R
from port_bench.reference import optim as RO
from port_bench.tests.bench_tiny import TINY_MODEL
from port_bench.weights import draw_state_dict

OPT = dict(base_lr=2e-4, weight_decay=0.01, betas=[0.9, 0.999],
           num_layers=4, layer_decay_rate=0.9, power=0.9, min_lr=0.0,
           warmup_epochs=1, warmup_ratio=0.1, max_epochs=2)


def _pair(seed=3):
    from multimodal_sam_adapter_torch.models.segmentor import build_segmentor

    sd = draw_state_dict(TINY_MODEL, seed, "cpu")
    prog = build_segmentor(TINY_MODEL, "cpu", state_dict=sd)
    ref = R.build(TINY_MODEL, "cpu")
    ref.load_state_dict(sd, strict=True)
    return prog, ref


def _inputs(seed=5):
    g = torch.Generator().manual_seed(seed)
    img = torch.randn(2, 64, 64, 6, generator=g)
    gt = torch.randint(0, 25, (2, 64, 64), generator=g)
    gt[:, :4] = 255
    return img, gt


def test_forward_matches_program():
    prog, ref = _pair()
    img, _ = _inputs()
    with torch.no_grad():
        a, b = prog.eval()(img), ref.eval()(img)
    assert (a - b).abs().max() <= 1e-5 * b.abs().max()


def test_loss_and_gradients_match_program():
    from multimodal_sam_adapter_torch.nn.layers import set_dropout_key

    prog, ref = _pair()
    img, gt = _inputs()
    prog.train(), ref.train()
    set_dropout_key(prog, 77)
    R.set_dropout_key(ref, 77)
    la, _ = prog(img, gt, ohem_per_sample=True)
    lb = ref.loss(img, gt)
    la.backward()
    lb.backward()
    assert abs(la.item() - lb.item()) <= 1e-5 * abs(lb.item())
    ga = {n: p.grad for n, p in prog.named_parameters()}
    gb = {n: p.grad for n, p in ref.named_parameters()}
    med = statistics.median(float(g.norm()) for g in gb.values())
    for n, g in gb.items():
        if float(g.norm()) < 1e-3 * med:
            continue   # nought to rounding (a bias ahead of a BatchNorm)
        assert float((ga[n] - g).norm()) <= 1e-3 * float(g.norm()), n


def test_dropout_keys_change_the_loss():
    _, ref = _pair()
    img, gt = _inputs()
    ref.train()
    losses = []
    for key in (1, 2):
        R.set_dropout_key(ref, key)
        losses.append(float(ref.loss(img, gt).detach()))
    assert losses[0] != losses[1]


def test_update_matches_program_optimizer():
    from multimodal_sam_adapter_torch.engine.optim import make_optimizer

    prog, ref = _pair()
    prog.train()
    g = torch.Generator().manual_seed(9)
    grads = {n: torch.randn(p.shape, generator=g)
             for n, p in ref.named_parameters()}
    opt = make_optimizer(prog, **dict(OPT, betas=tuple(OPT["betas"])),
                         steps_per_epoch=4, grad_accum_steps=2)
    ropt = RO.AdamW(OPT, 2, 4)
    before = copy.deepcopy(dict(ref.named_parameters()))
    for _ in range(2):      # two updates, each from two micro-batches
        for _ in range(2):
            for n, p in prog.named_parameters():
                p.grad = grads[n].clone() if p.grad is None else (
                    p.grad + grads[n])
            opt.step()
        ropt.update(list(ref.named_parameters()),
                    {n: 2 * grads[n] for n in grads})
    refs = dict(ref.named_parameters())
    with torch.no_grad():
        for n, p in prog.named_parameters():
            moved = float((refs[n] - before[n]).norm())
            assert moved > 0, n
            assert float((p - refs[n]).norm()) <= 1e-5 * moved + 1e-7, n
