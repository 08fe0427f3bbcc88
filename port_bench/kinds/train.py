"""Kind "train": micro-steps through `make_train_step` on
`init_train_state`, the window holding whole accumulation cycles; the
check compares set-up's first cycles with the reference's."""
from __future__ import annotations

import math
import statistics
import sys
import time
from typing import Dict

from .. import traffic
from ..harness import (CHECKED_UPDATES, DTYPES, free, geometry,
                       reference_precision, sync)
from ..reference import model as ref_model
from ..reference import optim as ref_optim
from ..weights import draw_state_dict


class Cell:
    """Set-up drives the state through its first CHECKED_UPDATES cycles,
    whose losses, first gradient and parameter change the reference
    follows."""

    FLOPS_KEY = "train"     # the configuration's stored count a step
    FORWARDS = 2            # the forward and its checkpoint recompute

    @staticmethod
    def net_inputs(config: dict, mix: dict):
        """(samples a micro-step, their (H, W))."""
        return mix["batch"], tuple(config["frame_hw"])

    def __init__(self, config, mix, seed, device):
        from multimodal_sam_adapter_torch.engine.train import (
            init_train_state, make_train_step)

        self.config, self.mix, self.seed, self.device = (config, mix, seed,
                                                         device)
        self.accum = config["grad_accum"]
        sd = draw_state_dict(config["model"], seed, device)
        opt = dict(config["optimizer"], grad_accum_steps=self.accum,
                   steps_per_epoch=config["steps_per_epoch"])
        self.state = init_train_state(config["model"], device, state_dict=sd,
                                      optimizer_kwargs=opt)
        del sd
        self.state.seed = ref_model.fold_in(seed, 5)
        self.step_fn = make_train_step(
            self.state.model, self.state.optimizer,
            compute_dtype=DTYPES.get(config["compute_dtype"]))
        self.batches = traffic.micro_batches(
            mix, geometry(config), config["model"]["num_classes"], seed,
            device)
        self.sent = 0
        self.failed = 0
        self.readings: Dict = {}

    def sampler(self):
        return None

    def micro_step(self) -> Dict:
        i = self.sent % self.mix["pool"]
        self.sent += 1
        return self.step_fn(self.state, dict(img=self.batches["img"][i],
                                             gt=self.batches["gt"][i]))

    def warm_up(self) -> None:
        """The first cycles, read for the check: each micro-step's loss,
        each parameter's first gradient (the mean over the first cycle) as
        the optimizer received it, from its second moment after the first
        update, and each parameter's change after the last."""
        opt = self.state.optimizer
        b2 = opt.betas[1]
        named = [(n, p) for g in opt.param_groups
                 for n, p in zip(g["names"], g["params"])]
        losses, first = [], {}
        for cycle in range(CHECKED_UPDATES):
            for _ in range(self.accum):
                losses.append(self.micro_step()["loss"])
            if cycle == 0:
                first = {n: (opt.state[p]["nu"].sum() / (1 - b2)).sqrt()
                         for n, p in named}
        p0 = draw_state_dict(self.config["model"], self.seed, self.device)
        change = {n: (p.detach() - p0[n]).norm() for n, p in named}
        del p0
        sync(self.device)
        self.readings = dict(
            losses=[float(x) for x in losses],
            grad={n: float(v) for n, v in first.items()},
            change={n: float(v) for n, v in change.items()})
        free(self.device)

    def window(self, seconds: float, sample=None) -> Dict:
        cycles = 0
        start = time.perf_counter()
        end = start
        while end - start < seconds:
            for _ in range(self.accum):
                try:
                    self.micro_step()
                except RuntimeError as exc:
                    print(f"micro-step {self.sent - 1} failed: {exc}",
                          file=sys.stderr)
                    self.failed += 1
            sync(self.device)
            cycles += 1
            end = time.perf_counter()
        steps = cycles * self.accum
        return dict(steps=steps, elapsed=end - start,
                    work=steps * self.mix["batch"])

    def steps(self, n: int) -> None:
        for _ in range(n):
            self.micro_step()

    def e2e(self, w: Dict) -> Dict[str, float]:
        return dict(train_samples_per_s=w["work"] / w["elapsed"])

    def release(self) -> None:
        del self.state, self.step_fn, self.batches

    def judge(self, sample=None, control: bool = False
              ) -> Dict[str, Dict[str, float]]:
        want = reference(self.config, self.mix, self.seed, self.device)
        layers = self.config["optimizer"]["num_layers"]
        out = dict(program=compare(self.readings, want, layers))
        if control:
            out["control"] = compare(reference(
                self.config, self.mix, self.seed, self.device, fp8=True),
                want, layers)
        return out


def reference(config, mix, seed, device, fp8=False) -> Dict:
    """The reference's readings of the first cycles on the same weights,
    micro-batches and dropout keys."""
    cfgm = config["model"]
    accum = config["grad_accum"]
    batches = traffic.micro_batches(mix, geometry(config),
                                    cfgm["num_classes"], seed, device)
    model = ref_model.build(cfgm, device)
    model.load_state_dict(draw_state_dict(cfgm, seed, device))
    model.train()
    named = list(model.named_parameters())
    p0 = {n: p.detach().clone() for n, p in named}
    opt = ref_optim.AdamW(config["optimizer"], accum,
                          config["steps_per_epoch"])
    root = ref_model.fold_in(seed, 5)
    losses, first, i = [], {}, 0
    with reference_precision(fp8):
        for cycle in range(CHECKED_UPDATES):
            for _ in range(accum):
                ref_model.set_dropout_key(model, ref_model.fold_in(root, i))
                j = i % mix["pool"]
                loss = model.loss(batches["img"][j], batches["gt"][j])
                loss.backward()
                losses.append(float(loss.detach()))
                i += 1
            grads = {n: p.grad for n, p in named}
            if cycle == 0:
                first = {n: float((g / accum).norm()) for n, g in
                         grads.items()}
            opt.update(named, grads)
            for _, p in named:
                p.grad = None
    change = {n: float((p.detach() - p0[n]).norm()) for n, p in named}
    del model, p0, batches, opt
    free(device)
    return dict(losses=losses, grad=first, change=change)


def compare(got: Dict, want: Dict, num_layers: int) -> Dict[str, float]:
    """Each micro-step's loss (relative gap); by the worst leaf the gap
    between the two sides' norms of the first gradient and of the
    parameters' change, over the larger of the reference's norm of that
    leaf and of the median leaf; the same gaps at the median leaf; and by
    the worst of the reference optimizer's layer-decay groups the gap
    between the two sides' norms of the group's change, over the
    reference's. Leaves whose reference gradient is under a thousandth of
    the median leaf's (nought to rounding, as a bias ahead of a
    BatchNorm) are left out of all."""
    loss = max(abs(a - b) / max(abs(b), 1e-12)
               for a, b in zip(got["losses"], want["losses"]))
    med_g = statistics.median(want["grad"].values())
    keep = [n for n, v in want["grad"].items() if v >= 1e-3 * med_g]
    med_c = statistics.median(want["change"][n] for n in keep)

    def gaps(key, med):
        return [abs(got[key][n] - want[key][n]) / max(want[key][n], med)
                for n in keep]

    groups: Dict[int, list] = {}
    for n in keep:
        groups.setdefault(ref_optim.layer_id(n, num_layers), []).append(n)

    def group_gap(names):
        a, b = (math.sqrt(sum(side["change"][n] ** 2 for n in names))
                for side in (got, want))
        return abs(a - b) / max(b, 1e-30)

    grad, change = gaps("grad", med_g), gaps("change", med_c)
    return dict(loss_gap=loss, grad_gap=max(grad), change_gap=max(change),
                change_gap_group=max(map(group_gap, groups.values())),
                grad_gap_median=statistics.median(grad),
                change_gap_median=statistics.median(change))
