"""Learning-rate schedules and optimizers (counterpart of the JAX package's
``train/optim.py``, whose optax transformations fix the semantics).

A schedule is a plain function of the optimizer update count (per-epoch
semantics expressed in steps through ``steps_per_epoch``, staircased as
torch's epoch-wise ``scheduler.step()``). :func:`optimizer_step` sets every
param group's lr from it before ``optimizer.step()``. The optimizer's
counters live in its param groups, as optax keeps them in the optimizer
state, so the prepare and full train steps share them and
``optimizer.state_dict()`` saves them:

* ``count``: updates made, the schedule's argument;
* ``calls``: mini-batches taken (the JAX package's ``TrainState.step``);
* ``mini_step`` and ``acc_grads``: the gradient-accumulation window
  (optax ``MultiSteps``: the running mean of k mini-batch gradients, one
  update every k-th call);
* ``plateau_scale``: the ReduceLROnPlateau factor on the lr, which the
  trainer sets from :class:`PlateauController` (optax:
  ``inject_hyperparams(scale)`` chained after the optimizer, equal to
  scaling the lr for Adam, AdamW, SGD and RMSprop).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable

import torch

Schedule = Callable[[int], float]


def make_lr_schedule(name: str, params: Dict[str, Any], base_lr: float,
                     steps_per_epoch: int) -> Schedule:
    """A torch-style scheduler config -> ``lr(step)``, as the optax schedule
    the JAX package builds from it."""
    n = (name or "ExponentialLR").lower()
    p = params or {}
    spe = max(int(steps_per_epoch), 1)
    if "exponential" in n or n.startswith("step"):
        if "exponential" in n:
            every, rate = spe, float(p.get("gamma", 0.9885))
        else:
            every, rate = max(int(p.get("step_size", 30)), 1) * spe, float(p.get("gamma", 0.5))
        return lambda step: base_lr * rate ** (step // every)
    if "cosine" in n:
        decay_steps = max(int(p.get("T_max", 100)), 1) * spe
        alpha = float(p.get("eta_min", 0.0)) / max(base_lr, 1e-12)

        def cosine(step):
            c = min(step, decay_steps)
            return base_lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay_steps))
                              + alpha)

        return cosine
    if "multistep" in n or "multi_step" in n:
        gamma = float(p.get("gamma", 0.5))
        bounds = sorted(int(m) * spe for m in p.get("milestones", []))
        return lambda step: base_lr * gamma ** sum(step >= b for b in bounds)
    if "poly" in n:
        steps = max(int(p.get("max_epoch", 150)), 1) * spe
        power = float(p.get("power", 0.9))
        return lambda step: base_lr * (1 - min(max(step, 0), steps) / steps) ** power
    if "cyclic" in n:
        lo = float(p.get("base_lr", base_lr))
        hi = float(p.get("max_lr", 0.1))
        up = max(int(p.get("step_size_up", 10)), 1)
        mode = str(p.get("mode", "triangular"))
        gamma = float(p.get("gamma", 1.0))

        def cyclic(step):
            e = step // spe
            cycle = e // (2 * up)
            x = abs(e / up - 2 * cycle - 1)
            amp = hi - lo
            if mode == "triangular2":
                amp = amp / (2.0 ** cycle)
            elif mode == "exp_range":
                amp = amp * (gamma ** e)
            return lo + amp * max(0.0, 1.0 - x)

        return cyclic
    if "plateau" in n:
        # metric-driven: the schedule is the base lr; the trainer applies the
        # plateau scale (PlateauController, apply_plateau_scale)
        return lambda step: base_lr
    raise ValueError(f"unknown lr scheduler class {name!r}")


def needs_plateau(name: str) -> bool:
    return "plateau" in (name or "").lower()


class PlateauController:
    """Host-side ReduceLROnPlateau (torch semantics: factor, patience and
    threshold on a monitored metric; a copy of the JAX package's). The
    trainer calls :meth:`step` with the validation loss after each
    validation and applies the returned scale with
    :func:`apply_plateau_scale`."""

    def __init__(self, params: Dict[str, Any] | None, base_lr: float = 1.0):
        p = params or {}
        self.mode = str(p.get("mode", "min"))
        self.factor = float(p.get("factor", 0.1))
        self.patience = int(p.get("patience", 10))
        self.threshold = float(p.get("threshold", 1e-4))
        # torch's min_lr is an absolute lr floor; the controller works in
        # multiplicative scale, so the scale's floor is min_lr / base_lr
        min_lr = float(p.get("min_lr", 0.0))
        self.min_scale = min_lr / base_lr if base_lr > 0 else 0.0
        self.best: float | None = None
        self.bad = 0
        self.scale = 1.0

    def _improved(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "max":
            return metric > self.best * (1.0 + self.threshold)
        return metric < self.best * (1.0 - self.threshold)

    def step(self, metric: float) -> float:
        """Update with the latest monitored metric; returns the current
        cumulative lr scale."""
        if self._improved(metric):
            self.best = metric
            self.bad = 0
        else:
            self.bad += 1
            if self.bad > self.patience:
                self.scale = max(self.scale * self.factor, self.min_scale)
                self.bad = 0
        return self.scale


def apply_plateau_scale(optimizer: torch.optim.Optimizer, scale: float) -> None:
    """The lr of every later update is ``schedule(count) * scale``."""
    for group in optimizer.param_groups:
        group["plateau_scale"] = float(scale)


class RMSprop(torch.optim.Optimizer):
    """optax ``rmsprop`` (decay 0.9, eps inside the square root, no
    momentum): ``nu = d * nu + (1 - d) * g^2``, ``p -= lr * g / sqrt(nu + eps)``.
    torch's RMSprop adds eps outside the root, so it is not used."""

    def __init__(self, params, lr: float = 1e-3, decay: float = 0.9, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["nu"] = torch.zeros_like(p)
                nu = st["nu"]
                nu.mul_(group["decay"]).addcmul_(p.grad, p.grad, value=1 - group["decay"])
                p.add_(p.grad * torch.rsqrt(nu + group["eps"]), alpha=-group["lr"])


def make_optimizer(optimizer: str, params: Iterable[torch.nn.Parameter],
                   weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """Adam, AdamW, SGD (momentum 0.9) or RMSprop with optax's
    hyperparameters. The lr is set per step by :func:`optimizer_step`."""
    o = (optimizer or "Adam").lower()
    if o == "adam":
        return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8)
    if o == "adamw":
        return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay)
    if o == "sgd":
        return torch.optim.SGD(params, lr=0.0, momentum=0.9)
    if o == "rmsprop":
        return RMSprop(params, lr=0.0)
    raise ValueError(f"unknown optimizer {optimizer!r}")


@torch.no_grad()
def optimizer_step(optimizer: torch.optim.Optimizer, schedule: Schedule,
                   grad_accum: int = 1) -> bool:
    """Take one mini-batch's gradients (``p.grad``). With ``grad_accum`` k =
    1, one update at ``lr = schedule(count) * plateau_scale``, then
    ``count += 1``. With k > 1, as optax ``MultiSteps``: the gradient joins
    the running mean ``acc += (g - acc) / (mini_step + 1)``, and every k-th
    call updates with that mean and starts a new window. Returns whether
    the weights were updated."""
    groups = optimizer.param_groups
    for group in groups:
        group.setdefault("count", 0)
        group["calls"] = group.get("calls", 0) + 1
    k = max(int(grad_accum), 1)
    if k > 1:
        mini = groups[0].get("mini_step", 0)
        for group in groups:
            accs = group.get("acc_grads") or [None] * len(group["params"])
            for i, p in enumerate(group["params"]):
                acc = torch.zeros_like(p) if mini == 0 else accs[i].to(p.device)
                accs[i] = acc + (p.grad - acc) / (mini + 1)
            group["acc_grads"] = accs
        if mini < k - 1:
            for group in groups:
                group["mini_step"] = mini + 1
            return False
        for group in groups:
            for p, acc in zip(group["params"], group["acc_grads"]):
                p.grad = acc
            group["acc_grads"] = None
            group["mini_step"] = 0
    for group in groups:
        group["lr"] = float(schedule(group["count"])) * group.get("plateau_scale", 1.0)
    optimizer.step()
    for group in groups:
        group["count"] += 1
    return True


def build_from_config(tcfg, steps_per_epoch: int, params: Iterable[torch.nn.Parameter]):
    """(optimizer, schedule, plateau) from a :class:`TrainingConfig`.
    ``plateau`` is a :class:`PlateauController` for ReduceLROnPlateau
    configs (the trainer feeds it the monitored validation loss), else
    None. Gradient accumulation is the train step's ``grad_accum``."""
    schedule = make_lr_schedule(tcfg.scheduler, tcfg.scheduler_params, tcfg.lr, steps_per_epoch)
    plateau = (PlateauController(tcfg.scheduler_params, base_lr=tcfg.lr)
               if needs_plateau(tcfg.scheduler) else None)
    return make_optimizer(tcfg.optimizer, params, tcfg.weight_decay), schedule, plateau
