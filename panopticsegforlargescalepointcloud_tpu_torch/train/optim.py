"""Learning-rate schedules and optimizers (counterpart of the JAX package's
``train/optim.py``, whose optax transformations fix the semantics).

A schedule is a plain function of the optimizer step count (per-epoch
semantics expressed in steps through ``steps_per_epoch``, staircased as
torch's epoch-wise ``scheduler.step()``). :func:`optimizer_step` sets every
param group's lr from it before ``optimizer.step()``. The count lives in the
param groups (``"count"``), as optax keeps it in the optimizer state: the
prepare and full train steps share it, and ``optimizer.state_dict()`` saves
it.

Not ported yet: ReduceLROnPlateau (the trainer's plateau control) and
gradient accumulation (optax ``MultiSteps``).
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
        raise NotImplementedError("ReduceLROnPlateau is not ported yet")
    raise ValueError(f"unknown lr scheduler class {name!r}")


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


def optimizer_step(optimizer: torch.optim.Optimizer, schedule: Schedule) -> None:
    """One update at ``lr = schedule(count)``, then ``count += 1``."""
    for group in optimizer.param_groups:
        group["lr"] = float(schedule(group.setdefault("count", 0)))
    optimizer.step()
    for group in optimizer.param_groups:
        group["count"] += 1
