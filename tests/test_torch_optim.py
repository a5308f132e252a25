"""Schedules and optimizers of the port against the JAX package's optax
ones (``train/optim.py``): every schedule family over 50 steps (rtol 1e-6
and atol 1e-6 of the base lr: optax evaluates in f32, the port in f64), and
every optimizer fed the same gradients for 3 steps under a decaying
schedule, parameters equal within atol = rtol = 1e-6 (f32 updates in
another operation order)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from panopticsegforlargescalepointcloud_tpu.train.optim import (
    make_lr_schedule as j_schedule,
    make_optimizer as j_optimizer,
)
from panopticsegforlargescalepointcloud_tpu_torch.train.optim import (
    make_lr_schedule,
    make_optimizer,
    optimizer_step,
)
from torch_jax_cache import jax_compilation_cache  # noqa: F401 (autouse)

torch.set_num_threads(2)

SCHEDULES = [
    ("ExponentialLR", {"gamma": 0.9}),
    ("StepLR", {"step_size": 4, "gamma": 0.5}),
    ("CosineAnnealingLR", {"T_max": 10, "eta_min": 1e-5}),
    ("MultiStepLR", {"milestones": [3, 7, 9], "gamma": 0.5}),
    ("PolyLR", {"power": 0.9, "max_epoch": 12}),
    ("CyclicLR", {"max_lr": 0.1, "step_size_up": 2, "mode": "triangular"}),
    ("CyclicLR", {"max_lr": 0.1, "step_size_up": 2, "mode": "triangular2"}),
    ("CyclicLR", {"max_lr": 0.1, "step_size_up": 2, "mode": "exp_range", "gamma": 0.9}),
]


@pytest.mark.parametrize("name,params", SCHEDULES,
                         ids=[f"{n}-{p.get('mode', '')}" for n, p in SCHEDULES])
def test_schedule_matches_optax(name, params):
    want = j_schedule(name, params, 1e-3, steps_per_epoch=3)
    got = make_lr_schedule(name, params, 1e-3, steps_per_epoch=3)
    for step in range(50):
        np.testing.assert_allclose(got(step), float(want(jnp.asarray(step))), rtol=1e-6,
                                   atol=1e-9, err_msg=f"step {step}")


def test_plateau_is_not_ported():
    # ReduceLROnPlateau is ported: its schedule is the base lr (the trainer
    # applies the plateau scale), as the JAX package's
    want = j_schedule("ReduceLROnPlateau", {}, 1e-3, 10)
    got = make_lr_schedule("ReduceLROnPlateau", {}, 1e-3, 10)
    assert [got(s) for s in range(0, 50, 7)] == [float(want(s)) for s in range(0, 50, 7)]


@pytest.mark.parametrize("name,wd", [("Adam", 0.0), ("AdamW", 1e-2), ("SGD", 0.0),
                                     ("RMSprop", 0.0)])
def test_optimizer_matches_optax(name, wd):
    rng = np.random.default_rng(4)
    shapes = {"a": (5, 3), "b": (7,)}
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    sched_args = ("ExponentialLR", {"gamma": 0.5}, 1e-2, 1)

    tx = j_optimizer(name, j_schedule(*sched_args), weight_decay=wd)
    jp = jax.tree.map(jnp.asarray, init)
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = make_optimizer(name, list(tp.values()), weight_decay=wd)
    schedule = make_lr_schedule(*sched_args)
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        optimizer_step(opt, schedule)
    assert opt.param_groups[0]["count"] == 3
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError):
        make_optimizer("Lion", [torch.nn.Parameter(torch.zeros(2))])
