"""The trainer's optimizer controls against the JAX package's optax ones
(``train/optim.py``):

* ``PlateauController``: the same scale sequence on the same metrics
  (exact: the same float arithmetic);
* the plateau scale: the port multiplies each param group's lr by it, JAX
  chains ``inject_hyperparams(optax.scale)`` after the optimizer. Adam,
  AdamW and SGD fed the same gradients under a decaying schedule, with the
  scale changed between steps: parameters within atol = rtol = 1e-6 (f32
  updates in another operation order);
* gradient accumulation, ``grad_accum`` k = 2 and 3, against
  ``optax.MultiSteps`` over 6 mini-batches, each mini-batch's gradient
  clipped first as the train step clips it: parameters within 1e-6 after
  every mini-batch, the schedule's count exact;
* the train step under accumulation: weights move only on every k-th call,
  the BN running statistics on every call, and the step count counts
  mini-batches."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from panopticsegforlargescalepointcloud_tpu.train.optim import (
    PlateauController as JPlateau,
    apply_plateau_scale as j_apply_plateau_scale,
    make_lr_schedule as j_schedule,
    make_optimizer as j_optimizer,
)
from panopticsegforlargescalepointcloud_tpu_torch.data import (
    batch_arrays,
    collate_tiles,
    synthetic_tile,
)
from panopticsegforlargescalepointcloud_tpu_torch.models import PanopticConfig
from panopticsegforlargescalepointcloud_tpu_torch.train.optim import (
    PlateauController,
    apply_plateau_scale,
    make_lr_schedule,
    make_optimizer,
    optimizer_step,
)
from panopticsegforlargescalepointcloud_tpu_torch.train.step import init_state, make_train_step

torch.set_num_threads(2)

SHAPES = {"a": (5, 3), "b": (7,)}


@pytest.mark.parametrize("params", [
    {},
    {"mode": "min", "factor": 0.5, "patience": 1, "threshold": 1e-3, "min_lr": 2e-4},
    {"mode": "max", "factor": 0.2, "patience": 2},
])
def test_plateau_controller_matches_jax(params):
    rng = np.random.default_rng(3)
    metrics = np.concatenate([np.linspace(1.0, 0.5, 5), 0.5 + 0.01 * rng.random(15),
                              np.linspace(0.5, 0.7, 5)])
    got, want = PlateauController(params, base_lr=1e-3), JPlateau(params, base_lr=1e-3)
    seq = [got.step(float(m)) for m in metrics]
    assert seq == [want.step(float(m)) for m in metrics]
    assert min(seq) < 1.0  # the scale did drop


def _params(rng):
    return {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}


def _torch_params(init):
    return [torch.nn.Parameter(torch.from_numpy(init[k].copy())) for k in SHAPES]


def _assert_close(params, jparams, msg):
    for p, k in zip(params, SHAPES):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=f"{msg} {k}")


@pytest.mark.parametrize("name,wd", [("Adam", 0.0), ("AdamW", 1e-2), ("SGD", 0.0)])
def test_plateau_scaled_update_matches_optax_chain(name, wd):
    rng = np.random.default_rng(5)
    init = _params(rng)
    grads = [_params(rng) for _ in range(5)]
    scales = [1.0, 1.0, 0.1, 0.1, 0.01]
    jsched = j_schedule("ExponentialLR", {"gamma": 0.9}, 1e-2, 2)
    tx = j_optimizer(name, jsched, weight_decay=wd, plateau_stage=True)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jp)
    params = _torch_params(init)
    opt = make_optimizer(name, params, wd)
    sched = make_lr_schedule("ExponentialLR", {"gamma": 0.9}, 1e-2, 2)
    for i, (g, s) in enumerate(zip(grads, scales)):
        state = j_apply_plateau_scale(state, s)
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        apply_plateau_scale(opt, s)
        for p, k in zip(params, SHAPES):
            p.grad = torch.from_numpy(g[k].copy())
        assert optimizer_step(opt, sched)
        _assert_close(params, jp, f"{name} step {i}")


def _counts(tree):
    return {int(v) for _, v in optax.tree_utils.tree_get_all_with_path(tree, "count")}


@pytest.mark.parametrize("k", [2, 3])
def test_grad_accum_matches_multisteps(k):
    rng = np.random.default_rng(10 + k)
    init = _params(rng)
    grads = [{n: 3.0 * v for n, v in _params(rng).items()} for _ in range(6)]
    clip = 2.0
    jsched = j_schedule("ExponentialLR", {"gamma": 0.5}, 1e-2, 1)
    tx = j_optimizer("Adam", jsched, grad_accum=k)
    assert isinstance(tx, optax.MultiSteps) or hasattr(tx, "has_updated")
    jp = {n: jnp.asarray(v) for n, v in init.items()}
    state = tx.init(jp)
    params = _torch_params(init)
    opt = make_optimizer("Adam", params)
    sched = make_lr_schedule("ExponentialLR", {"gamma": 0.5}, 1e-2, 1)
    for i, g in enumerate(grads):
        jg = jax.tree.map(lambda x: jnp.clip(jnp.asarray(x), -clip, clip), g)
        upd, state = tx.update(jg, state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, n in zip(params, SHAPES):
            p.grad = torch.from_numpy(g[n].copy())
        torch.nn.utils.clip_grad_value_(params, clip)
        updated = optimizer_step(opt, sched, grad_accum=k)
        assert updated == ((i + 1) % k == 0), i
        _assert_close(params, jp, f"k={k} mini-batch {i}")
        group = opt.param_groups[0]
        assert _counts(state.inner_opt_state) == {group["count"]} == {(i + 1) // k}
        assert int(state.mini_step) == group["mini_step"] and group["calls"] == i + 1
    assert opt.param_groups[0]["count"] == 6 // k


def test_train_step_accumulates():
    """grad_accum = 2 in the port's train step: the first call leaves the
    weights and moves the BN statistics; the second updates the weights."""
    cfg = PanopticConfig(num_classes=9, stuff_classes=(0, 7, 8), backbone="tiny", in_feat=8,
                         num_samples=1, compute_dtype="float32")
    rng = np.random.default_rng(0)
    arrays = batch_arrays(collate_tiles(
        [synthetic_tile(rng, n_instances=2, pts_per_instance=40, n_ground=200)],
        capacity=1024, num_tiles=1))
    state = init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    step = make_train_step(cfg, state.model, state.optimizer,
                           make_lr_schedule("ExponentialLR", {}, 1e-3, 10), False,
                           grad_clip_value=1.0, device="cpu", grad_accum=2)
    weights = {k: v.clone() for k, v in state.model.named_parameters()}
    stats = {k: v.clone() for k, v in state.model.named_buffers()}
    for call in (1, 2):
        step(arrays, 0.1)
        moved_w = any(not torch.equal(v, weights[k]) for k, v in state.model.named_parameters())
        moved_s = any(not torch.equal(v, stats[k]) for k, v in state.model.named_buffers())
        assert moved_w == (call == 2) and moved_s, call
        stats = {k: v.clone() for k, v in state.model.named_buffers()}
        assert state.step == call
    assert state.optimizer.param_groups[0]["count"] == 1
