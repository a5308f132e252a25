"""The whole slice: the port's train step (prepare and full phases) against
the JAX package's, on the fixture of ``test_torch_slice.py`` (tiny plan, two
synthetic tiles in 4,096 rows), from the same weights and BN statistics
(carried over with ``params_from_flax``).

The JAX side is the body of ``make_train_step`` (canonicalize, hierarchy,
``panoptic_forward(train=True)``, ``panoptic_losses``) under
``jax.value_and_grad``, run as its own tests run it: f32,
``use_winconv="off"`` (so the conv's backward is ``_conv_tm_bwd``) and
``rg_dense="on"``. The port runs ``make_train_step`` on the CPU, whose
kernels take their plain versions. Compared:

* every loss term, ``loss`` and ``hier_overflow``: rtol 1e-4 and atol 1e-5
  (f32 sums in another order through the UNet's depth);
* every parameter's gradient, name by name through ``flax_paths``: within
  1e-4 of the tensor's max |g| plus 1e-6 (f32 sums over the rows in
  another order; a bias gradient that cancels to near 0 across 4,096 rows
  keeps the rounding of its terms), and 1e-3 of max |g| for the ScoreNet's
  parameters in the full step, which max-pools per proposal (a row within
  rounding of a tie can take the gradient on one side and not the other);
* the new BN running statistics: atol = rtol = 1e-4;
* the proposals of the full step, exactly.

Then five prepare steps of the port alone: every loss finite, the last below
the first."""

import concurrent.futures
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from panopticsegforlargescalepointcloud_tpu.data import collate_tiles, synthetic_tile
from panopticsegforlargescalepointcloud_tpu.models.pointgroup3heads import (
    PanopticConfig as JConfig,
    PointGroup3HeadsNet as JNet,
    panoptic_losses as j_panoptic_losses,
)
from panopticsegforlargescalepointcloud_tpu.ops.hierarchy import build_hierarchy as j_hier
from panopticsegforlargescalepointcloud_tpu.train.step import (
    batch_arrays,
    canonicalize as j_canon,
    init_state as j_init_state,
    panoptic_forward as j_panoptic_forward,
)
from panopticsegforlargescalepointcloud_tpu_torch.models import PanopticConfig, PointGroup3HeadsNet
from panopticsegforlargescalepointcloud_tpu_torch.ops.hierarchy import build_hierarchy
from panopticsegforlargescalepointcloud_tpu_torch.train import (
    canonicalize,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
    panoptic_forward,
)
from panopticsegforlargescalepointcloud_tpu_torch.weights import flax_paths, params_from_flax
from torch_jax_cache import jax_compilation_cache  # noqa: F401 (autouse)

torch.set_num_threads(2)

CFG = dict(
    num_classes=9, stuff_classes=(0, 7, 8), backbone="tiny", in_feat=8, num_samples=2,
    max_props_rg=32, ms_max_seeds=16, ms_max_clusters=16, ms_point_cap=1024,
    cluster_radius=0.9, rg_point_cap=0.5, scorer_capacity_mult=0.375,
    compute_dtype="float32",
)
MOMENTUM = 0.1


def _random_stats(tree, rng):
    return {k: (_random_stats(v, rng) if hasattr(v, "items") else
                (np.abs(rng.normal(scale=0.3, size=v.shape)) + 0.5 if k == "var"
                 else rng.normal(scale=0.1, size=v.shape)).astype(np.float32))
            for k, v in tree.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        out.update(_flat(v, path) if hasattr(v, "items") else {path: np.asarray(v)})
    return out


@pytest.fixture(scope="module")
def setup():
    return _setup()


def _setup():
    rng = np.random.default_rng(7)
    tiles = [synthetic_tile(rng, n_instances=4, pts_per_instance=80) for _ in range(2)]
    vb = collate_tiles(tiles, capacity=4096, num_tiles=2)
    jcfg = JConfig(**CFG, use_winconv="off", rg_dense="on")
    jmodel = JNet(jcfg)
    arrays = batch_arrays(vb)
    db = j_canon(*arrays)
    state = j_init_state(jcfg, jmodel, optax.adam(1e-3), db, j_hier(db.grid, jcfg.num_down),
                         jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, state.params)
    stats = _random_stats(jax.tree.map(np.asarray, state.batch_stats),
                          np.random.default_rng(1))
    return dict(jcfg=jcfg, jmodel=jmodel, arrays=arrays, params=params, stats=stats,
                np_arrays=tuple(np.asarray(a) for a in arrays))


def _jax_step(setup, with_clustering):
    jcfg = setup["jcfg"]
    jmodel = JNet(jcfg)

    def loss_fn(params, stats, arrays):
        db = j_canon(*arrays)
        hier = j_hier(db.grid, jcfg.num_down)
        out, new_stats = j_panoptic_forward(
            jcfg, jmodel, {"params": params, "batch_stats": stats}, db, hier, train=True,
            with_clustering=with_clustering, momentum=MOMENTUM)
        total, losses = j_panoptic_losses(jcfg, out, db.y, db.vote_label, db.instance_labels,
                                          db.instance_mask, db.grid.batch, db.grid.mask)
        metrics = dict(losses, hier_overflow=jnp.sum(hier.overflow))
        return total, (metrics, new_stats, out.proposals)

    (_, (metrics, new_stats, props)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(setup["params"], setup["stats"],
                                                   setup["arrays"])
    return (jax.tree.map(np.asarray, metrics), _flat(jax.tree.map(np.asarray, new_stats)),
            _flat(jax.tree.map(np.asarray, grads)), props)


def _port_model(setup):
    model = PointGroup3HeadsNet(PanopticConfig(**CFG))
    model.load_state_dict(params_from_flax(setup["params"], setup["stats"]), strict=True)
    return model


def _port_step(setup, with_clustering, model=None):
    cfg = PanopticConfig(**CFG)
    model = model if model is not None else _port_model(setup)
    opt = make_optimizer("Adam", model.parameters())
    step = make_train_step(cfg, model, opt, make_lr_schedule("ExponentialLR", {}, 1e-3, 750),
                           with_clustering, device="cpu")
    return step, model, opt


@pytest.fixture(scope="module")
def jax_refs(setup):
    """The two phases' JAX steps, started at once in threads of their own:
    XLA leaves the interpreter lock while it compiles, so the two programs
    compile beside each other and beside the port's runs."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        yield {name: pool.submit(_jax_step, setup, name == "full")
               for name in ("prepare", "full")}


@pytest.fixture(scope="module", params=["prepare", "full"])
def phase(request, setup, jax_refs):
    with_clustering = request.param == "full"
    step, model, opt = _port_step(setup, with_clustering)
    before = copy.deepcopy(model)
    props = None
    if with_clustering:
        # the step's own proposals: the same train-mode forward on a copy
        cfg, twin = PanopticConfig(**CFG), copy.deepcopy(model).train()
        db = canonicalize(*setup["np_arrays"], device="cpu")
        with torch.no_grad():
            props = panoptic_forward(cfg, twin, db, build_hierarchy(db.grid, cfg.num_down,
                                                                    device="cpu"),
                                     True, MOMENTUM).proposals
    metrics = step(setup["np_arrays"], MOMENTUM)
    grads = flax_paths({n: p.grad for n, p in model.named_parameters()})
    stats = {k: v for k, v in flax_paths(dict(model.named_buffers())).items()}
    jmetrics, jstats, jgrads, jprops = jax_refs[request.param].result()
    return dict(name=request.param, jmetrics=jmetrics, jstats=jstats, jgrads=jgrads,
                jprops=jprops, props=props, metrics=metrics, grads=grads, stats=stats, model=model,
                before=before, opt=opt)


def test_loss_terms(phase):
    jm, tm = phase["jmetrics"], phase["metrics"]
    assert set(tm) == set(jm)
    assert ("score_loss" in tm) == (phase["name"] == "full")
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-5, err_msg=k)
    assert float(tm["hier_overflow"]) == 0


def test_gradients(phase):
    jg, tg = phase["jgrads"], phase["grads"]
    assert set(tg) == set(jg)
    touched = 0
    for k in sorted(jg):
        scale = float(np.abs(jg[k]).max())
        frac = 1e-3 if phase["name"] == "full" and k.startswith("scorer") else 1e-4
        np.testing.assert_allclose(tg[k], jg[k], rtol=0, atol=frac * scale + 1e-6, err_msg=k)
        touched += scale > 0
    scorer = [k for k in jg if k.startswith("scorer")]
    assert all(np.abs(jg[k]).max() == 0 for k in scorer) == (phase["name"] == "prepare")
    assert touched > len(jg) // 2


def test_bn_running_stats(phase):
    js, ts = phase["jstats"], phase["stats"]
    assert set(ts) == set(js)
    moved = 0
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-4, atol=1e-4, err_msg=k)
        moved += not np.array_equal(ts[k], flax_paths(dict(phase["before"].named_buffers()))[k])
    assert moved > 0


def test_parameters_updated(phase):
    after = dict(phase["model"].named_parameters())
    changed = sum(not torch.equal(p, after[n]) for n, p in phase["before"].named_parameters())
    # Adam moves every parameter with a nonzero gradient
    assert changed >= sum(float(np.abs(g).max()) > 0 for g in phase["jgrads"].values())
    assert phase["opt"].param_groups[0]["count"] == 1


def test_proposals_exact(phase):
    """The full step's clustering on train-mode heads gives the JAX
    package's membership table exactly; the prepare step clusters nothing."""
    jp, tp = phase["jprops"], phase["props"]
    if phase["name"] == "prepare":
        assert jp is None and tp is None
        return
    for name in tp._fields:
        a = np.asarray(getattr(jp, name))
        np.testing.assert_array_equal(getattr(tp, name).numpy(), a, err_msg=name)
    assert int(tp.prop_valid.sum()) >= 3


def test_prepare_steps_decrease_loss(setup):
    step, _, _ = _port_step(setup, False)
    losses = []
    for _ in range(5):
        m = step(setup["np_arrays"], MOMENTUM)
        assert all(bool(torch.isfinite(v).all()) for v in m.values())
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
