"""Setting I (``conf/models/panoptic/area4_ablation_19.yaml``: the
PointGroupEmbed family, no offset head, cluster_type 7 = mean shift on the
embedding, no ScoreNet) against the JAX package on the tiny plan, with
random BN statistics. Also the semantic-certainty score (``scorer_type``
"") on the same weights. The weights come from the port's initializers,
carried to the JAX side as a flax tree; that tree must equal, leaf for
leaf, the one the JAX package's initialization builds (which holds ScoreNet
weights that no Setting I forward uses), and the port loads it back with
``strict=True``.

The JAX side runs as its own tests run it: f32, ``use_winconv="off"``,
``rg_dense="on"``. Compared, with the tolerances of ``test_torch_slice.py``
and ``test_torch_train_step.py``: the eval forward's heads (atol = rtol =
1e-4) and its proposals (exactly); the first train step's loss terms (rtol
1e-4, atol 1e-5; no offset loss, and a score loss only with scores), every
gradient within 1e-4 of its tensor's max |g| plus 1e-6, and the proposals
of its train-mode forward (exactly). The first step is a full step: it
does the prepare step's work and clusters."""

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
    make_eval_forward as j_make_eval_forward,
    panoptic_forward as j_panoptic_forward,
)
from panopticsegforlargescalepointcloud_tpu_torch.models import PanopticConfig, PointGroup3HeadsNet
from panopticsegforlargescalepointcloud_tpu_torch.ops.hierarchy import build_hierarchy
from panopticsegforlargescalepointcloud_tpu_torch.train import (
    canonicalize,
    make_eval_forward,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
    panoptic_forward,
)
from panopticsegforlargescalepointcloud_tpu_torch.train.step import init_params
from panopticsegforlargescalepointcloud_tpu_torch.weights import flax_paths, params_from_flax
from torch_jax_cache import jax_compilation_cache  # noqa: F401 (autouse)

torch.set_num_threads(2)

SETTING_1 = dict(
    num_classes=9, stuff_classes=(0, 7, 8), backbone="tiny", in_feat=8, num_samples=2,
    model_family="embed", cluster_type=7, use_score_net=False, ms_max_seeds=16,
    ms_max_clusters=16, ms_point_cap=1024, cluster_radius=0.9, rg_point_cap=0.5,
    scorer_capacity_mult=0.375, compute_dtype="float32",
)
VARIANTS = {"setting1": SETTING_1,
            "certainty": dict(SETTING_1, use_score_net=True, scorer_type="")}
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


def _nest(flat):
    tree = {}
    for path, arr in flat.items():
        node = tree
        *head, leaf = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = arr
    return tree


@pytest.fixture(scope="module")
def setup():
    """Weights from the port's initializers, as a flax tree; the JAX
    package's init traced alone (``eval_shape``) gives the tree it expects."""
    rng = np.random.default_rng(7)
    tiles = [synthetic_tile(rng, n_instances=4, pts_per_instance=80) for _ in range(2)]
    arrays = batch_arrays(collate_tiles(tiles, capacity=4096, num_tiles=2))
    jcfg = JConfig(**SETTING_1, use_winconv="off", rg_dense="on")

    def init(arrays):
        db = j_canon(*arrays)
        return j_init_state(jcfg, JNet(jcfg), optax.adam(1e-3), db,
                            j_hier(db.grid, jcfg.num_down), jax.random.PRNGKey(0))

    want = jax.eval_shape(init, arrays)
    model = init_params(PointGroup3HeadsNet(PanopticConfig(**SETTING_1)),
                        torch.Generator().manual_seed(0))
    flat = flax_paths(model.state_dict())
    params = _nest({k: v for k, v in flat.items() if k.rsplit("/", 1)[1] not in ("mean", "var")})
    stats = _random_stats(_nest({k: v for k, v in flat.items()
                                 if k.rsplit("/", 1)[1] in ("mean", "var")}),
                          np.random.default_rng(1))
    return dict(arrays=arrays, np_arrays=tuple(np.asarray(a) for a in arrays), params=params,
                stats=stats, want=want)


def _jax(variant):
    jcfg = JConfig(**VARIANTS[variant], use_winconv="off", rg_dense="on")
    return jcfg, JNet(jcfg)


def _port_model(setup, variant):
    model = PointGroup3HeadsNet(PanopticConfig(**VARIANTS[variant]))
    model.load_state_dict(params_from_flax(setup["params"], setup["stats"]), strict=True)
    return model


def test_weight_tree(setup):
    """The port's weights are the flax init's tree, leaf for leaf: no offset
    head, and the ScoreNet that the flax init touches."""
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)  # noqa: E731
    assert shapes(setup["params"]) == shapes(setup["want"].params)
    assert shapes(setup["stats"]) == shapes(setup["want"].batch_stats)
    assert "offset_mlp" not in setup["params"] and "offset_out" not in setup["params"]
    assert "scorer" in setup["params"] and "scorer_head" in setup["params"]
    names = set(_port_model(setup, "setting1").state_dict())
    assert not any(n.startswith("offset") for n in names)
    assert any(n.startswith("scorer.") for n in names)


def _jax_forward(setup, variant):
    jcfg, jmodel = _jax(variant)
    return j_make_eval_forward(jcfg, jmodel)(setup["params"], setup["stats"], setup["arrays"],
                                             subset_seed=3)[1]


@pytest.fixture(scope="module")
def jax_refs(setup):
    """Each variant's JAX eval forward and first full step, started at once
    in two threads of their own: XLA leaves the interpreter lock while it
    compiles, so the four programs compile beside each other and beside the
    port's runs."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        refs = {("forward", v): pool.submit(_jax_forward, setup, v) for v in VARIANTS}
        refs.update({("step", v): pool.submit(_jax_step, setup, v, True) for v in VARIANTS})
        yield refs


@pytest.fixture(scope="module", params=list(VARIANTS))
def forward(request, setup, jax_refs):
    cfg = PanopticConfig(**VARIANTS[request.param])
    _, tout = make_eval_forward(cfg, _port_model(setup, request.param), device="cpu")(
        setup["np_arrays"], subset_seed=3)
    return dict(name=request.param, jout=jax_refs["forward", request.param].result(),
                tout=tout)


@pytest.mark.parametrize("name", ["semantic_logits", "offset_logits", "embed_logits",
                                  "backbone_feats"])
def test_heads(forward, name):
    got = getattr(forward["tout"], name).numpy()
    want = np.asarray(getattr(forward["jout"], name))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    if name == "offset_logits":
        assert not got.any()


def test_proposal_membership(forward):
    jp, tp = forward["jout"].proposals, forward["tout"].proposals
    for name in tp._fields:
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)), err_msg=name)
    # one block of N rows: the mean-shift run
    assert tp.prop_id.shape[0] == forward["tout"].semantic_logits.shape[0]
    assert int(tp.prop_valid.sum()) >= 2


def test_scores(forward):
    jout, tout = forward["jout"], forward["tout"]
    assert tout.scorer_overflow is None
    if forward["name"] == "setting1":
        assert jout.cluster_scores is None and tout.cluster_scores is None
        return
    np.testing.assert_allclose(tout.cluster_scores.numpy(), np.asarray(jout.cluster_scores),
                               rtol=1e-4, atol=1e-4)
    valid = tout.proposals.prop_valid.numpy()
    assert (tout.cluster_scores.numpy()[valid] > 0).all()


def _jax_step(setup, variant, with_clustering):
    jcfg, jmodel = _jax(variant)

    def loss_fn(params, stats, arrays):
        db = j_canon(*arrays)
        hier = j_hier(db.grid, jcfg.num_down)
        out, new_stats = j_panoptic_forward(
            jcfg, jmodel, {"params": params, "batch_stats": stats}, db, hier, train=True,
            with_clustering=with_clustering, momentum=MOMENTUM, subset_seed=jnp.int32(0))
        total, losses = j_panoptic_losses(jcfg, out, db.y, db.vote_label, db.instance_labels,
                                          db.instance_mask, db.grid.batch, db.grid.mask)
        return total, (dict(losses, hier_overflow=jnp.sum(hier.overflow)), out.proposals)

    (_, (metrics, props)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        setup["params"], setup["stats"], setup["arrays"])
    return jax.tree.map(np.asarray, metrics), _flat(jax.tree.map(np.asarray, grads)), props


@pytest.fixture(scope="module", params=list(VARIANTS))
def step(request, setup, jax_refs):
    """The first full train step (the prepare step's work and clustering)."""
    variant = request.param
    cfg = PanopticConfig(**VARIANTS[variant])
    model = _port_model(setup, variant)
    twin = copy.deepcopy(model).train()
    db = canonicalize(*setup["np_arrays"], device="cpu")
    with torch.no_grad():
        props = panoptic_forward(cfg, twin, db, build_hierarchy(db.grid, cfg.num_down,
                                                                device="cpu"),
                                 True, MOMENTUM, subset_seed=0).proposals
    opt = make_optimizer("Adam", model.parameters())
    metrics = make_train_step(cfg, model, opt, make_lr_schedule("ExponentialLR", {}, 1e-3, 750),
                              True, device="cpu")(setup["np_arrays"], MOMENTUM)
    grads = flax_paths({n: p.grad for n, p in model.named_parameters()})
    jmetrics, jgrads, jprops = jax_refs["step", variant].result()
    return dict(variant=variant, jmetrics=jmetrics, jgrads=jgrads, jprops=jprops,
                metrics=metrics, grads=grads, props=props)


def test_loss_terms(step):
    jm, tm = step["jmetrics"], step["metrics"]
    assert set(tm) == set(jm)
    assert not any(k.startswith("offset") for k in tm)
    assert ("score_loss" in tm) == (step["variant"] == "certainty")
    assert "cluster_overflow" in tm
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-5, err_msg=k)


def test_gradients(step):
    jg, tg = step["jgrads"], step["grads"]
    assert set(tg) == set(jg)
    for k in sorted(jg):
        scale = float(np.abs(jg[k]).max())
        np.testing.assert_allclose(tg[k], jg[k], rtol=0, atol=1e-4 * scale + 1e-6, err_msg=k)
    # no forward reaches the ScoreNet's weights
    assert all(not tg[k].any() for k in tg if k.startswith("scorer"))
    sem = [k for k in jg if k.startswith("semantic")]
    assert all(np.abs(jg[k]).max() > 0 for k in sem)


def test_train_proposals_exact(step):
    jp, tp = step["jprops"], step["props"]
    for name in tp._fields:
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)), err_msg=name)
