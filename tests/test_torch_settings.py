"""The paper's Settings II, III and V on the tiny plan against the JAX
package (``area4_ablation_14`` / ``_15`` / ``_3heads_6``: cluster_type 1,
region growing on votes; 2, on positions and votes; 6, both and mean shift
on the embedding; all with the UNet ScoreNet): the eval forward and the
first full train step. ``run_case`` and the ``check_*`` functions also hold
the embed family's strategy table (``test_torch_embed_strategies.py``).
Plus the configs: every cluster type of both families against the
JAX package's ``PanopticConfig``, and the five ablation yamls and the three
point-backbone yamls through the port's loader.

Weights: the port's initializers, carried to the JAX side as a flax tree,
random BN statistics. The JAX side runs as its own tests run it: f32,
``use_winconv="off"``, ``rg_dense="on"``. Compared: the eval forward's heads
and scores (atol = rtol = 1e-4, f32 reassociation), its proposals and
overflow counters (exactly); the first train step's loss terms (rtol 1e-4,
atol 1e-5) against the JAX package's train-mode forward and losses, and that
forward's proposals (exactly)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticsegforlargescalepointcloud_tpu.config import (
    load_config as j_load_config,
    panoptic_config_from_yaml as j_config_from_yaml,
)
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
    make_eval_forward as j_make_eval_forward,
    panoptic_forward as j_panoptic_forward,
)
from panopticsegforlargescalepointcloud_tpu_torch.config import (
    load_config,
    panoptic_config_from_yaml,
)
from panopticsegforlargescalepointcloud_tpu_torch.flagship import CONF_DIR
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

torch.set_num_threads(2)

BASE = dict(
    num_classes=9, stuff_classes=(0, 7, 8), backbone="tiny", in_feat=8, num_samples=2,
    max_props_rg=32, ms_max_seeds=16, ms_max_clusters=16, ms_point_cap=1024,
    hd_point_cap=256, hd_max_clusters=8, loop_max_clusters=4, cluster_radius=0.9,
    rg_point_cap=0.5, scorer_capacity_mult=0.375, compute_dtype="float32",
)
CASES = {"II": dict(cluster_type=1), "III": dict(cluster_type=2), "V": dict(cluster_type=6)}
SEEDS = np.array([3, 4], np.int32)  # per-sample counters of the eval forward
STEP = 5  # the train step's counter: the count of mini-batches taken before it
MOMENTUM = 0.1


def _random_stats(tree, rng):
    return {k: (_random_stats(v, rng) if hasattr(v, "items") else
                (np.abs(rng.normal(scale=0.3, size=v.shape)) + 0.5 if k == "var"
                 else rng.normal(scale=0.1, size=v.shape)).astype(np.float32))
            for k, v in tree.items()}


def _nest(flat):
    tree = {}
    for path, arr in flat.items():
        node = tree
        *head, leaf = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = arr
    return tree


def _flax_tree(cfg, seed):
    """(params, batch_stats) of the port's initialized model as flax trees."""
    flat = flax_paths(init_params(PointGroup3HeadsNet(cfg),
                                  torch.Generator().manual_seed(seed)).state_dict())
    stat = lambda k: k.rsplit("/", 1)[1] in ("mean", "var")  # noqa: E731
    return (_nest({k: v for k, v in flat.items() if not stat(k)}),
            _random_stats(_nest({k: v for k, v in flat.items() if stat(k)}),
                          np.random.default_rng(seed)))


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(7)
    tiles = [synthetic_tile(rng, n_instances=4, pts_per_instance=80) for _ in range(2)]
    return batch_arrays(collate_tiles(tiles, capacity=4096, num_tiles=2))


def run_case(name, overrides, arrays):
    """The eval forward (per-sample counters ``SEEDS``) and the first full
    train step (counter ``STEP``) of ``BASE`` with ``overrides``, in both
    packages, from the same weights."""
    kw = dict(BASE, **overrides)
    cfg = PanopticConfig(**kw)
    jcfg = JConfig(**kw, use_winconv="off", rg_dense="on")
    jmodel = JNet(jcfg)
    params, stats = _flax_tree(cfg, 0)
    np_arrays = tuple(np.asarray(a) for a in arrays)

    def port_model():
        model = PointGroup3HeadsNet(cfg)
        model.load_state_dict(params_from_flax(params, stats), strict=True)
        return model

    _, jout = j_make_eval_forward(jcfg, jmodel)(params, stats, arrays, subset_seed=SEEDS)
    _, tout = make_eval_forward(cfg, port_model(), device="cpu")(np_arrays, subset_seed=SEEDS)

    def j_step(params, stats, arrays):
        db = j_canon(*arrays)
        hier = j_hier(db.grid, jcfg.num_down)
        out, _ = j_panoptic_forward(jcfg, jmodel, {"params": params, "batch_stats": stats},
                                    db, hier, train=True, with_clustering=True,
                                    momentum=MOMENTUM, subset_seed=jnp.int32(STEP))
        _, losses = j_panoptic_losses(jcfg, out, db.y, db.vote_label, db.instance_labels,
                                      db.instance_mask, db.grid.batch, db.grid.mask)
        return dict(losses, hier_overflow=jnp.sum(hier.overflow)), out.proposals

    jmetrics, jprops = jax.jit(j_step)(params, stats, arrays)
    model = port_model()
    opt = make_optimizer("Adam", model.parameters())
    for group in opt.param_groups:  # as after STEP mini-batches
        group["calls"] = STEP
    twin = copy.deepcopy(model).train()
    db = canonicalize(*np_arrays, device="cpu")
    with torch.no_grad():
        tprops = panoptic_forward(cfg, twin, db, build_hierarchy(db.grid, cfg.num_down,
                                                                 device="cpu"),
                                  True, MOMENTUM, subset_seed=STEP).proposals
    metrics = make_train_step(cfg, model, opt, make_lr_schedule("ExponentialLR", {}, 1e-3, 750),
                              True, device="cpu")(np_arrays, MOMENTUM)
    return dict(name=name, cfg=cfg, jout=jout, tout=tout,
                jmetrics=jax.tree.map(np.asarray, jmetrics), jprops=jprops, metrics=metrics,
                tprops=tprops)


@pytest.fixture(scope="module", params=list(CASES))
def case(request, arrays):
    return run_case(request.param, CASES[request.param], arrays)


def check_heads(case, name):
    got = getattr(case["tout"], name).numpy()
    np.testing.assert_allclose(got, np.asarray(getattr(case["jout"], name)), rtol=1e-4,
                               atol=1e-4)


def check_eval_proposals(case):
    jp, tp = case["jout"].proposals, case["tout"].proposals
    for name in tp._fields:
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)), err_msg=name)
    assert tp.prop_valid.shape[0] == case["cfg"].total_props
    assert int(tp.prop_valid.sum()) >= 2
    assert int(case["tout"].cluster_overflow) == int(case["jout"].cluster_overflow)


def check_eval_scores(case):
    jout, tout = case["jout"], case["tout"]
    if not case["cfg"].use_score_net:
        assert jout.cluster_scores is None and tout.cluster_scores is None
        return
    np.testing.assert_allclose(tout.cluster_scores.numpy(), np.asarray(jout.cluster_scores),
                               rtol=1e-4, atol=1e-4)
    assert int(tout.scorer_overflow) == int(jout.scorer_overflow)


def check_train_step_losses(case):
    jm, tm = case["jmetrics"], case["metrics"]
    assert set(tm) == set(jm)
    cfg = case["cfg"]
    assert ("offset_norm_loss" in tm) == cfg.has_offset
    assert ("score_loss" in tm) == cfg.use_score_net
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-5, err_msg=k)


def check_train_step_proposals(case):
    jp, tp = case["jprops"], case["tprops"]
    for name in tp._fields:
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)), err_msg=name)


def check_membership_blocks(case):
    """One block of N rows per clustering run, tagged in order; Settings III
    and V grow regions on positions (tag 0) and on votes (tag 1), and both
    sources find proposals."""
    cfg, tp = case["cfg"], case["tout"].proposals
    blocks = tp.prop_id.reshape(-1, case["tout"].semantic_logits.shape[0])
    assert int(tp.prop_type.max()) + 1 == blocks.shape[0]
    runs = (sum(max(op[2], 1) for op in cfg.embed_ops) if cfg.model_family == "embed"
            else cfg.num_sources)
    assert blocks.shape[0] == runs
    if case["name"] in ("III", "V"):
        assert cfg.rg_sources == ("pos", "vote")
        assert (blocks[0] >= 0).any() and (blocks[1] >= 0).any()


HEADS = ["semantic_logits", "offset_logits", "embed_logits"]


@pytest.mark.parametrize("name", HEADS)
def test_heads(case, name):
    check_heads(case, name)


def test_eval_proposals(case):
    check_eval_proposals(case)


def test_eval_scores(case):
    check_eval_scores(case)


def test_train_step_losses(case):
    check_train_step_losses(case)


def test_train_step_proposals(case):
    check_train_step_proposals(case)


def test_membership_blocks(case):
    check_membership_blocks(case)


# ------------------------------------------------------------------ the configs


def _build(cls, kw):
    try:
        return cls(**kw), None
    except (ValueError, NotImplementedError) as e:
        return None, (type(e), str(e))


@pytest.mark.parametrize("family,types", [("embed", range(1, 17)), ("3heads", range(1, 7))])
@pytest.mark.parametrize("num_samples", [1, 2, 4, 8])
def test_configs_build_as_jax(family, types, num_samples):
    """Every cluster type builds, or raises the same ValueError (the
    scorer-bits guard on ``total_props``), in both packages."""
    built = 0
    for ct in types:
        kw = dict(num_classes=9, stuff_classes=(0,), model_family=family, cluster_type=ct,
                  num_samples=num_samples)
        (t, terr), (j, jerr) = _build(PanopticConfig, kw), _build(JConfig, kw)
        assert terr == jerr, (kw, terr, jerr)
        if t is None:
            continue
        built += 1
        for prop in ("total_props", "num_sources", "rg_sources", "use_meanshift",
                     "has_offset"):
            assert getattr(t, prop) == getattr(j, prop), (kw, prop)
        if family == "embed":
            assert t.embed_ops == j.embed_ops
    assert built > 0


@pytest.mark.parametrize("over,what", [
    (["models.PointGroup-PAPER.mask_supervise=True",
      "models.PointGroup-PAPER.use_mask_filter_score_feature=True",
      "models.PointGroup-PAPER.cal_iou_based_on_mask=True",
      "models.PointGroup-PAPER.cal_iou_based_on_mask_start_epoch=3",
      "models.PointGroup-PAPER.loss_weights.mask_loss=0.5"], "mask_supervise"),
    (["models.PointGroup-PAPER.scorer_type=encoder"], "encoder"),
    (["models.PointGroup-PAPER.scorer_type=mlp"], "mlp"),
])
def test_scorer_variants_build_as_jax(over, what):
    """The ScoreNet's other forms build from the flagship yaml and its
    dotted overrides, equal to the JAX package's config field for field."""
    over = ["models=panoptic/area4_ablation_3heads_5"] + over
    cfg = panoptic_config_from_yaml(load_config(CONF_DIR, over))[0]
    jcfg = j_config_from_yaml(j_load_config(CONF_DIR, over))[0]
    for f in cfg.__dataclass_fields__:
        assert getattr(cfg, f) == getattr(jcfg, f), f
    if what == "mask_supervise":
        assert cfg.has_mask_head and cfg.w_mask == 0.5
        assert cfg.gates(3) == (False, False) and cfg.gates(4) == (False, True)
        assert cfg.gates(None) == (True, True)
    else:
        assert cfg.scorer_type == what and not cfg.has_mask_head


@pytest.mark.parametrize("models", ["area4_ablation_19", "area4_ablation_14",
                                    "area4_ablation_15", "area4_ablation_3heads_5",
                                    "area4_ablation_3heads_6"])
def test_ablation_yamls_build_as_jax(models):
    over = [f"models=panoptic/{models}"]
    cfg = panoptic_config_from_yaml(load_config(CONF_DIR, over))[0]
    jcfg = j_config_from_yaml(j_load_config(CONF_DIR, over))[0]
    for f in cfg.__dataclass_fields__:
        assert getattr(cfg, f) == getattr(jcfg, f), f


@pytest.mark.parametrize("models,name", [("kpconv", "KPConvPaper"),
                                         ("kpconv_deform", "KPConvPaper-Deform"),
                                         ("pointnet2", "PointNet2")])
def test_point_backbone_yamls_build_as_jax(models, name):
    """The point-backbone yamls compose to the JAX package's config, field
    for field, with their own model names."""
    over = [f"models=panoptic/{models}", f"model_name={name}"]
    cfg = panoptic_config_from_yaml(load_config(CONF_DIR, over))[0]
    jcfg = j_config_from_yaml(j_load_config(CONF_DIR, over))[0]
    for f in cfg.__dataclass_fields__:
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.is_point_backbone and cfg.num_down == jcfg.num_down == cfg.point_levels
    assert cfg.kp_deformable == (models == "kpconv_deform")
