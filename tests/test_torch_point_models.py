"""The point-backbone models (``conf/models/panoptic/kpconv.yaml``,
``kpconv_deform.yaml``, ``pointnet2.yaml``: KPConv rigid and deformable,
PointNet++; three heads, no ScoreNet, region growing on votes and mean
shift on the embedding) at a tiny width against the JAX package, on two
synthetic tiles in 4,096 rows:

* the eval forward with clustering: heads within
  atol = rtol = 1e-4, proposals and the overflow count exactly;
* the first train step, prepare and full, for all three: every loss term
  (the deformable KPConv's ``fitting_loss`` and ``repulsion_loss`` among
  them) within rtol 1e-4 and atol 1e-5, every gradient within 1e-3 of its
  tensor's max |g| plus 1e-6 (a BN bias whose gradient cancels to ~1e-7
  across the rows keeps the rounding of its terms, as in
  ``test_torch_train_step.py``), the full step's proposals exactly;
* ``weights.py``: the port's state dict through ``flax_paths`` and back,
  and its flax paths and shapes those of the JAX model's init;
* the CLIs on the CPU with ``models=panoptic/kpconv_deform
  model_name=KPConvPaper-Deform``: train, resume, forward and eval.

Weights: the port's initializers as a flax tree, random BN statistics. The
JAX side runs as its own tests run it: f32, ``use_winconv="off"``,
``rg_dense="on"``."""

import json

import jax
import jax.numpy as jnp
import numpy as np
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
    make_eval_forward as j_make_eval_forward,
    panoptic_forward as j_panoptic_forward,
)
from panopticsegforlargescalepointcloud_tpu_torch.cli import eval as cli_eval
from panopticsegforlargescalepointcloud_tpu_torch.cli import forward as cli_forward
from panopticsegforlargescalepointcloud_tpu_torch.cli import train as cli_train
from panopticsegforlargescalepointcloud_tpu_torch.data.ply import read_ply
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
from test_data import make_forest_ply
from test_torch_settings import _flax_tree, _nest
from test_torch_train_step import _flat

torch.set_num_threads(2)

BASE = dict(
    num_classes=9, stuff_classes=(0, 7, 8), in_feat=8, num_samples=2, max_props_rg=32,
    ms_max_seeds=16, ms_max_clusters=16, ms_point_cap=1024, cluster_radius=0.9,
    rg_point_cap=0.5, compute_dtype="float32", use_score_net=False, scorer_type="",
    grid_size=0.2, point_levels=2, kp_base_channels=8, pn2_base_channels=8,
    point_cell_cap=64,
)
MODELS = {
    "kpconv": dict(backbone="kpconv"),
    "kpconv_deform": dict(backbone="kpconv", kp_deformable=True),
    "pointnet2": dict(backbone="pointnet2"),
}
MOMENTUM = 0.1


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(7)
    tiles = [synthetic_tile(rng, n_instances=4, pts_per_instance=80) for _ in range(2)]
    return batch_arrays(collate_tiles(tiles, capacity=4096, num_tiles=2))


def _configs(name):
    kw = dict(BASE, **MODELS[name])
    return PanopticConfig(**kw), JConfig(**kw, use_winconv="off", rg_dense="on")


def _port_model(cfg, params, stats):
    model = PointGroup3HeadsNet(cfg)
    model.load_state_dict(params_from_flax(params, stats), strict=True)
    return model


def _jax_step(jcfg, params, stats, arrays, with_clustering):
    jmodel = JNet(jcfg)

    def loss_fn(params, stats, arrays):
        db = j_canon(*arrays)
        hier = j_hier(db.grid, jcfg.num_down)
        out, _ = j_panoptic_forward(jcfg, jmodel, {"params": params, "batch_stats": stats},
                                    db, hier, train=True, with_clustering=with_clustering,
                                    momentum=MOMENTUM)
        total, losses = j_panoptic_losses(jcfg, out, db.y, db.vote_label, db.instance_labels,
                                          db.instance_mask, db.grid.batch, db.grid.mask)
        return total, (dict(losses, hier_overflow=jnp.sum(hier.overflow)), out.proposals)

    (_, (metrics, props)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, stats, arrays)
    return (jax.tree.map(np.asarray, metrics), _flat(jax.tree.map(np.asarray, grads)),
            props)


def _port_step(cfg, params, stats, np_arrays, with_clustering):
    model = _port_model(cfg, params, stats)
    props = None
    if with_clustering:  # the step's own proposals: the same forward on a twin
        twin = _port_model(cfg, params, stats).train()
        db = canonicalize(*np_arrays, device="cpu")
        with torch.no_grad():
            props = panoptic_forward(cfg, twin, db, build_hierarchy(db.grid, cfg.num_down,
                                                                    device="cpu"),
                                     True, MOMENTUM).proposals
    opt = make_optimizer("Adam", model.parameters())
    metrics = make_train_step(cfg, model, opt, make_lr_schedule("ExponentialLR", {}, 1e-3, 750),
                              with_clustering, device="cpu")(np_arrays, MOMENTUM)
    return metrics, flax_paths({n: p.grad for n, p in model.named_parameters()}), props


@pytest.fixture(scope="module", params=list(MODELS))
def model_case(request, arrays):
    name = request.param
    cfg, jcfg = _configs(name)
    params, stats = _flax_tree(cfg, 0)
    np_arrays = tuple(np.asarray(a) for a in arrays)
    res = dict(name=name, cfg=cfg)
    _, res["jout"] = j_make_eval_forward(jcfg, JNet(jcfg))(params, stats, arrays)
    _, res["tout"] = make_eval_forward(cfg, _port_model(cfg, params, stats),
                                       device="cpu")(np_arrays)
    for phase, clustering in (("prepare", False), ("full", True)):
        res[phase] = dict(zip(("jmetrics", "jgrads", "jprops"),
                              _jax_step(jcfg, params, stats, arrays, clustering)))
        res[phase].update(zip(("metrics", "grads", "props"),
                              _port_step(cfg, params, stats, np_arrays, clustering)))
    return res


@pytest.mark.parametrize("head", ["semantic_logits", "offset_logits", "embed_logits",
                                  "backbone_feats"])
def test_eval_heads(model_case, head):
    np.testing.assert_allclose(getattr(model_case["tout"], head).numpy(),
                               np.asarray(getattr(model_case["jout"], head)),
                               rtol=1e-4, atol=1e-4)


def test_eval_proposals(model_case):
    jout, tout = model_case["jout"], model_case["tout"]
    for f in tout.proposals._fields:
        np.testing.assert_array_equal(getattr(tout.proposals, f).numpy(),
                                      np.asarray(getattr(jout.proposals, f)), err_msg=f)
    assert int(tout.proposals.prop_valid.sum()) >= 2
    assert int(tout.cluster_overflow) == int(jout.cluster_overflow)
    assert tout.cluster_scores is None and jout.cluster_scores is None
    assert tout.internal_losses is None


@pytest.mark.parametrize("phase", ["prepare", "full"])
def test_train_step_losses(model_case, phase):
    r = model_case[phase]
    jm, tm = dict(r["jmetrics"]), r["metrics"]
    assert set(tm) == set(jm)
    internal = {"fitting_loss", "repulsion_loss"} & set(tm)
    assert bool(internal) == (model_case["name"] == "kpconv_deform")
    assert ("cluster_overflow" in tm) == (phase == "full") and "score_loss" not in tm
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-5, err_msg=k)
    for k in internal:
        assert 0 < float(tm[k]) < np.inf, k


@pytest.mark.parametrize("phase", ["prepare", "full"])
def test_train_step_gradients(model_case, phase):
    jg, tg = model_case[phase]["jgrads"], model_case[phase]["grads"]
    assert set(tg) == set(jg)
    touched = 0
    for k in sorted(jg):
        scale = float(np.abs(jg[k]).max())
        np.testing.assert_allclose(tg[k], jg[k], rtol=0, atol=1e-3 * scale + 1e-6, err_msg=k)
        touched += scale > 0
    assert touched > len([k for k in jg if k.startswith("backbone")])
    if model_case["name"] == "kpconv_deform":
        offsets = [k for k in tg if "offset_" in k]
        assert offsets and all(np.abs(tg[k]).max() > 0 for k in offsets)


def test_train_step_proposals(model_case):
    jp, tp = model_case["full"]["jprops"], model_case["full"]["props"]
    for f in tp._fields:
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)),
                                      err_msg=f)
    assert int(tp.prop_valid.sum()) >= 1


@pytest.mark.parametrize("name", list(MODELS))
def test_weights_round_trip(name, arrays):
    cfg, jcfg = _configs(name)
    model = init_params(PointGroup3HeadsNet(cfg), torch.Generator().manual_seed(4))
    sd = model.state_dict()
    flat = flax_paths(sd)
    stat = lambda k: k.rsplit("/", 1)[1] in ("mean", "var")  # noqa: E731
    back = params_from_flax(_nest({k: v for k, v in flat.items() if not stat(k)}),
                            _nest({k: v for k, v in flat.items() if stat(k)}))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    # the flax paths and shapes of the JAX model's own init (backbone and heads)
    db = j_canon(*arrays)
    hier = j_hier(db.grid, jcfg.num_down)
    shapes = jax.eval_shape(lambda: JNet(jcfg).init(
        jax.random.PRNGKey(0), db.feats, hier, False, pos=db.pos, method=JNet.backbone_heads))
    want = {"/".join(str(getattr(p, "key", p)) for p in path): tuple(v.shape)
            for tree in (shapes["params"], shapes["batch_stats"])
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    got = {k: tuple(v.shape) for k, v in flat.items() if not k.startswith("scorer")}
    assert got == want
    kinds = {k.rsplit("/", 1)[1] for k in got}
    assert ({"offset_kernel", "offset_bias"} <= kinds) == (name == "kpconv_deform")


def test_cli_train_resume_forward_eval(tmp_path):
    """Two epochs of the tiny deformable KPConv (the second with clustering)
    on a synthetic forest, a resume to epoch 3, then the forward and eval
    CLIs with that checkpoint."""
    ply = str(tmp_path / "forest.ply")
    make_forest_ply(ply, np.random.default_rng(2022), n_trees=4, extent=14.0)
    run_dir = tmp_path / "run"
    model = "models.KPConvPaper-Deform"
    args = ["models=panoptic/kpconv_deform", "model_name=KPConvPaper-Deform",
            "data=panoptic/treeins_rad8", "device=cpu", "pretty_print=False",
            "training.batch_size=2", "training.samples_per_epoch=4",
            "training.num_workers=0", "data.voxel_capacity=4096",
            "data.eval_voxel_capacity=4096", "data.radius=6", f"checkpoint_dir={run_dir}",
            f"data.files.train=[{ply}]", f"data.files.val=[{ply}]", f"{model}.feat_size=8",
            f"{model}.prepare_epoch=1", f"{model}.point_levels=2",
            f"{model}.kp_base_channels=8", f"{model}.ms_point_cap=1024"]
    trainer = cli_train.main(args + ["training.epochs=2"])
    assert trainer.pcfg.backbone == "kpconv" and trainer.pcfg.kp_deformable
    lines = [json.loads(x) for x in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert len(lines) == 2
    for line in lines:
        assert {"train_fitting_loss", "train_repulsion_loss"} <= set(line)
        assert all(np.isfinite(v) for k, v in line.items() if k.startswith("train_"))
    assert "train_cluster_overflow" in lines[1] and "train_score_loss" not in lines[1]
    resumed = cli_train.main(args + ["training.epochs=3"])
    assert resumed.start_epoch == 3
    assert len((run_dir / "metrics.jsonl").read_text().splitlines()) == 3
    written = cli_forward.main([f"checkpoint_dir={run_dir}", "device=cpu",
                                f"data.files.test=[{ply}]", f"out_dir={tmp_path / 'fwd'}"])
    out = read_ply(written[ply])
    assert len(out["pred_sem"]) == len(read_ply(ply)["x"])
    assert set(np.unique(out["pred_sem"])) <= {0, 1}
    reports = cli_eval.main([f"checkpoint_dir={run_dir}", "device=cpu",
                             f"data.files.test=[{ply}]", f"out_dir={tmp_path / 'eval'}"])
    assert len(reports) == 1
    assert all(np.isfinite(reports[0][k]) for k in ("mIoU", "meanPQ", "F1"))
    assert (tmp_path / "eval" / "Evaluation_0.txt").exists()
