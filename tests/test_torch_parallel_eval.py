"""Mesh serving: the port's ``FullSceneEvaluator`` with a mesh of gloo CPU
ranks (one tile per rank and dispatch, the outputs gathered to rank 0 and
merged there in tile order), driven through the eval CLI with
``num_devices=D device=cpu``, on the synthetic forest of
``test_torch_evaluator.py`` (4 trees, 14 m, 14 tiles of 4,096 rows; tiny
plan, f32, the port's initial weights with random BN statistics).

* D = 2 and D = 3 (14 tiles leave D = 3 a last group of 2, padded with its
  last tile) against the port's sequential scene at 1 tile per dispatch:
  labels identical, reports equal;
* the same scenes against the JAX evaluator with
  ``mesh=make_mesh(jax.devices()[:2])`` (``use_winconv="off"``,
  ``rg_dense="on"``, numpy voxelization): labels identical;
* Setting I (the embed family without a scorer: every proposal is kept, as
  with ``scores=None``) at D = 2 against its sequential scene;
* the refusals: more ranks than visible cards (``torch.cuda`` monkeypatched
  to one card), and a mesh with more than one tile per dispatch."""

import concurrent.futures
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticsegforlargescalepointcloud_tpu.data import (
    TREEINS_SPEC as J_TREEINS,
    PanopticFileDataset as JDataset,
)
from panopticsegforlargescalepointcloud_tpu.models.pointgroup3heads import (
    PanopticConfig as JConfig,
    PointGroup3HeadsNet as JNet,
)
from panopticsegforlargescalepointcloud_tpu.ops import native
from panopticsegforlargescalepointcloud_tpu.parallel import make_mesh as j_make_mesh
from panopticsegforlargescalepointcloud_tpu.train.evaluator import (
    FullSceneEvaluator as JEvaluator,
)
from panopticsegforlargescalepointcloud_tpu_torch.cli import eval as cli_eval
from panopticsegforlargescalepointcloud_tpu_torch.config import load_config
from panopticsegforlargescalepointcloud_tpu_torch.data import TREEINS_SPEC, PanopticFileDataset
from panopticsegforlargescalepointcloud_tpu_torch.data.ply import read_ply
from panopticsegforlargescalepointcloud_tpu_torch.models import (
    PanopticConfig,
    PointGroup3HeadsNet,
)
from panopticsegforlargescalepointcloud_tpu_torch.parallel import Mesh
from panopticsegforlargescalepointcloud_tpu_torch.train.checkpoint import ModelCheckpoint
from panopticsegforlargescalepointcloud_tpu_torch.train.evaluator import FullSceneEvaluator
from panopticsegforlargescalepointcloud_tpu_torch.train.step import init_params
from panopticsegforlargescalepointcloud_tpu_torch.weights import flax_paths
from test_data import make_forest_ply
from torch_jax_cache import jax_compilation_cache  # noqa: F401 (autouse)

torch.set_num_threads(2)

CAPACITY = 4096
CFG = dict(
    num_classes=2, stuff_classes=(0,), backbone="tiny", feat_dim=4, in_feat=8, num_samples=1,
    max_instances=16, max_props_rg=32, ms_max_seeds=32, ms_max_clusters=8, ms_point_cap=2048,
    cluster_radius=0.3, min_cluster_points=10, rg_point_cap=0.5, compute_dtype="float32",
)
SETTINGS = {"IV": {}, "I": dict(model_family="embed", cluster_type=7, use_score_net=False)}
LABELS = {"semantic": "Semantic_results_forEval_0", "instance": "Instance_Results_forEval0"}


def _nest(flat):
    tree = {}
    for path, arr in flat.items():
        node = tree
        *head, leaf = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = arr
    return tree


def _model(setting):
    """The port's initialized model with random BN statistics, and its
    (params, batch_stats) as flax trees."""
    model = init_params(PointGroup3HeadsNet(PanopticConfig(**CFG, **SETTINGS[setting])),
                        torch.Generator().manual_seed(3))
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            val = (np.abs(rng.normal(scale=0.3, size=buf.shape)) + 0.5 if name.endswith("var")
                   else rng.normal(scale=0.1, size=buf.shape))
            buf.copy_(torch.from_numpy(val.astype(np.float32)))
    flat = flax_paths(model.state_dict())
    stat = {k for k in flat if k.rsplit("/", 1)[1] in ("mean", "var")}
    return (model, _nest({k: v for k, v in flat.items() if k not in stat}),
            _nest({k: v for k, v in flat.items() if k in stat}))


def _checkpoint(model, setting, ckpt_dir):
    run_cfg = load_config(cli_eval.CONF_DIR, [
        "models.PointGroup-PAPER.feat_size=8", "data.radius=7",
        f"data.voxel_capacity={CAPACITY}", f"data.eval_voxel_capacity={CAPACITY}"],
        root="eval.yaml")
    run_cfg["backbone"] = "tiny"
    # the yaml's own budgets and radius give way to the test's
    run_cfg["budget_overrides"] = {k: v for k, v in dict(CFG, **SETTINGS[setting]).items()
                                   if k not in ("num_classes", "stuff_classes", "backbone",
                                                "feat_dim", "in_feat", "num_samples")}
    run_cfg["budget_overrides"]["scorer_capacity_mult"] = 1.0
    ModelCheckpoint(str(ckpt_dir), run_config=run_cfg).save_best_models_under_current_metrics(
        {"state_dict": model.state_dict()}, None, {"train": {"loss": 1.0}})


def _cli(ckpt, ply, out, *extra):
    return cli_eval.main([f"checkpoint_dir={ckpt}", f"data.files.test=[{ply}]",
                          f"out_dir={out}", "device=cpu", *extra])


@pytest.fixture(scope="module")
def ply(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("forest") / "forest.ply")
    make_forest_ply(path, np.random.default_rng(2022), n_trees=4, extent=14.0)
    return path


@pytest.fixture(scope="module", params=list(SETTINGS))
def scenes(request, ply, tmp_path_factory):
    """Per setting: the port's sequential scene and its mesh scenes (D = 2,
    and for Setting IV D = 3), through the eval CLI; for Setting IV the JAX
    evaluator's two-device mesh scene."""
    setting = request.param
    tmp = tmp_path_factory.mktemp(f"setting_{setting}")
    model, params, stats = _model(setting)
    _checkpoint(model, setting, tmp / "ckpt")

    def port_scenes():
        out = {"seq": (_cli(tmp / "ckpt", ply, tmp / "seq", "tiles_per_dispatch=1"),
                       tmp / "seq")}
        for d in ((2, 3) if setting == "IV" else (2,)):
            out[f"mesh{d}"] = (_cli(tmp / "ckpt", ply, tmp / f"mesh{d}", f"num_devices={d}"),
                               tmp / f"mesh{d}")
        return out

    # the port's scenes (their mesh ranks are processes of their own) run
    # in a second thread while this one runs the JAX evaluator
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(port_scenes)
        if setting == "IV":
            jcfg = JConfig(**CFG, use_winconv="off", rg_dense="on")
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(native, "available", lambda: False)
                jds = JDataset(J_TREEINS, [ply], grid_size=0.2, radius=7.0, keep_raw=True)
                jev = JEvaluator(jcfg, JNet(jcfg), jax.tree.map(jnp.asarray, params),
                                 jax.tree.map(jnp.asarray, stats), jds, capacity=CAPACITY,
                                 mesh=j_make_mesh(jax.devices()[:2]))
                jax_mesh2 = (jev.run(out_dir=str(tmp / "jax_mesh2")), tmp / "jax_mesh2")
        out = port.result()
    if setting == "IV":
        out["jax_mesh2"] = jax_mesh2
    ds = PanopticFileDataset(TREEINS_SPEC, [ply], grid_size=0.2, radius=7.0, keep_raw=True)
    return dict(setting=setting, runs=out, tiles=len(ds.test_tiles(0)), tmp=tmp)


def _labels(out_dir, kind):
    return read_ply(str(out_dir / f"{LABELS[kind]}.ply"))["preds"]


def _mesh_runs(scenes):
    return [k for k in scenes["runs"] if k.startswith("mesh")]


def test_scene_is_nontrivial(scenes):
    """14 tiles: D = 3 pads its last group; instances survive merging."""
    assert scenes["tiles"] == 14 and scenes["tiles"] % 3 != 0
    ins = _labels(scenes["runs"]["seq"][1], "instance")
    assert len(np.unique(ins[ins >= 0])) >= 2


@pytest.mark.parametrize("kind", ["semantic", "instance"])
def test_mesh_labels_match_sequential(scenes, kind):
    want = _labels(scenes["runs"]["seq"][1], kind)
    for name in _mesh_runs(scenes):
        np.testing.assert_array_equal(_labels(scenes["runs"][name][1], kind), want,
                                      err_msg=name)


def test_mesh_reports_match_sequential(scenes):
    want = scenes["runs"]["seq"][0]
    for name in _mesh_runs(scenes):
        got = scenes["runs"][name][0]
        assert len(got) == len(want) == 1 and got[0] == want[0], name
        for f in ("Evaluation_0.txt", "eval_manifest.json"):
            assert ((scenes["runs"][name][1] / f).read_text()
                    == (scenes["runs"]["seq"][1] / f).read_text()), (name, f)


@pytest.mark.parametrize("kind", ["semantic", "instance"])
def test_mesh_labels_match_jax_mesh(scenes, kind):
    if scenes["setting"] != "IV":
        assert "jax_mesh2" not in scenes["runs"]
        return
    want = _labels(scenes["runs"]["jax_mesh2"][1], kind)
    for name in _mesh_runs(scenes):
        np.testing.assert_array_equal(_labels(scenes["runs"][name][1], kind), want,
                                      err_msg=name)


def test_scoreless_setting_keeps_every_proposal(scenes):
    """Setting I has no scorer: the report of its mesh scene has instances
    and the manifest names the scene."""
    rep, out = scenes["runs"]["mesh2"]
    assert np.isfinite(rep[0]["meanPQ"])
    assert json.loads((out / "eval_manifest.json").read_text()) == {"0": "forest.ply"}
    ins = _labels(out, "instance")
    assert len(np.unique(ins[ins >= 0])) >= 2


def test_cli_refuses_more_ranks_than_cards(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="num_devices=2 but only 1 CUDA devices"):
        cli_eval.main([f"checkpoint_dir={tmp_path}", "data.files.test=[none.ply]",
                       "num_devices=2"])


def test_mesh_takes_one_tile_per_dispatch(ply):
    cfg = PanopticConfig(**CFG)
    ds = PanopticFileDataset(TREEINS_SPEC, [ply], grid_size=0.2, radius=7.0, keep_raw=True)
    mesh = Mesh((torch.device("cpu"),) * 2, 0, "gloo")
    with pytest.raises(ValueError, match="tiles_per_dispatch must be 1"):
        FullSceneEvaluator(cfg, PointGroup3HeadsNet(cfg), ds, capacity=CAPACITY,
                           tiles_per_dispatch=2, mesh=mesh)
