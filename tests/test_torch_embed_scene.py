"""Setting I's whole scene: the port's ``FullSceneEvaluator`` against the
JAX package's on the small synthetic forest of ``test_torch_evaluator.py``
(4 trees, 14 m, 4,096-row tiles), tiny plan, at 1 and 2 tiles per dispatch.
Setting I has no scores, so every mean-shift proposal reaches block
merging. Also the embed strategy 12 (random subsets drawn per (vote, tile)
counter) at 2 tiles per dispatch against the JAX evaluator's.

The JAX side runs as its own tests run it: f32, ``use_winconv="off"``,
``rg_dense="on"``, its numpy voxelization and tile queries. Weights: the
port's initializers as a flax tree, random BN statistics. Per-point
semantic and instance labels must be identical; report floats within
1e-6. Then Setting I through the train and forward CLIs on the CPU
(``models=panoptic/area4_ablation_19``), as the JAX package's CLIs take
it."""

import json

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
from panopticsegforlargescalepointcloud_tpu.train.evaluator import (
    FullSceneEvaluator as JEvaluator,
)
from panopticsegforlargescalepointcloud_tpu_torch.cli import forward as cli_forward
from panopticsegforlargescalepointcloud_tpu_torch.cli import train as cli_train
from panopticsegforlargescalepointcloud_tpu_torch.data import TREEINS_SPEC, PanopticFileDataset
from panopticsegforlargescalepointcloud_tpu_torch.data.ply import read_ply
from panopticsegforlargescalepointcloud_tpu_torch.models import (
    PanopticConfig,
    PointGroup3HeadsNet,
)
from panopticsegforlargescalepointcloud_tpu_torch.train.evaluator import FullSceneEvaluator
from panopticsegforlargescalepointcloud_tpu_torch.weights import params_from_flax
from test_data import make_forest_ply
from test_torch_settings import _flax_tree

torch.set_num_threads(2)

CAPACITY = 4096
BASE = dict(
    num_classes=2, stuff_classes=(0,), backbone="tiny", feat_dim=4, in_feat=8, num_samples=1,
    max_instances=16, max_props_rg=32, ms_max_seeds=32, ms_max_clusters=8, ms_point_cap=2048,
    cluster_radius=0.3, min_cluster_points=10, rg_point_cap=0.5, compute_dtype="float32",
    model_family="embed", use_score_net=False,
)
LABELS = {"semantic": "Semantic_results_forEval_0", "instance": "Instance_Results_forEval0"}
RUNS = [("setting1", 7, 1), ("setting1", 7, 2), ("embed12", 12, 2)]


@pytest.fixture(scope="module")
def ply(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("forest") / "forest.ply")
    make_forest_ply(path, np.random.default_rng(2022), n_trees=4, extent=14.0)
    return path


@pytest.fixture(scope="module", params=RUNS, ids=lambda r: f"{r[0]}-g{r[2]}")
def scene(request, ply, tmp_path_factory):
    name, cluster_type, g = request.param
    tmp = tmp_path_factory.mktemp(f"{name}_g{g}")
    kw = dict(BASE, cluster_type=cluster_type)
    cfg = PanopticConfig(**kw)
    params, stats = _flax_tree(cfg, 3)
    jcfg = JConfig(**kw, use_winconv="off", rg_dense="on")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "available", lambda: False)
        jds = JDataset(J_TREEINS, [ply], grid_size=0.2, radius=7.0, keep_raw=True)
        jev = JEvaluator(jcfg, JNet(jcfg), params, stats, jds, capacity=CAPACITY,
                         tiles_per_dispatch=g)
        jrep = jev.run(out_dir=str(tmp / "jax"))
    model = PointGroup3HeadsNet(cfg)
    model.load_state_dict(params_from_flax(params, stats), strict=True)
    ds = PanopticFileDataset(TREEINS_SPEC, [ply], grid_size=0.2, radius=7.0, keep_raw=True)
    ev = FullSceneEvaluator(cfg, model, ds, capacity=CAPACITY, tiles_per_dispatch=g,
                            device="cpu")
    rep = ev.run(out_dir=str(tmp / "port"))
    return dict(name=name, g=g, tmp=tmp, jrep=jrep, rep=rep,
                tiles=len(ds.test_tiles(0)), overflow=ev.last_overflow)


def _labels(scene, who, kind):
    return read_ply(str(scene["tmp"] / who / f"{LABELS[kind]}.ply"))["preds"]


@pytest.mark.parametrize("kind", ["semantic", "instance"])
def test_labels_match_jax(scene, kind):
    np.testing.assert_array_equal(_labels(scene, "port", kind), _labels(scene, "jax", kind))


def test_reports_match_jax(scene):
    got, want = scene["rep"], scene["jrep"]
    assert len(got) == len(want) == 1 and set(got[0]) == set(want[0])
    for k, v in want[0].items():
        assert got[0][k] == pytest.approx(v, abs=1e-6), k


def test_scene_is_nontrivial(scene):
    """Several tiles (several dispatches at g = 2), instances after merging,
    and no scorer overflow without a ScoreNet."""
    assert scene["tiles"] >= 3
    ins = _labels(scene, "port", "instance")
    assert len(np.unique(ins[ins >= 0])) >= 2
    assert scene["overflow"]["scorer_overflow"] == 0


def test_cli_train_and_forward_setting1(ply, tmp_path):
    """Two epochs of the tiny Setting I (the second with clustering) on
    synthetic tiles, then the forward CLI on the forest from that run."""
    run_dir = tmp_path / "run"
    model = "models.PointGroup-PAPER"
    trainer = cli_train.main([
        "models=panoptic/area4_ablation_19", "data=panoptic/treeins_rad8", "backbone=tiny",
        "device=cpu", "pretty_print=False", "training.epochs=2", "training.batch_size=2",
        "training.samples_per_epoch=4", "training.num_workers=0", "data.voxel_capacity=4096",
        f"checkpoint_dir={run_dir}", f"{model}.feat_size=8", f"{model}.prepare_epoch=1",
        f"{model}.ms_point_cap=1024"])
    assert trainer.pcfg.model_family == "embed" and not trainer.pcfg.use_score_net
    lines = [json.loads(x) for x in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert len(lines) == 2
    logged = set().union(*(line.keys() for line in lines))
    assert not any("offset" in k or "score_loss" in k for k in logged)
    assert any("cluster_overflow" in k for k in logged)
    written = cli_forward.main([f"checkpoint_dir={run_dir}", "device=cpu",
                                "models=panoptic/area4_ablation_19",
                                f"data.files.test=[{ply}]", f"out_dir={tmp_path / 'fwd'}"])
    out = read_ply(written[ply])
    assert len(out["pred_sem"]) == len(read_ply(ply)["x"])
    assert set(np.unique(out["pred_sem"])) <= {0, 1}
