"""The whole scene: the port's ``FullSceneEvaluator`` (tiling, eval forward,
device IoU + NMS, block merging, finalise, PQ report) against the JAX
package's on a small synthetic forest (4 trees, 14 m, 4,096-row tiles),
tiny plan, weights carried over with ``params_from_flax``; the port's
grouped dispatch (2 tiles per forward) against its sequential path; and
the port's eval CLI on the CPU from a port checkpoint. Voting runs 2 and 3
on the same scene are in ``test_torch_evaluator_votes.py``, which imports
this file's ``reference``, ``port_scene`` and ``jax_scenes``.

The JAX side runs as its own tests run it: f32, ``use_winconv="off"``,
``rg_dense="on"`` (dense pull in Pallas interpret mode), and the numpy
voxelization and tile queries (its optional C++ path is switched off).
Tolerances: per-point semantic and instance labels identical; report floats
within 1e-6."""

import concurrent.futures
import json

import jax
import numpy as np
import optax
import pytest
import torch

from panopticsegforlargescalepointcloud_tpu.data import (
    TREEINS_SPEC as J_TREEINS,
    PanopticFileDataset as JDataset,
    collate_tiles as j_collate,
    synthetic_tile,
)
from panopticsegforlargescalepointcloud_tpu.models.pointgroup3heads import (
    PanopticConfig as JConfig,
    PointGroup3HeadsNet as JNet,
)
from panopticsegforlargescalepointcloud_tpu.ops import native
from panopticsegforlargescalepointcloud_tpu.train.evaluator import (
    FullSceneEvaluator as JEvaluator,
)
from panopticsegforlargescalepointcloud_tpu.train.step import (
    batch_arrays,
    init_state,
    prepare_example,
)
from panopticsegforlargescalepointcloud_tpu_torch.cli import eval as cli_eval
from panopticsegforlargescalepointcloud_tpu_torch.config import load_config
from panopticsegforlargescalepointcloud_tpu_torch.data import TREEINS_SPEC, PanopticFileDataset
from panopticsegforlargescalepointcloud_tpu_torch.data.ply import read_ply
from panopticsegforlargescalepointcloud_tpu_torch.models import (
    PanopticConfig,
    PointGroup3HeadsNet,
)
from panopticsegforlargescalepointcloud_tpu_torch.train.checkpoint import ModelCheckpoint
from panopticsegforlargescalepointcloud_tpu_torch.train.evaluator import FullSceneEvaluator
from panopticsegforlargescalepointcloud_tpu_torch.weights import params_from_flax
from test_data import make_forest_ply
from torch_jax_cache import jax_compilation_cache  # noqa: F401 (autouse)

torch.set_num_threads(2)

CAPACITY = 4096
CFG = dict(
    num_classes=2, stuff_classes=(0,), backbone="tiny", feat_dim=4, in_feat=8, num_samples=1,
    max_instances=16, max_props_rg=32, ms_max_seeds=32, ms_max_clusters=8, ms_point_cap=2048,
    cluster_radius=0.3, min_cluster_points=10, rg_point_cap=0.5, compute_dtype="float32",
)
LABELS = {"semantic": "Semantic_results_forEval_0", "instance": "Instance_Results_forEval0"}


def _random_stats(tree, rng):
    return {k: (_random_stats(v, rng) if hasattr(v, "items") else
                (np.abs(rng.normal(scale=0.3, size=v.shape)) + 0.5 if k == "var"
                 else rng.normal(scale=0.1, size=v.shape)).astype(np.float32))
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The forest, the JAX package's initial weights with random BN
    statistics, and the port's model carrying them."""
    tmp = tmp_path_factory.mktemp("scene")
    ply = str(tmp / "forest.ply")
    make_forest_ply(ply, np.random.default_rng(2022), n_trees=4, extent=14.0)

    jcfg = JConfig(**CFG, use_winconv="off", rg_dense="on")
    jmodel = JNet(jcfg)
    vb = j_collate([synthetic_tile(np.random.default_rng(0), num_classes=2,
                                   stuff_classes=(0,))], capacity=CAPACITY, num_tiles=1)
    db, hier = prepare_example(batch_arrays(vb), jcfg.num_down)
    state = init_state(jcfg, jmodel, optax.adam(1e-3), db, hier, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, state.params)
    stats = _random_stats(jax.tree.map(np.asarray, state.batch_stats),
                          np.random.default_rng(1))
    cfg = PanopticConfig(**CFG)
    model = PointGroup3HeadsNet(cfg)
    model.load_state_dict(params_from_flax(params, stats), strict=True)
    return dict(tmp=tmp, ply=ply, cfg=cfg, model=model, jcfg=jcfg, jmodel=jmodel, params=params,
                stats=stats)


def port_scene(ref, g, out_dir, voting_runs=1):
    """The port's evaluator on the forest at g tiles per dispatch: its
    reports, written with the PLYs into ``out_dir``."""
    ds = PanopticFileDataset(TREEINS_SPEC, [ref["ply"]], grid_size=0.2, radius=7.0,
                             keep_raw=True)
    ev = FullSceneEvaluator(ref["cfg"], ref["model"], ds, capacity=CAPACITY,
                            tiles_per_dispatch=g, device="cpu")
    return ev.run(out_dir=str(out_dir), voting_runs=voting_runs)


def jax_scenes(ref, voting_runs):
    """The JAX evaluator's reports and output directories, one per entry of
    ``voting_runs`` (its compiled forward reused), with the JAX package's
    numpy voxelization and tile queries."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "available", lambda: False)
        jds = JDataset(J_TREEINS, [ref["ply"]], grid_size=0.2, radius=7.0, keep_raw=True)
        jev = JEvaluator(ref["jcfg"], ref["jmodel"], ref["params"], ref["stats"], jds,
                         capacity=CAPACITY)
        for runs in voting_runs:
            d = ref["tmp"] / (f"jax_v{runs}" if runs > 1 else "jax")
            out[runs] = (jev.run(out_dir=str(d), voting_runs=runs), d)
    return out


@pytest.fixture(scope="module")
def scene(reference):
    # the port's scenes run in a second thread while this one runs the JAX
    # evaluator (both leave the interpreter lock in their kernels)
    tmp = reference["tmp"]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(lambda: {g: (port_scene(reference, g, tmp / f"port_g{g}"),
                                        tmp / f"port_g{g}") for g in (1, 2)})
        jax_side = jax_scenes(reference, (1,))[1]
        runs = port.result()
    return dict(reference, jax=jax_side, port=runs)


def _labels(out_dir, kind):
    return read_ply(str(out_dir / f"{LABELS[kind]}.ply"))["preds"]


def test_scene_is_nontrivial(scene):
    """Several tiles, both classes predicted, instances kept after merging."""
    _, out = scene["port"][1]
    sem, ins = _labels(out, "semantic"), _labels(out, "instance")
    assert len(np.unique(sem)) == 2
    assert len(np.unique(ins[ins >= 0])) >= 2


@pytest.mark.parametrize("kind", ["semantic", "instance"])
def test_labels_match_jax(scene, kind):
    np.testing.assert_array_equal(_labels(scene["port"][1][1], kind),
                                  _labels(scene["jax"][1], kind))


@pytest.mark.parametrize("kind", ["semantic", "instance"])
def test_grouped_dispatch_matches_sequential(scene, kind):
    np.testing.assert_array_equal(_labels(scene["port"][2][1], kind),
                                  _labels(scene["port"][1][1], kind))


@pytest.mark.parametrize("other", ["jax", "port_g2"])
def test_reports_match(scene, other):
    want = scene["jax"][0] if other == "jax" else scene["port"][2][0]
    got = scene["port"][1][0]
    assert len(got) == len(want) == 1
    assert set(got[0]) == set(want[0])
    for k, v in want[0].items():
        assert got[0][k] == pytest.approx(v, abs=1e-6), k


def test_evaluation_report_text_matches_jax(scene):
    a = (scene["port"][1][1] / "Evaluation_0.txt").read_text().splitlines()
    b = (scene["jax"][1] / "Evaluation_0.txt").read_text().splitlines()
    assert [line.split(":")[0] for line in a] == [line.split(":")[0] for line in b]


def test_evaluator_needs_the_raw_clouds(scene):
    ds = PanopticFileDataset(TREEINS_SPEC, [scene["ply"]], grid_size=0.2, radius=7.0)
    with pytest.raises(ValueError, match="keep_raw"):
        FullSceneEvaluator(scene["cfg"], scene["model"], ds, capacity=CAPACITY, device="cpu")


def _checkpoint(scene, ckpt_dir):
    run_cfg = load_config(cli_eval.CONF_DIR, [
        "models.PointGroup-PAPER.feat_size=8", "data.radius=7",
        f"data.voxel_capacity={CAPACITY}", f"data.eval_voxel_capacity={CAPACITY}"],
        root="eval.yaml")
    run_cfg["backbone"] = "tiny"
    # the yaml's own budgets and radius give way to the test's
    run_cfg["budget_overrides"] = {k: v for k, v in CFG.items() if k not in (
        "num_classes", "stuff_classes", "backbone", "feat_dim", "in_feat", "num_samples")}
    run_cfg["budget_overrides"]["scorer_capacity_mult"] = 1.0
    ck = ModelCheckpoint(str(ckpt_dir), run_config=run_cfg)
    ck.save_best_models_under_current_metrics({"state_dict": scene["model"].state_dict()}, None,
                                              {"train": {"loss": 1.0}})
    return ck


def test_cli_eval_on_cpu(scene):
    tmp = scene["tmp"]
    _checkpoint(scene, tmp / "ckpt")
    out = tmp / "cli_out"
    reports = cli_eval.main([f"checkpoint_dir={tmp / 'ckpt'}", f"data.files.test=[{scene['ply']}]",
                             f"out_dir={out}", "device=cpu", "tiles_per_dispatch=1"])
    assert len(reports) == 1 and np.isfinite(reports[0]["meanPQ"])
    for name in ("Semantic_results_forEval_0.ply", "Instance_Results_forEval0.ply",
                 "Instance_results_withColor_0.ply", "Evaluation_0.txt"):
        assert (out / name).exists(), name
    assert json.loads((out / "eval_manifest.json").read_text()) == {"0": "forest.ply"}
    # the checkpoint's model is the tested one: the same labels as the direct run
    np.testing.assert_array_equal(_labels(out, "instance"),
                                  _labels(scene["port"][1][1], "instance"))


def test_cli_eval_defaults_to_gpu(scene):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    tmp = scene["tmp"]
    _checkpoint(scene, tmp / "ckpt_gpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_eval.build_evaluator([f"checkpoint_dir={tmp / 'ckpt_gpu'}",
                                  f"data.files.test=[{scene['ply']}]"])
