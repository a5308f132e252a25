"""The port's forward CLI (``cli/forward.py``) against the JAX package's
``forward_scripts/forward.py`` on the same weights: the JAX initial weights
of the tiny plan with random BN statistics, saved as a JAX checkpoint and,
through ``params_from_flax``, as a port checkpoint with the same run config
(``conf/eval.yaml``, the test's budgets, 4,096-row tiles of 7 m), over a
small synthetic forest. The JAX script walks the tiles one by one; the port
runs at one tile per dispatch. The JAX side runs as its own tests run it:
f32, ``use_winconv="off"``, ``rg_dense="on"``, numpy voxelization and tile
queries.

Tolerances: the ``x y z`` columns and the semantic labels identical; the
instance partition identical up to relabelling (a one-to-one map between
the two packages' instance ids, ``-1`` to ``-1``)."""

import importlib.util
import os.path as osp
import sys

import jax
import numpy as np
import optax
import pytest
import torch

from panopticsegforlargescalepointcloud_tpu.data import collate_tiles as j_collate
from panopticsegforlargescalepointcloud_tpu.data import synthetic_tile
from panopticsegforlargescalepointcloud_tpu.models.pointgroup3heads import (
    PanopticConfig as JConfig,
    PointGroup3HeadsNet as JNet,
)
from panopticsegforlargescalepointcloud_tpu.ops import native
from panopticsegforlargescalepointcloud_tpu.train.checkpoint import ModelCheckpoint as JCheckpoint
from panopticsegforlargescalepointcloud_tpu.train.step import (
    batch_arrays,
    init_state,
    prepare_example,
)
from panopticsegforlargescalepointcloud_tpu_torch.cli import eval as cli_eval
from panopticsegforlargescalepointcloud_tpu_torch.cli import forward as cli_forward
from panopticsegforlargescalepointcloud_tpu_torch.config import load_config
from panopticsegforlargescalepointcloud_tpu_torch.data.ply import read_ply
from panopticsegforlargescalepointcloud_tpu_torch.train.checkpoint import ModelCheckpoint
from panopticsegforlargescalepointcloud_tpu_torch.weights import params_from_flax
from test_data import make_forest_ply

torch.set_num_threads(2)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CAPACITY = 4096
CFG = dict(
    num_classes=2, stuff_classes=(0,), backbone="tiny", feat_dim=4, in_feat=8, num_samples=1,
    max_instances=16, max_props_rg=32, ms_max_seeds=32, ms_max_clusters=8, ms_point_cap=2048,
    cluster_radius=0.3, min_cluster_points=10, rg_point_cap=0.5, compute_dtype="float32",
    scorer_capacity_mult=1.0,
)
JAX_ONLY = dict(use_winconv="off", rg_dense="on")


def _random_stats(tree, rng):
    return {k: (_random_stats(v, rng) if hasattr(v, "items") else
                (np.abs(rng.normal(scale=0.3, size=v.shape)) + 0.5 if k == "var"
                 else rng.normal(scale=0.1, size=v.shape)).astype(np.float32))
            for k, v in tree.items()}


def _run_config(budgets):
    run_cfg = load_config(cli_eval.CONF_DIR, [
        "models.PointGroup-PAPER.feat_size=8", "data.radius=7",
        f"data.voxel_capacity={CAPACITY}", f"data.eval_voxel_capacity={CAPACITY}"],
        root="eval.yaml")
    run_cfg["backbone"] = "tiny"
    run_cfg["budget_overrides"] = {k: v for k, v in budgets.items() if k not in (
        "num_classes", "stuff_classes", "backbone", "feat_dim", "in_feat", "num_samples")}
    return run_cfg


def _jax_forward(argv):
    spec = importlib.util.spec_from_file_location(
        "jax_forward_script", osp.join(ROOT, "forward_scripts", "forward.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    saved = sys.argv
    sys.argv = ["forward.py"] + argv
    try:
        mod.main()
    finally:
        sys.argv = saved


@pytest.fixture(scope="module")
def forwards(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("forward")
    ply = str(tmp / "forest.ply")
    make_forest_ply(ply, np.random.default_rng(2022), n_trees=4, extent=14.0)
    jcfg = JConfig(**CFG, **JAX_ONLY)
    vb = j_collate([synthetic_tile(np.random.default_rng(0), num_classes=2,
                                   stuff_classes=(0,))], capacity=CAPACITY, num_tiles=1)
    db, hier = prepare_example(batch_arrays(vb), jcfg.num_down)
    state = init_state(jcfg, JNet(jcfg), optax.adam(1e-3), db, hier, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, state.params)
    stats = _random_stats(jax.tree.map(np.asarray, state.batch_stats), np.random.default_rng(1))

    JCheckpoint(str(tmp / "jck"), run_config=_run_config({**CFG, **JAX_ONLY})
                ).save_best_models_under_current_metrics(
        {"params": params, "batch_stats": stats}, None, {"train": {"loss": 1.0}})
    ModelCheckpoint(str(tmp / "pck"), run_config=_run_config(CFG)
                    ).save_best_models_under_current_metrics(
        {"state_dict": params_from_flax(params, stats)}, None, {"train": {"loss": 1.0}})
    test = f"data.files.test=[{ply}]"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "available", lambda: False)
        _jax_forward([f"checkpoint_dir={tmp / 'jck'}", test, f"out_dir={tmp / 'jax'}"])
    written = cli_forward.main([f"checkpoint_dir={tmp / 'pck'}", test, f"out_dir={tmp / 'port'}",
                                "device=cpu", "tiles_per_dispatch=1"])
    return dict(tmp=tmp, ply=ply, written=written,
                jax=read_ply(str(tmp / "jax" / "forest_pred.ply")),
                port=read_ply(str(tmp / "port" / "forest_pred.ply")))


def test_forward_writes_one_ply_per_file(forwards):
    assert forwards["written"] == {forwards["ply"]: str(forwards["tmp"] / "port" /
                                                        "forest_pred.ply")}
    assert list(forwards["port"]) == ["x", "y", "z", "pred_sem", "pred_ins"]
    assert list(forwards["port"]) == list(forwards["jax"])


@pytest.mark.parametrize("col", ["x", "y", "z", "pred_sem"])
def test_forward_columns_match_jax(forwards, col):
    np.testing.assert_array_equal(forwards["port"][col], forwards["jax"][col])


def test_forward_instances_match_jax_up_to_relabelling(forwards):
    a = forwards["port"]["pred_ins"].astype(np.int64)
    b = forwards["jax"]["pred_ins"].astype(np.int64)
    np.testing.assert_array_equal(a < 0, b < 0)
    pairs = np.unique(np.stack([a, b], 1), axis=0)
    assert len(pairs) == len(np.unique(a)) == len(np.unique(b))
    assert len(np.unique(a[a >= 0])) >= 2  # a non-trivial partition


def test_forward_defaults_to_gpu(forwards):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    tmp = forwards["tmp"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_forward.main([f"checkpoint_dir={tmp / 'pck'}", f"data.files.test=[{forwards['ply']}]",
                          f"out_dir={tmp / 'gpu'}"])
