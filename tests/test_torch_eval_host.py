"""The serving slice's modules one by one against the JAX package's, on the
same numpy inputs: PLY io, grid sampling, the test transform pipeline and
tiling, instance extraction (device IoU in the port, host numpy in JAX),
``get_instances``, block merging and finalise, the PQ report, the
confusion matrix and the checkpoint's bookkeeping.

Tolerances: exact (byte-identical files, identical arrays and lists) for
all of it, but the report floats (1e-9: the same numpy arithmetic) and the
f32 NMS masks (exact 0/1). The JAX side takes its numpy paths (its optional
C++ voxelization and tile queries are switched off)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticsegforlargescalepointcloud_tpu.cluster import nms as j_nms
from panopticsegforlargescalepointcloud_tpu.data import TREEINS_SPEC as J_TREEINS
from panopticsegforlargescalepointcloud_tpu.data import PanopticFileDataset as JDataset
from panopticsegforlargescalepointcloud_tpu.data import ply as j_ply
from panopticsegforlargescalepointcloud_tpu.data import voxelize as j_vox
from panopticsegforlargescalepointcloud_tpu.eval import extract as j_extract
from panopticsegforlargescalepointcloud_tpu.eval import merge as j_merge
from panopticsegforlargescalepointcloud_tpu.eval.confusion import ConfusionMatrix as JConfusion
from panopticsegforlargescalepointcloud_tpu.eval.panoptic_quality import final_eval as j_final_eval
from panopticsegforlargescalepointcloud_tpu.models.losses import Proposals as JProposals
from panopticsegforlargescalepointcloud_tpu.ops import native
from panopticsegforlargescalepointcloud_tpu.train import checkpoint as j_checkpoint
from panopticsegforlargescalepointcloud_tpu_torch.cluster import nms
from panopticsegforlargescalepointcloud_tpu_torch.data import TREEINS_SPEC, PanopticFileDataset
from panopticsegforlargescalepointcloud_tpu_torch.data import ply, voxelize
from panopticsegforlargescalepointcloud_tpu_torch.data.transform_pipeline import build_pipeline
from panopticsegforlargescalepointcloud_tpu_torch.eval import merge
from panopticsegforlargescalepointcloud_tpu_torch.eval.confusion import ConfusionMatrix
from panopticsegforlargescalepointcloud_tpu_torch.eval.extract import extract_clusters, pull
from panopticsegforlargescalepointcloud_tpu_torch.eval.panoptic_quality import final_eval
from panopticsegforlargescalepointcloud_tpu_torch.models import Proposals
from panopticsegforlargescalepointcloud_tpu_torch.train.checkpoint import ModelCheckpoint
from test_data import make_forest_ply

torch.set_num_threads(2)


@pytest.fixture
def numpy_paths(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)


# ------------------------------------------------------------------ PLY io


@pytest.mark.parametrize("text", [False, True])
def test_ply_roundtrip_and_bytes_match_jax(tmp_path, text):
    rng = np.random.default_rng(0)
    cols = [rng.normal(size=(50, 3)).astype(np.float32), rng.integers(-5, 5, 50).astype(np.int32),
            rng.integers(0, 255, 50).astype(np.uint8), rng.normal(size=50)]
    names = ["x", "y", "z", "label", "red", "value"]
    ply.write_ply(str(tmp_path / "port.ply"), cols, names, text=text)
    j_ply.write_ply(str(tmp_path / "jax.ply"), cols, names, text=text)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    back = ply.read_ply(str(tmp_path / "port.ply"))
    want = j_ply.read_ply(str(tmp_path / "jax.ply"))
    assert list(back) == names
    for k in names:
        np.testing.assert_array_equal(back[k], want[k])


@pytest.mark.parametrize("writer", ["to_eval_ply", "to_ins_ply"])
def test_eval_exports_byte_identical(tmp_path, writer):
    rng = np.random.default_rng(1)
    pos = rng.normal(size=(200, 3)).astype(np.float32)
    pred = rng.integers(-1, 6, 200)
    gt = rng.integers(0, 6, 200)
    args = (pos, pred, gt) if writer == "to_eval_ply" else (pos, pred)
    getattr(ply, writer)(str(tmp_path / "port.ply"), *args)
    getattr(j_ply, writer)(str(tmp_path / "jax.ply"), *args)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()


# ----------------------------------------------------- voxelization, tiling


@pytest.mark.parametrize("mode", ["last", "mean"])
def test_grid_sample_matches_jax(numpy_paths, mode):
    rng = np.random.default_rng(2)
    pos = (rng.normal(size=(3000, 3)) * 2.0).astype(np.float32)
    attrs = {"y": rng.integers(0, 3, 3000), "instance_labels": rng.integers(0, 9, 3000),
             "origin_id": np.arange(3000, dtype=np.int64),
             "feat": rng.normal(size=(3000, 2)).astype(np.float32)}
    got = voxelize.grid_sample(pos, attrs, 0.3, mode=mode, rng=np.random.default_rng(7),
                               return_cluster=True)
    want = j_vox.grid_sample(pos, attrs, 0.3, mode=mode, rng=np.random.default_rng(7),
                             return_cluster=True)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    for k in attrs:
        np.testing.assert_array_equal(got[1][k], want[1][k])


@pytest.fixture(scope="module")
def forest(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("forest") / "forest.ply")
    make_forest_ply(path, np.random.default_rng(3), n_trees=4, extent=14.0)
    return path


@pytest.mark.parametrize("fmt,grid_shift", [("cylinder", 0.0), ("cylinder", 0.5),
                                            ("sphere", 0.0)])
def test_test_tiles_match_jax(numpy_paths, forest, fmt, grid_shift):
    kw = dict(grid_size=0.2, radius=7.0, keep_raw=True, sampling_format=fmt)
    jds = JDataset(J_TREEINS, [forest], **kw)
    pds = PanopticFileDataset(TREEINS_SPEC, [forest], **kw)
    for k in jds.clouds[0]:
        np.testing.assert_array_equal(pds.clouds[0][k], jds.clouds[0][k])
    for k in jds.raw_clouds[0]:
        np.testing.assert_array_equal(pds.raw_clouds[0][k], jds.raw_clouds[0][k])
    jt = jds.test_tiles(0, grid_shift=grid_shift)
    pt = pds.test_tiles(0, grid_shift=grid_shift)
    assert len(pt) == len(jt) > 1
    for (a, a_ids), (b, b_ids) in zip(pt, jt):
        np.testing.assert_array_equal(a_ids, b_ids)
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_processed_cache_reloads_the_same_cloud(forest, tmp_path):
    a = PanopticFileDataset(TREEINS_SPEC, [forest], 0.2, 7.0, processed_dir=str(tmp_path))
    b = PanopticFileDataset(TREEINS_SPEC, [forest], 0.2, 7.0, processed_dir=str(tmp_path),
                            rng=np.random.default_rng(99))
    for k in a.clouds[0]:
        np.testing.assert_array_equal(a.clouds[0][k], b.clouds[0][k])


@pytest.mark.parametrize("name", ["RandomNoise", "RandomRotate", "ElasticDistortion"])
def test_train_time_transforms_raise_by_name(name):
    # the train-time augmentations are ported: each builds into the
    # pipeline's geometric phase, and a name the registry lacks raises by name
    pipe = build_pipeline([{"transform": name}], 0.2)
    assert len(pipe.geometric) == 1 and not pipe.finalize
    with pytest.raises(ValueError, match=f"unknown transform '{name}X'"):
        build_pipeline([{"transform": name + "X"}], 0.2)


def test_unknown_transform_raises():
    with pytest.raises(ValueError, match="unknown transform"):
        build_pipeline([{"transform": "Nope"}], 0.2)


# ------------------------------------------------------ extraction and NMS


def _proposals(seed, n=300, p=40, sources=3):
    """A membership table as build_proposals lays it out (one block of N
    rows per source), with empty valid proposals and tied scores."""
    rng = np.random.default_rng(seed)
    point_idx = np.tile(np.arange(n, dtype=np.int32), sources)
    prop_id = np.full(n * sources, -1, np.int32)
    for s in range(sources):
        # contiguous runs of a few proposals per source
        ids = rng.integers(s * p // sources, (s + 1) * p // sources, n)
        keep = rng.random(n) < 0.7
        prop_id[s * n:(s + 1) * n] = np.where(keep, ids, -1)
    member_valid = prop_id >= 0
    prop_valid = rng.random(p) < 0.85
    prop_valid[[3, p - 1]] = True  # may hold no members: empty proposals
    arrays = dict(point_idx=np.where(member_valid, point_idx, -1), prop_id=prop_id,
                  member_valid=member_valid, prop_valid=prop_valid,
                  prop_batch=np.where(prop_valid, 0, -1).astype(np.int32),
                  prop_type=(np.arange(p) * sources // p).astype(np.int32))
    scores = rng.choice(np.array([0.3, 0.55, 0.7, 0.9], np.float32), p)  # many ties
    return arrays, scores


def _port_props(arrays):
    return Proposals(**{k: torch.from_numpy(np.array(v)) for k, v in arrays.items()})


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("variant", ["scores", "no_scores"])
def test_extract_clusters_matches_jax(seed, variant):
    arrays, scores = _proposals(seed)
    sc = None if variant == "no_scores" else scores
    kw = dict(nms_threshold=0.3, min_cluster_points=5, min_score=0.5)
    want_c, want_k = j_extract.extract_clusters(arrays, sc, 300, **kw)
    got_c, got_k = extract_clusters(
        _port_props(arrays), None if sc is None else torch.from_numpy(sc), 300, **kw)
    assert got_k == want_k and len(want_k) >= 2
    for a, b in zip(got_c, want_c):
        np.testing.assert_array_equal(a, b)


def test_get_instances_matches_jax():
    arrays, scores = _proposals(4)
    jprops = JProposals(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jkeep, jmasks = j_nms.get_instances(jprops, jnp.asarray(scores), 300,
                                        min_cluster_points=5)
    keep, masks = nms.get_instances(_port_props(arrays), torch.from_numpy(scores), 300,
                                    min_cluster_points=5)
    np.testing.assert_array_equal(masks.numpy(), np.asarray(jmasks))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert keep.any()


def test_pull_round_trips_dtypes_and_shapes():
    t = {"a": torch.arange(5, dtype=torch.int32), "b": torch.tensor([True, False, True]),
         "c": torch.randn(3, 7), "d": torch.tensor(4, dtype=torch.int32),
         "e": torch.zeros((0, 2), dtype=torch.float32)}
    got = pull(t)
    for k, v in t.items():
        assert got[k].dtype == v.numpy().dtype and got[k].shape == tuple(v.shape)
        np.testing.assert_array_equal(got[k], v.numpy())


# ------------------------------------------------- merging, finalise, report


def _tiles(seed, n_full=600, n_tiles=4):
    """Overlapping tiles of one cloud with random clusters and scores."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 10, (n_full, 3)).astype(np.float32)
    tiles = []
    for t in range(n_tiles):
        full_ids = np.sort(rng.choice(n_full, 300, replace=False))
        sub = full_ids[rng.random(300) < 0.6]
        logits = rng.normal(size=(len(sub), 2)).astype(np.float32)
        k = int(rng.integers(2, 6))
        clusters = [np.sort(rng.choice(len(sub), int(rng.integers(5, 40)), replace=False))
                    for _ in range(k)]
        scores = rng.random(k).astype(np.float32)
        tiles.append((sub, logits, full_ids, clusters, scores))
    return pos, tiles


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("th", [0.1, 0.01])
def test_block_merging_and_finalise_match_jax(seed, th):
    pos, tiles = _tiles(seed)
    acc, jacc = merge.SceneAccumulator(pos, 2), j_merge.SceneAccumulator(pos, 2)
    for sub, logits, full_ids, clusters, scores in tiles:
        acc.add_tile(sub, logits, full_ids, clusters, scores, th_merge=th)
        jacc.add_tile(sub, logits, full_ids, clusters, scores, th_merge=th)
        np.testing.assert_array_equal(acc.ins_pre, jacc.ins_pre)
        assert acc.max_instance == jacc.max_instance
    assert acc.max_instance >= 2
    for a, b in zip(acc.finalise(stuff_classes=(0,), min_instance_size=3),
                    jacc.finalise(stuff_classes=(0,), min_instance_size=3)):
        np.testing.assert_array_equal(a, b)
    gt = np.random.default_rng(seed).integers(-1, 2, len(pos))
    assert acc.vote_miou(gt, 2) == jacc.vote_miou(gt, 2)


@pytest.mark.parametrize("layout", ["treeins", "npm3d"])
def test_final_eval_matches_jax(tmp_path, layout):
    rng = np.random.default_rng(5)
    n = 5000
    if layout == "treeins":
        c, things, stuff = 2, [1], [0]
    else:
        c, things, stuff = 9, [2, 3, 4, 6, 7, 8], [0, 1, 5]
    gt_sem = rng.integers(-1, c, n)
    pre_sem = np.where(rng.random(n) < 0.8, gt_sem, rng.integers(0, c, n))
    gt_ins = np.where(np.isin(gt_sem, things), rng.integers(1, 12, n), 0)
    pre_ins = np.where(rng.random(n) < 0.85, gt_ins - 1, rng.integers(-1, 12, n))
    got = final_eval(pre_sem, pre_ins, gt_sem, gt_ins, c, things, stuff,
                     output_file=str(tmp_path / "port"))
    want = j_final_eval(pre_sem, pre_ins, gt_sem, gt_ins, c, things, stuff,
                        output_file=str(tmp_path / "jax"))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-9, nan_ok=True), k
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()


def test_confusion_matrix_matches_jax():
    rng = np.random.default_rng(6)
    gt, pred = rng.integers(0, 5, 1000), rng.integers(0, 5, 1000)
    a, b = ConfusionMatrix(5), JConfusion(5)
    a.count_predicted_batch(gt, pred)
    b.count_predicted_batch(gt, pred)
    np.testing.assert_array_equal(a.m, b.m)
    for name in ("get_average_intersection_union", "get_overall_accuracy",
                 "get_mean_class_accuracy"):
        assert getattr(a, name)() == getattr(b, name)()


# ------------------------------------------------------------- checkpoint


def test_checkpoint_bookkeeping_matches_jax(tmp_path):
    """The same sequence of saves: the same improved lists, best metrics,
    weight sets and resume epoch; the port's weights round-trip exactly."""
    rng = np.random.default_rng(8)
    sequence = [{"train": {"loss": 2.0}, "val": {"loss": 1.5, "miou": 0.3, "F1": 0.2}},
                {"train": {"loss": 1.0}, "val": {"loss": 1.7, "miou": 0.4, "F1": 0.1}},
                {"train": {"loss": 0.5}, "val": {"loss": 1.2, "miou": 0.35, "acc": 0.9}}]
    cfg = {"data": {"radius": 8}, "models": {"m": {"feat_size": 16}}}
    port = ModelCheckpoint(str(tmp_path / "port"), run_config=cfg)
    jax_ck = j_checkpoint.ModelCheckpoint(str(tmp_path / "jax"), run_config=cfg)
    weights = []
    for i, metrics in enumerate(sequence):
        w = {"w": rng.normal(size=(3, 4)).astype(np.float32), "b": np.float32(i)}
        weights.append(w)
        got = port.save_best_models_under_current_metrics(
            {"state_dict": {k: torch.tensor(v) for k, v in w.items()}},
            {"step": i}, metrics)
        want = jax_ck.save_best_models_under_current_metrics(w, [np.float32(i)], metrics)
        assert got == want
    again = ModelCheckpoint(str(tmp_path / "port"))
    ref = j_checkpoint.ModelCheckpoint(str(tmp_path / "jax"))
    assert again.best_metrics == ref._data["best_metrics"]
    assert again.start_epoch == ref.start_epoch == 4
    assert again.run_config == cfg
    assert sorted(again._data["models"]) == sorted(ref._data["models"])
    for name in ref._data["models"]:
        got = again.get_weights(name)["state_dict"]
        want = ref.get_weights(name)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert again.get_optimizer_state() == {"step": 2}
    with pytest.raises(KeyError, match="not found"):
        again.get_weights("best_nothing")
