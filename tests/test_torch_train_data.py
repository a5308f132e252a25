"""The train-side data of the port against the JAX package's, on the same
numpy inputs: the sampling tables, ``sample_train_tile`` through three
transform lists (the NPM3D flagship's ``train_transforms`` on an NPM3D-format
scan, ``treeins_rad8``'s on a forest, and one list holding each of
ElasticDistortion, RandomDropout, SphereCrop, CubeCrop and DensityFilter),
``class_weights``, the prefetcher's batches for 0, 1 and 3 workers, the
neighbour-count diagnostic, and the default stacks against the hand-written
paper stack (``augment_tile`` + ``finalize_tile``).

Both datasets draw from generators of one seed in the same order. Tolerances:
coords, labels, origin ids, instance counts and class weights exact;
positions, features and vote offsets within 1e-6 (the same numpy arithmetic:
equal in practice). The JAX side takes its numpy paths (its optional C++
tile queries are switched off)."""

import os.path as osp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticsegforlargescalepointcloud_tpu.cluster.neighbors import radius_neighbors
from panopticsegforlargescalepointcloud_tpu.data import NPM3D_SPEC as J_NPM3D
from panopticsegforlargescalepointcloud_tpu.data import TREEINS_SPEC as J_TREEINS
from panopticsegforlargescalepointcloud_tpu.data import PanopticFileDataset as JDataset
from panopticsegforlargescalepointcloud_tpu.data import collate_tiles as j_collate
from panopticsegforlargescalepointcloud_tpu.data.prefetch import BatchPrefetcher as JPrefetcher
from panopticsegforlargescalepointcloud_tpu.ops import native
from panopticsegforlargescalepointcloud_tpu_torch.config import load_config
from panopticsegforlargescalepointcloud_tpu_torch.data import (
    NPM3D_SPEC,
    TREEINS_SPEC,
    PanopticFileDataset,
    collate_tiles,
)
from panopticsegforlargescalepointcloud_tpu_torch.data.ply import write_ply
from panopticsegforlargescalepointcloud_tpu_torch.data.prefetch import BatchPrefetcher
from panopticsegforlargescalepointcloud_tpu_torch.data.labels import set_extra_labels
from panopticsegforlargescalepointcloud_tpu_torch.data.transform_pipeline import (
    DEFAULT_TEST_TRANSFORMS,
    DEFAULT_TRAIN_TRANSFORMS,
    GEOMETRIC,
    TileState,
    build_pipeline,
)
from panopticsegforlargescalepointcloud_tpu_torch.data.transforms import (
    augment_tile,
    finalize_tile,
)
from panopticsegforlargescalepointcloud_tpu_torch.utils.debugging import (
    neighbour_count_stats,
    radius_neighbor_counts,
)
from test_data import make_forest_ply
from torch_jax_cache import jax_compilation_cache  # noqa: F401 (autouse)

torch.set_num_threads(2)

CONF = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "conf")
N_TILES = 6
EXACT = ("coords", "y", "instance_labels", "origin_id", "num_instances")
CLOSE = ("pos", "feats", "vote_label")

FINALIZE = [e for e in DEFAULT_TRAIN_TRANSFORMS if e["transform"] not in GEOMETRIC]
EXTRA = [
    {"transform": "ElasticDistortion",
     "params": {"granularity": [0.4, 1.6], "magnitude": [0.2, 0.4], "apply_prob": 1.0}},
    {"transform": "RandomDropout",
     "params": {"dropout_ratio": 0.3, "dropout_application_ratio": 1.0}},
    {"transform": "SphereCrop", "params": {"radius": 6.0}},
    {"transform": "CubeCrop", "params": {"c": 5.0, "rot_x": 10, "rot_y": 10, "rot_z": 180}},
    {"transform": "DensityFilter", "params": {"radius_nn": 0.6, "min_num": 3}},
] + FINALIZE


def _npm3d_ply(path, rng):
    """A 20 m NPM3D-format scan: ground (raw class 1), poles and cars
    (raw 3 and 8, things) with instance labels."""
    pts, cls, ins = [rng.uniform([0, 0, -0.05], [20, 20, 0.05], (3000, 3))], [
        np.full(3000, 1)], [np.full(3000, -1)]
    for i in range(8):
        c = rng.uniform(2, 18, 2)
        raw = 3 if i % 2 else 8
        size = (0.2, 0.2, 4.0) if raw == 3 else (2.0, 1.0, 1.5)
        p = np.concatenate([c, [0.0]]) + rng.uniform(0, 1, (250, 3)) * size
        pts.append(p)
        cls.append(np.full(250, raw))
        ins.append(np.full(250, i))
    write_ply(path, [np.concatenate(pts).astype(np.float32),
                     np.concatenate(cls).astype(np.int32), np.concatenate(ins).astype(np.int32)],
              ["x", "y", "z", "scalar_class", "scalar_label"])


def _case(name, tmp):
    """(JAX spec, port spec, ply, data kwargs) of one transform list."""
    if name == "npm3d":
        data = load_config(CONF, ["data=panoptic/npm3d-sparseconv_grid_012_R_16_cylinder_area1"]
                           )["data"]
        ply = str(tmp / "npm3d.ply")
        _npm3d_ply(ply, np.random.default_rng(3))
        return J_NPM3D, NPM3D_SPEC, ply, dict(grid_size=float(data["grid_size"]), radius=8.0,
                                              train_transforms=data["train_transforms"])
    ply = str(tmp / "forest.ply")
    make_forest_ply(ply, np.random.default_rng(4), n_trees=5, extent=16.0)
    if name == "treeins":
        data = load_config(CONF, [])["data"]
        return J_TREEINS, TREEINS_SPEC, ply, dict(grid_size=float(data["grid_size"]),
                                                  radius=float(data["radius"]) - 2,
                                                  train_transforms=data["train_transforms"])
    return J_TREEINS, TREEINS_SPEC, ply, dict(grid_size=0.2, radius=6.0, train_transforms=EXTRA)


@pytest.fixture(scope="module", params=["npm3d", "treeins", "extra"])
def datasets(request, tmp_path_factory):
    jspec, spec, ply, kw = _case(request.param, tmp_path_factory.mktemp(request.param))
    # the JAX side's numpy paths, for as long as its dataset samples
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "available", lambda: False)
        jds = JDataset(jspec, [ply], rng=np.random.default_rng(9), **kw)
        ds = PanopticFileDataset(spec, [ply], rng=np.random.default_rng(9), **kw)
        yield request.param, jds, ds


def test_sampling_tables_match_jax(datasets):
    _, jds, ds = datasets
    np.testing.assert_array_equal(ds._centres, jds._centres)
    np.testing.assert_array_equal(ds._labels, jds._labels)
    np.testing.assert_array_equal(ds._label_probs, jds._label_probs)


def test_train_tiles_match_jax(datasets):
    name, jds, ds = datasets
    jrng, rng = np.random.default_rng(21), np.random.default_rng(21)
    for i in range(N_TILES):
        want, got = jds.sample_train_tile(jrng), ds.sample_train_tile(rng)
        assert set(got) == set(want), i
        for k in EXACT:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name} tile {i} {k}")
        for k in CLOSE:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                       err_msg=f"{name} tile {i} {k}")
    # the generators stand at the same place: every draw was made alike
    assert rng.random() == jrng.random()


def test_train_tiles_are_augmented(datasets):
    """Two draws of one cylinder differ (the augmentations ran) and carry
    instances; the extra list's subsetting transforms drop points."""
    name, _, ds = datasets
    tiles = [ds.sample_train_tile(np.random.default_rng(s)) for s in (1, 1, 2)]
    np.testing.assert_array_equal(tiles[0]["coords"], tiles[1]["coords"])
    assert not np.array_equal(tiles[0]["feats"][:5], tiles[2]["feats"][:5])
    assert all(t["num_instances"] >= 1 for t in tiles)
    if name == "extra":
        # the same cylinder as a test tile (no subsetting) keeps more voxels
        query = ds._query_tile(0, ds._centres[0, :3])
        train = ds._make_tile(query, np.random.default_rng(0), train=True)
        test = ds._make_tile(query, np.random.default_rng(0), train=False)
        assert len(train["pos"]) < len(test["pos"])


def test_class_weights_match_jax(datasets):
    _, jds, ds = datasets
    np.testing.assert_array_equal(ds.class_weights(), jds.class_weights())
    assert ds.num_classes == jds.num_classes


def _batch_equal(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def test_prefetcher_batches_for_0_1_3_workers(datasets):
    """Batch i comes from ``default_rng([seed, i])`` whatever the worker
    count, in index order, and equals the JAX prefetcher's batch."""
    _, jds, ds = datasets

    def make(rng):
        return collate_tiles([ds.sample_train_tile(rng) for _ in range(2)], capacity=4096,
                             num_tiles=2)

    runs = {}
    for workers in (0, 1, 3):
        pf = BatchPrefetcher(make, seed=5, num_workers=workers, prefetch=2)
        try:
            runs[workers] = [next(pf) for _ in range(4)]
        finally:
            pf.close()
    jpf = JPrefetcher(lambda rng: j_collate([jds.sample_train_tile(rng) for _ in range(2)],
                                            capacity=4096, num_tiles=2), seed=5, num_workers=0)
    want = [next(jpf) for _ in range(4)]
    for workers, batches in runs.items():
        for i, (got, ref) in enumerate(zip(batches, runs[0])):
            assert _batch_equal(got, ref), (workers, i)
    for i, (got, ref) in enumerate(zip(runs[0], want)):
        assert _batch_equal(got, ref), ("jax", i)
    assert not _batch_equal(runs[0][0], runs[0][1])


def test_prefetcher_surfaces_a_worker_error():
    def make(rng):
        raise RuntimeError("bad tile")

    pf = BatchPrefetcher(make, seed=0, num_workers=2)
    try:
        with pytest.raises(RuntimeError, match="bad tile"):
            next(pf)
    finally:
        pf.close()


@pytest.mark.parametrize("radius,k", [(0.3, 16), (0.6, 16), (0.6, 64)])
def test_neighbour_counts_match_jax(radius, k):
    """The diagnostic counts what the JAX package's fixed-K radius search
    returns, saturated rows and cell-capped candidates included
    (grid-quantized points: no pair rounds across the radius)."""
    rng = np.random.default_rng(int(radius * 10) + k)
    n = 4000
    pos = (np.round(rng.uniform(0, 3, (n, 3)) / 0.05) * 0.05).astype(np.float32)
    batch = rng.integers(0, 3, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    idx, _ = radius_neighbors(jnp.asarray(pos), jnp.asarray(batch), jnp.asarray(valid),
                              radius, k=k)
    want = (np.asarray(idx) >= 0).sum(-1)
    got = radius_neighbor_counts(torch.from_numpy(pos), torch.from_numpy(batch),
                                 torch.from_numpy(valid), radius, k).numpy()
    np.testing.assert_array_equal(got, want)
    stats = neighbour_count_stats(pos, batch, valid, radius, k)
    assert stats["nbr_mean"] == pytest.approx(want[valid].mean())
    assert stats["nbr_saturated"] == pytest.approx((want[valid] >= k).mean())
    if radius == 0.6 and k == 16:
        assert 0 < stats["nbr_saturated"] < 1


@pytest.mark.parametrize("train", [True, False])
def test_default_stacks_are_the_paper_stack(train):
    """The pipeline's default lists give what ``augment_tile`` +
    ``finalize_tile`` compute by hand, from the same draws."""
    rng = np.random.default_rng(0)
    pos = rng.uniform(-5, 5, (800, 3)).astype(np.float32)
    y = rng.integers(0, 3, 800).astype(np.int32)
    inst = np.where(y == 1, rng.integers(1, 5, 800), 0).astype(np.int32)
    origin = np.arange(800, dtype=np.int32)
    rng = np.random.default_rng(7)
    pipe = build_pipeline(DEFAULT_TRAIN_TRANSFORMS if train else DEFAULT_TEST_TRANSFORMS, 0.25)
    st = TileState(pos=pos.copy(), attrs={"y": y, "instance_labels": inst, "origin_id": origin},
                   train=train)
    pipe.run_geometric(st, rng)
    extra = set_extra_labels(st.pos, y, inst, (1,), 16)
    st.attrs.update(instance_labels=extra["instance_labels"], vote_label=extra["vote_label"])
    pipe.run_finalize(st, rng)
    rng = np.random.default_rng(7)
    p = augment_tile(pos.copy(), rng) if train else pos.copy()
    extra = set_extra_labels(p, y, inst, (1,), 16)
    want = finalize_tile(p, {"y": y, "origin_id": origin, "instance_labels":
                             extra["instance_labels"], "vote_label": extra["vote_label"]},
                         0.25, rng, train=train)
    np.testing.assert_array_equal(st.coords, want["coords"])
    np.testing.assert_allclose(st.pos, want["pos"], rtol=1e-6)
    np.testing.assert_allclose(st.feats, want["feats"], rtol=1e-6)
    for k in ("y", "instance_labels", "origin_id"):
        np.testing.assert_array_equal(st.attrs[k], want[k])
