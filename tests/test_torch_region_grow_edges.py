"""Region growing's edge path against the JAX package on the same numpy
inputs: ``radius_neighbors`` (idx exact, dist2 within 1e-6 relative),
``radius_graph`` (fwd, rev and trunc exact; several ids, a binding k, a
binding ``cell_cap``, hubs whose in-edges overflow the reverse slots, a
row whose cell overflows the key bits, grid-quantised points with tied
distances), ``_grow_on_edges`` (labels exact, with ``max_iters`` binding and
not), ``region_grow_folded`` on its three edge branches (all rows at
``point_cap`` 0; the compacted rows with ``dense_pull`` off, and at a budget
that does not tile for the dense pull: every field exact, ``graph_trunc``
included), and ``build_proposals`` at ``rg_point_cap`` 0 for the 3heads
family's cluster type 5 and the embed family's type 8 (region growing on
positions): proposals exact."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticsegforlargescalepointcloud_tpu.cluster import neighbors as jnb
from panopticsegforlargescalepointcloud_tpu.models.pointgroup3heads import (
    PanopticConfig as JConfig,
    build_proposals as j_build_proposals,
)
from panopticsegforlargescalepointcloud_tpu_torch.cluster import neighbors as tnb
from panopticsegforlargescalepointcloud_tpu_torch.models import PanopticConfig, build_proposals
from panopticsegforlargescalepointcloud_tpu_torch.ops.hashing import BitLayout
from torch_jax_cache import jax_compilation_cache  # noqa: F401 (autouse)

torch.set_num_threads(2)

# each package's cluster/__init__.py exports a function of the module's name
jrg = importlib.import_module("panopticsegforlargescalepointcloud_tpu.cluster.region_grow")
trg = importlib.import_module("panopticsegforlargescalepointcloud_tpu_torch.cluster.region_grow")


def _cloud(seed, n, ids, extent, grid=None, far=False):
    """n points in [0, extent)^3 with ids in [0, ids); ``grid``: quantised
    to that step (tied distances); ``far``: row 0 moved 400 m away from
    the other rows of its id (its shifted cell overflows 9-bit axes)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, extent, size=(n, 3))
    if grid is not None:
        pos = np.round(pos / grid) * grid
    if far:
        pos[0, 0] += 400.0
    return (pos.astype(np.float32), rng.integers(0, ids, n).astype(np.int32),
            rng.random(n) > 0.1)


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


# name: (n, ids, extent, grid, far, radius, k, cell_cap)
GRAPHS = {
    "ids": (800, 3, 3.0, None, False, 0.5, 32, 16),
    "k_binds": (900, 2, 2.0, None, False, 0.6, 4, 16),
    "cap_binds": (1200, 1, 2.0, None, False, 0.5, 16, 3),
    "grid_ties": (700, 2, 3.0, 0.25, False, 0.51, 6, 8),
    "key_overflow": (500, 2, 3.0, None, True, 0.5, 8, 8),
}


def _graph_inputs(name):
    n, ids, extent, grid, far, radius, k, cap = GRAPHS[name]
    return _cloud(sorted(GRAPHS).index(name), n, ids, extent, grid, far), dict(
        radius=radius, k=k, cell_cap=cap)


@pytest.mark.parametrize("include_self", [True, False])
@pytest.mark.parametrize("cap", [4, 32])
def test_radius_neighbors_matches_jax(include_self, cap):
    pts = _cloud(7, 700, 3, 2.5, grid=0.125)
    kw = dict(radius=0.4, k=6, cell_cap=cap, include_self=include_self)
    jidx, jd2 = jax.jit(lambda *a: jnb.radius_neighbors(*a, **kw))(*_j(*pts))
    idx, d2 = tnb.radius_neighbors(*_t(*pts), **kw)
    jidx, jd2 = np.asarray(jidx), np.asarray(jd2)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_allclose(d2.numpy(), jd2, rtol=1e-6, atol=0)
    # k binds on some rows (one column less where the own hit is taken out)
    assert (jidx >= 0).sum(axis=1).max() >= kw["k"] - 1
    own = jidx == np.arange(len(jidx))[:, None]
    assert own.any() == include_self


@pytest.mark.parametrize("name", list(GRAPHS))
def test_radius_graph_matches_jax(name):
    pts, kw = _graph_inputs(name)
    jf, jr, jt = jax.jit(lambda *a: jnb.radius_graph(*a, **kw))(*_j(*pts))
    f, r, t = tnb.radius_graph(*_t(*pts), **kw)
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    assert int(t) == int(jt)
    assert (f >= 0).sum() > len(pts[0])  # edges were found
    if name in ("k_binds", "grid_ties"):  # hubs overflow their k reverse slots
        assert int(t) > 0
    if name == "key_overflow":
        assert not (f[0] >= 0).any() and int(t) >= 1


@pytest.mark.parametrize("max_iters", [1, 64])
def test_grow_on_edges_matches_jax(max_iters):
    """Chains of points 0.3 apart make long components: one iteration does
    not converge them, 64 do."""
    n = 1500
    rng = np.random.default_rng(11)
    chain = rng.integers(0, 6, n)
    step = np.zeros((n, 3), np.float32)
    step[:, 0] = 0.3 * np.arange(n) / 6
    pos = (step + 5.0 * np.stack([chain, chain % 2, np.zeros(n)], 1)).astype(np.float32)
    ids = (chain % 2).astype(np.int32)
    grow = rng.random(n) > 0.05
    kw = dict(radius=0.55, k=8, cell_cap=8)
    jf, jr, _ = jax.jit(lambda *a: jnb.radius_graph(*a, **kw))(*_j(pos, ids, grow))
    args = (8, 5, max_iters)
    want = jax.jit(lambda f, r, b, g: jrg._grow_on_edges(f, r, b, g, *args))(
        jf, jr, jnp.asarray(ids), jnp.asarray(grow))
    edges = _t(np.array(jf), np.array(jr))
    got = trg._grow_on_edges(*edges, *_t(ids, grow), *args)
    for field in ("point_prop", "prop_valid", "prop_batch", "num_props"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    full = trg._grow_on_edges(*edges, *_t(ids, grow), 8, 5, 64)
    assert (int(got.num_props) == int(full.num_props)) == (max_iters == 64)


def _blobs(n, seed=3):
    """Separated blobs (dense inside), two samples, three classes."""
    rng = np.random.default_rng(seed)
    k = 5
    centers = 2.5 * np.stack([np.arange(k), np.arange(k) % 2, np.zeros(k)], axis=1)
    blob = rng.integers(0, k, n)
    pos = (centers[blob] + rng.normal(scale=0.12, size=(n, 3))).astype(np.float32)
    return (pos, rng.integers(1, 3, n).astype(np.int32), rng.integers(0, 2, n).astype(np.int32),
            rng.random(n) > 0.1)


@pytest.mark.parametrize("point_cap,dense_pull", [(0, True), (2048, False), (1000, True)])
def test_region_grow_folded_edges_match_jax(point_cap, dense_pull):
    n = 3000
    pts = _blobs(n)
    kw = dict(radius=0.3, max_proposals=64, num_classes=3, num_samples=2,
              min_cluster_size=5, point_cap=point_cap, k_neighbors=8, cell_cap=6,
              dense_pull=dense_pull)
    want = jax.jit(lambda *a: jrg.region_grow_folded(*a, **kw))(*_j(*pts))
    got = trg.region_grow_folded(*_t(*pts), **kw)
    for field in want._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    assert int(got.prop_valid.sum()) > 0
    assert int(got.graph_trunc) > 0  # k = 8 binds in the dense blobs
    assert (int(got.overflow) > 0) == (0 < point_cap < pts[3].sum())


def _proposals_inputs(n=4096, samples=2, classes=9, seed=5):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 12, size=(12, 3))
    blob = rng.integers(0, 12, n)
    pos = (centers[blob] + rng.normal(scale=0.3, size=(n, 3))).astype(np.float32)
    offsets = (0.05 * rng.normal(size=(n, 3))).astype(np.float32)
    embeds = (centers[blob][:, :1] / 3.0 + 0.1 * rng.normal(size=(n, 5))).astype(np.float32)
    logits = rng.normal(size=(n, classes))
    logits[np.arange(n), 1 + blob % 6] += 3.0  # thing classes of the blobs
    sem = (logits - np.log(np.exp(logits).sum(1, keepdims=True))).astype(np.float32)
    batch = np.sort(rng.integers(0, samples, n)).astype(np.int32)
    valid = rng.random(n) > 0.05
    return pos, offsets, embeds, sem, batch, valid


@pytest.mark.parametrize("family,cluster_type", [("3heads", 5), ("embed", 8)])
def test_build_proposals_on_edges_match_jax(family, cluster_type):
    kw = dict(num_classes=9, stuff_classes=(0, 7, 8), num_samples=2, model_family=family,
              cluster_type=cluster_type, max_props_rg=32, ms_max_seeds=16,
              ms_max_clusters=8, ms_point_cap=1024, cluster_radius=0.35, rg_point_cap=0,
              rg_dense="off", min_cluster_size=5)
    jcfg, tcfg = JConfig(**kw), PanopticConfig(**kw)
    assert not tcfg.rg_dense_enabled and tcfg.rg_k_neighbors == jcfg.rg_k_neighbors == 16
    inputs = _proposals_inputs()
    jp, jov, jtr = jax.jit(lambda *a: j_build_proposals(jcfg, *a))(*_j(*inputs))
    tp, tov, ttr = build_proposals(tcfg, *_t(*inputs))
    for field in jp._fields:
        np.testing.assert_array_equal(getattr(tp, field).numpy(),
                                      np.asarray(getattr(jp, field)), err_msg=field)
    assert int(tov) == int(jov) and int(ttr) == int(jtr)
    assert int(tp.prop_valid.sum()) > 0


def test_fold_bits_leave_the_graph_its_ids():
    """The folded id field holds every ``batch * C + class`` value."""
    for num_ids in (2, 9, 36, 72, 255):
        b = trg._fold_bits(num_ids)
        assert isinstance(b, BitLayout) and b == jrg._fold_bits(num_ids)
        assert b.max_batch > num_ids
