"""The port's HDBSCAN (``cluster/hdbscan.py``) against the JAX package's on
the same numpy inputs, batched over samples with padding rows.

* On a dyadic grid (coordinates k / 16), every squared distance is exact in
  f32 and its square root correctly rounded in both frameworks, so the
  spanning tree, its recorded edges and the labels must be equal exactly,
  for ``selection`` "eom" and "gap".
* On random f32 blobs the Gram-matrix distances round differently in XLA's
  and PyTorch's products, so a near tie may flip one tree edge: the two
  partitions must agree on >= 99% of the points (noise counted as a label).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticsegforlargescalepointcloud_tpu.cluster import hdbscan as jhd
from panopticsegforlargescalepointcloud_tpu_torch.cluster import hdbscan as thd

torch.set_num_threads(2)


def _grid_blobs(seed, b=3, n=160, d=5, k=5):
    rng = np.random.default_rng(seed)
    centers = rng.integers(-40, 40, size=(b, k, d))
    lab = rng.integers(0, k, size=(b, n))
    x = (centers[np.arange(b)[:, None], lab] + rng.integers(-6, 7, size=(b, n, d))) / 16.0
    valid = rng.random((b, n)) < 0.9
    valid[-1, n // 3:] = False  # a sample with a long padded tail
    return x.astype(np.float32), valid


def _float_blobs(seed, b=3, n=192, d=3):
    rng = np.random.default_rng(seed)
    xs = []
    for _ in range(b):
        centers = rng.uniform(-4, 4, size=(4, d))
        scale = rng.uniform(0.15, 0.35, size=4)  # variable density
        lab = rng.integers(0, 4, size=n)
        xs.append(centers[lab] + rng.normal(size=(n, d)) * scale[lab, None])
    valid = np.ones((b, n), bool)
    valid[0, -20:] = False
    return np.stack(xs).astype(np.float32), valid


def _agreement(a, b):
    """The smaller over both directions of the share of points whose label
    in the other partition is the one their label maps to most."""
    def one_way(x, y):
        pairs, counts = np.unique(np.stack([x, y]), axis=1, return_counts=True)
        best = {}
        for (lx, _), c in zip(pairs.T, counts):
            best[lx] = max(best.get(lx, 0), c)
        return sum(best.values()) / len(x)

    return min(one_way(a, b), one_way(b, a))


def _both(x, valid, **kw):
    j = jhd.hdbscan_labels(jnp.asarray(x), jnp.asarray(valid), **kw)
    t = thd.hdbscan_labels(torch.from_numpy(x), torch.from_numpy(valid), **kw)
    return (np.asarray(j.labels), np.asarray(j.num_clusters),
            t.labels.numpy(), t.num_clusters.numpy())


@pytest.mark.parametrize("selection", ["eom", "gap"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_labels_exact_on_dyadic_grid(seed, selection):
    x, valid = _grid_blobs(seed)
    jl, jn, tl, tn = _both(x, valid, min_cluster_size=10, selection=selection)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tn, jn)
    assert (tn >= 1).all() and tn.max() > 1
    assert (tl[~valid] == -1).all()


@pytest.mark.parametrize("seed", [0, 5])
def test_spanning_tree_exact_on_dyadic_grid(seed):
    """The Boruvka rounds alone: components, and every recorded edge."""
    x, valid = _grid_blobs(seed, b=2, n=96)
    n = x.shape[1]
    rounds = 8
    d = np.sqrt(np.maximum(((x[:, :, None, :] - x[:, None, :, :]) ** 2).sum(-1), 0))
    ok = valid[:, :, None] & valid[:, None, :] & ~np.eye(n, dtype=bool)[None]
    mr = np.where(ok, d, np.float32(3.4e38)).astype(np.float32)
    for i in range(2):
        jc, (jw, ju, jv) = jhd._boruvka(jnp.asarray(mr[i]), jnp.asarray(valid[i]), rounds)
        tc, (tw, tu, tv) = thd._boruvka(torch.from_numpy(mr[i:i + 1]),
                                        torch.from_numpy(valid[i:i + 1]), rounds)
        np.testing.assert_array_equal(tc[0].numpy(), np.asarray(jc))
        for j, t in ((jw, tw), (ju, tu), (jv, tv)):
            np.testing.assert_array_equal(t[0].numpy(), np.asarray(j))


@pytest.mark.parametrize("selection", ["eom", "gap"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_partition_agreement_on_random_blobs(seed, selection):
    x, valid = _float_blobs(seed)
    jl, jn, tl, tn = _both(x, valid, min_cluster_size=15, selection=selection)
    for i in range(x.shape[0]):
        v = valid[i]
        assert _agreement(jl[i][v], tl[i][v]) >= 0.99, (i, jn, tn)
    assert (tl[~valid] == -1).all()


def test_max_clusters_keeps_the_largest():
    x, valid = _grid_blobs(4)
    jl, jn, tl, tn = _both(x, valid, min_cluster_size=10, max_clusters=2)
    np.testing.assert_array_equal(tl, jl)
    assert (tn <= 2).all() and tl.max() <= 1


def test_samples_without_points():
    """A sample with no valid rows and one with fewer than min_samples."""
    x, valid = _grid_blobs(6, b=3, n=64)
    valid[0] = False
    valid[1] = False
    valid[1, :3] = True
    jl, jn, tl, tn = _both(x, valid, min_cluster_size=10)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tn, jn)
    assert tn[0] == 0 and tn[1] == 0 and (tl[:2] == -1).all()


def test_unknown_selection_raises():
    with pytest.raises(ValueError):
        thd.hdbscan_labels(torch.zeros(1, 4, 2), torch.ones(1, 4, dtype=torch.bool),
                           selection="leaf")
