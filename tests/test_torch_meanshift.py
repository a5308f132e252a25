"""Port parity of mean shift: the flat-kernel update (the plain version the
CUDA kernel is held against) vs the JAX package's Pallas kernel in interpret
mode and ``_shift_iter`` within atol = rtol = 1e-5; bin seeding, per-sample
packing and the batched mean shift exactly equal to the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticsegforlargescalepointcloud_tpu.cluster import meanshift as jms
from panopticsegforlargescalepointcloud_tpu.cluster.pallas_meanshift import (
    meanshift_update as j_update,
)
from panopticsegforlargescalepointcloud_tpu_torch.cluster import meanshift as tms
from torch_jax_cache import jax_compilation_cache  # noqa: F401 (autouse)

torch.set_num_threads(2)
BW = 0.6


def blobs(rng, b=2, np_=1024, e=5, k=6):
    centers = rng.normal(scale=2.0, size=(b, k, e))
    pick = rng.integers(0, k, (b, np_))
    x = np.take_along_axis(centers, pick[..., None], axis=1)
    x = (x + rng.normal(scale=0.25, size=(b, np_, e))).astype(np.float32)
    valid = rng.random((b, np_)) > 0.1
    return x, valid


def test_update_matches_pallas_and_shift_iter(rng):
    x, valid = blobs(rng)
    seeds = np.stack([x[i, rng.choice(1024, 16, replace=False)] for i in range(2)])
    seeds[:, 3] = 50.0  # no point in range: keeps its position, count 0
    got, gcnt = tms.meanshift_update(torch.from_numpy(seeds), torch.from_numpy(x),
                                     torch.from_numpy(valid), BW)
    for i in range(2):
        wp, wpc = j_update(jnp.asarray(seeds[i]), jnp.asarray(x[i]), jnp.asarray(valid[i]),
                           BW, point_tile=256, interpret=True)
        wx, wxc = jms._shift_iter(jnp.asarray(seeds[i]), None, jnp.asarray(x[i]),
                                  jnp.asarray(valid[i]), BW * BW)
        for want, wcnt in ((wp, wpc), (wx, wxc)):
            np.testing.assert_allclose(got[i].numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(gcnt[i].numpy(), np.asarray(wcnt))
    assert np.all(gcnt[:, 3].numpy() == 0)
    np.testing.assert_array_equal(got[:, 3].numpy(), seeds[:, 3])


def test_bin_seeds_exact(rng):
    x, valid = blobs(rng, np_=512)
    x[0, :40] = x[0, 40]  # a crowded bin and ties in occupancy
    for s in (16, 700):
        got, gv = tms._bin_seeds(torch.from_numpy(x), torch.from_numpy(valid), BW, s)
        for i in range(2):
            want, wv = jms._bin_seeds(jnp.asarray(x[i]), jnp.asarray(valid[i]), BW, s)
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
            np.testing.assert_array_equal(gv[i].numpy(), np.asarray(wv))


def test_pack_by_sample_exact(rng):
    n = 3000
    x = rng.normal(size=(n, 5)).astype(np.float32)
    batch = rng.integers(-1, 3, n).astype(np.int32)
    mask = (rng.random(n) > 0.3) & (batch >= 0)
    for cap in (256, 1024):
        want = jms.pack_by_sample(jnp.asarray(x), jnp.asarray(batch), jnp.asarray(mask), 3, cap)
        got = tms.pack_by_sample(torch.from_numpy(x), torch.from_numpy(batch),
                                 torch.from_numpy(mask), 3, cap)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("density", [0.05, 0.3, 0.9])
def test_dedup_keep_is_sequential_greedy(rng, density):
    """The device fixed-point dedup equals the JAX package's sequential loop
    (``dedup_body``), including long suppression chains."""
    b, s = 3, 48
    alive = rng.random((b, s)) > 0.2
    order = np.argsort(rng.random((b, s)), axis=1, kind="stable")
    near = rng.random((b, s, s)) < density
    near = near | near.transpose(0, 2, 1) | np.eye(s, dtype=bool)[None]
    want = np.zeros((b, s), bool)
    for bi in range(b):
        suppressed = np.zeros(s, bool)
        for i in order[bi]:
            want[bi, i] = alive[bi, i] and not suppressed[i]
            if want[bi, i]:
                suppressed |= near[bi, i]
    got = tms._dedup_keep(torch.from_numpy(alive), torch.from_numpy(order),
                          torch.from_numpy(near))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("max_seeds", [16, 64])
def test_mean_shift_matches_jax(rng, max_seeds):
    x, valid = blobs(rng, b=3, np_=1024)
    valid[2] = False  # an empty sample
    want = jms.mean_shift(jnp.asarray(x), jnp.asarray(valid), bandwidth=BW,
                          max_seeds=max_seeds)
    got = tms.mean_shift(torch.from_numpy(x), torch.from_numpy(valid), bandwidth=BW,
                         max_seeds=max_seeds)
    np.testing.assert_array_equal(got.num_clusters.numpy(), np.asarray(want.num_clusters))
    np.testing.assert_array_equal(got.center_valid.numpy(), np.asarray(want.center_valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(want.centers),
                               rtol=1e-5, atol=1e-5)
    assert int(got.num_clusters[0]) > 1 and int(got.num_clusters[2]) == 0
