"""Port parity of region growing: the dense min pull (the plain version the
CUDA kernel is held against) vs the JAX package's Pallas kernel in
interpret mode and ``min_pull_xla``; converged components and
``region_grow_folded`` (dense-pull branch, and the edge path where the
budget does not tile) exactly equal to the JAX package.

Points are grid-quantized so that no pair distance lies near the radius:
the matmul-form distance rounds differently from one formulation to the
next only at the boundary (see the JAX package's tests/test_dense_grow.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticsegforlargescalepointcloud_tpu.cluster import dense_grow as jdg
from panopticsegforlargescalepointcloud_tpu.cluster.region_grow import (
    region_grow_folded as j_region_grow,
)
from panopticsegforlargescalepointcloud_tpu_torch.cluster import dense_grow as tdg
from panopticsegforlargescalepointcloud_tpu_torch.cluster.region_grow import (
    region_grow_folded as t_region_grow,
)

torch.set_num_threads(2)

T = 2048
RADIUS = 0.51  # quantized coords (step 0.25): pair d2 = 0.0625 k, nearest k sits 0.0101 away


def points(rng, t=T, n_ids=4):
    pos = (0.25 * rng.integers(-16, 17, size=(t, 3))).astype(np.float32)
    ids = rng.integers(0, n_ids, t).astype(np.int32)
    valid = rng.random(t) > 0.08
    return pos, ids, valid


def test_min_pull_matches_pallas_and_xla(rng):
    pos, ids, valid = points(rng)
    labels = rng.permutation(T).astype(np.float32)
    r2 = RADIUS * RADIUS
    jq, js = jdg._operands(jnp.asarray(pos), jnp.asarray(valid))
    tq, ts = tdg._operands(torch.from_numpy(pos), torch.from_numpy(valid))
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    got = tdg.min_pull(tq, ts, torch.from_numpy(ids), torch.from_numpy(labels), r2).numpy()
    want_p = np.asarray(jdg.min_pull_pallas(jq, js, jnp.asarray(ids), jnp.asarray(labels), r2))
    want_x = np.asarray(jdg.min_pull_xla(jq, js, jnp.asarray(ids), jnp.asarray(labels), r2))
    np.testing.assert_array_equal(got, want_p)
    np.testing.assert_array_equal(got, want_x)
    assert np.all(np.isinf(got[~valid]))


def test_dense_components_match_jax(rng):
    pos, ids, valid = points(rng, n_ids=2)
    init = np.where(valid, np.arange(T), T).astype(np.int32)
    want = jax.jit(lambda p, i, v, s: jdg.dense_components(p, i, v, RADIUS, s))(
        jnp.asarray(pos), jnp.asarray(ids), jnp.asarray(valid), jnp.asarray(init))
    got = tdg.dense_components(torch.from_numpy(pos), torch.from_numpy(ids),
                               torch.from_numpy(valid), RADIUS, torch.from_numpy(init))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,point_cap", [(3000, 2048), (4096, 2048)])
def test_region_grow_folded_matches_jax(rng, n, point_cap):
    """Separated blobs (dense inside, >= 2 apart), two samples, three
    classes; at n = 4096 thing rows overflow the cap and are counted."""
    k = 5
    pos = np.zeros((n, 3), np.float32)
    centers = (2.5 * np.stack([np.arange(k), np.arange(k) % 2, np.zeros(k)], axis=1)
               ).astype(np.float32)
    blob = rng.integers(0, k, n)
    for i in range(k):
        m = blob == i
        pos[m] = centers[i] + rng.normal(scale=0.12, size=(m.sum(), 3))
    sem = rng.integers(1, 3, n).astype(np.int32)
    batch = rng.integers(0, 2, n).astype(np.int32)
    grow = rng.random(n) > 0.1
    kw = dict(radius=0.5, max_proposals=64, num_classes=3, num_samples=2,
              min_cluster_size=5, point_cap=point_cap)
    want = jax.jit(lambda *a: j_region_grow(*a, **kw, dense_pull=True))(
        jnp.asarray(pos), jnp.asarray(sem), jnp.asarray(batch), jnp.asarray(grow))
    got = t_region_grow(torch.from_numpy(pos), torch.from_numpy(sem),
                        torch.from_numpy(batch), torch.from_numpy(grow), **kw)
    for name in ("point_prop", "prop_valid", "prop_batch", "num_props", "overflow"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert int(got.prop_valid.sum()) > 0


def test_region_grow_needs_a_dense_budget(rng):
    """The dense pull needs a budget that tiles (a multiple of 2048); at
    T = 1000 both packages take the edge path on the compacted rows
    instead, with its k-nearest graph (whose truncations are counted)."""
    n = 3000
    pos = (0.25 * rng.integers(-12, 13, size=(n, 3))).astype(np.float32)
    sem = rng.integers(1, 3, n).astype(np.int32)
    batch = rng.integers(0, 2, n).astype(np.int32)
    grow = rng.random(n) > 0.1
    kw = dict(radius=RADIUS, max_proposals=64, num_classes=3, num_samples=2,
              min_cluster_size=5, point_cap=1000, dense_pull=True)
    assert not tdg.supports_dense(1000)
    want = jax.jit(lambda *a: j_region_grow(*a, **kw))(
        jnp.asarray(pos), jnp.asarray(sem), jnp.asarray(batch), jnp.asarray(grow))
    got = t_region_grow(torch.from_numpy(pos), torch.from_numpy(sem),
                        torch.from_numpy(batch), torch.from_numpy(grow), **kw)
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert int(got.overflow) == int(grow.sum()) - 1000 and int(got.prop_valid.sum()) > 0
