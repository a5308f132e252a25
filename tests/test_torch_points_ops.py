"""The point-op library: the port's ``ops/points.py`` against the JAX
package's on the same numpy inputs (masked and unmasked, k above the
reference count, fewer valid rows than samples). Indices identical,
values within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticsegforlargescalepointcloud_tpu.ops import points as jp
from panopticsegforlargescalepointcloud_tpu_torch.ops import points as tp

torch.set_num_threads(2)


def _data(seed, nq=60, nr=90, masked=True):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(nq, 3)).astype(np.float32)
    r = rng.normal(size=(nr, 3)).astype(np.float32)
    qv = rng.random(nq) > 0.2 if masked else None
    rv = rng.random(nr) > 0.2 if masked else None
    feats = rng.normal(size=(nr, 5)).astype(np.float32)
    return q, r, qv, rv, feats


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _close(got, want):
    got, want = got.numpy(), np.asarray(want)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_pairwise_dist2(masked):
    q, r, qv, rv, _ = _data(0, masked=masked)
    _close(tp.pairwise_dist2(_t(q), _t(r), _t(qv), _t(rv)),
           jp.pairwise_dist2(_j(q), _j(r), _j(qv), _j(rv)))


@pytest.mark.parametrize("k,masked", [(8, False), (8, True), (120, True)])
def test_knn(k, masked):
    q, r, qv, rv, _ = _data(1, masked=masked)
    idx, d2 = tp.knn(_t(q), _t(r), k, _t(qv), _t(rv))
    jidx, jd2 = jax.jit(jp.knn, static_argnums=2)(_j(q), _j(r), k, _j(qv), _j(rv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(d2, jd2)


@pytest.mark.parametrize("radius", [0.5, 1.2])
def test_ball_query(radius):
    q, r, qv, rv, _ = _data(2)
    idx, d2 = tp.ball_query(_t(q), _t(r), radius, 16, _t(qv), _t(rv))
    jidx, jd2 = jp.ball_query(_j(q), _j(r), radius, 16, _j(qv), _j(rv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(d2, jd2)
    assert (idx >= 0).any() and (idx < 0).any()


@pytest.mark.parametrize("n,samples,frac", [(200, 32, None), (200, 40, 0.7), (50, 40, 0.3)])
def test_farthest_point_sample(n, samples, frac):
    rng = np.random.default_rng(3)
    pos = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    valid = None if frac is None else rng.random(n) < frac
    got = tp.farthest_point_sample(_t(pos), samples, _t(valid))
    want = jax.jit(jp.farthest_point_sample, static_argnums=1)(_j(pos), samples, _j(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k,masked", [(3, False), (3, True), (5, True)])
def test_knn_interpolate(k, masked):
    q, r, qv, rv, feats = _data(4, masked=masked)
    got = tp.knn_interpolate(_t(feats), _t(r), _t(q), k, _t(rv), _t(qv))
    want = jp.knn_interpolate(_j(feats), _j(r), _j(q), k, _j(rv), _j(qv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
