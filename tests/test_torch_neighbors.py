"""The point backbones' radius query: the port's ``radius_query`` against
the JAX package's on the same numpy inputs. Cases: a self query and cross
sets, several ids, samples in far-apart frames, a ``cell_cap`` that binds,
K above 27 · cap (padding), and grid-quantised points whose distances tie
(the candidate scanned first must come first, as ``lax.top_k`` orders
them). ``idx`` must be identical and ``dist2`` within 1e-6 relative (f32
sums of three squares; on dyadic points both are exact). Also the cap's
diagnostic, ``cell_cap_truncated``, against a count in numpy."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticsegforlargescalepointcloud_tpu.cluster.neighbors import (
    radius_query as j_radius_query,
)
from panopticsegforlargescalepointcloud_tpu_torch.cluster.neighbors import (
    cell_cap_truncated,
    radius_query,
)
from torch_jax_cache import jax_compilation_cache  # noqa: F401 (autouse)

torch.set_num_threads(2)

_j_query = jax.jit(j_radius_query, static_argnames=("radius", "k", "cell_cap"))


def _cloud(rng, n, ids, extent, frames=0.0, grid=None):
    """n points in [0, extent)^3 per id, each id shifted by ``frames`` m
    along x; ``grid``: quantised to that step."""
    pos = rng.uniform(0, extent, size=(n, 3))
    b = rng.integers(0, ids, n).astype(np.int32)
    pos[:, 0] += b * frames
    if grid is not None:
        pos = np.round(pos / grid) * grid
    return pos.astype(np.float32), b, rng.random(n) > 0.1


# name: (query rows, support rows, ids, extent, frames, grid, radius, k, cap, self)
CASES = {
    "self": (600, None, 1, 3.0, 0.0, None, 0.5, 16, 16, True),
    "cross_ids": (300, 500, 3, 3.0, 0.0, None, 0.6, 16, 32, False),
    "far_frames": (300, 500, 4, 3.0, 400.0, None, 0.6, 16, 32, False),
    "cap_binds": (400, 2000, 2, 1.5, 0.0, None, 0.5, 16, 4, False),
    "k_past_candidates": (200, 400, 2, 2.0, 0.0, None, 0.5, 40, 1, False),
    "grid_ties": (500, None, 2, 3.0, 0.0, 0.25, 0.5, 12, 64, True),
    "grid_ties_cross": (300, 600, 2, 3.0, 0.0, 0.125, 0.375, 8, 16, False),
}


def _inputs(name):
    nq, ns, ids, extent, frames, grid, radius, k, cap, self_q = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    q = _cloud(rng, nq, ids, extent, frames, grid)
    s = q if self_q else _cloud(rng, ns, ids, extent, frames, grid)
    return q, s, dict(radius=radius, k=k, cell_cap=cap)


@pytest.mark.parametrize("name", list(CASES))
def test_radius_query_matches_jax(name):
    q, s, kw = _inputs(name)
    jidx, jd2 = _j_query(*(jnp.asarray(a) for a in q + s), **kw)
    idx, d2 = radius_query(*(torch.from_numpy(a) for a in q + s), **kw)
    jidx, jd2 = np.asarray(jidx), np.asarray(jd2)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_allclose(d2.numpy(), jd2, rtol=1e-6, atol=0)
    assert idx.dtype == torch.int32 and idx.shape == (len(q[0]), kw["k"])
    assert (jidx >= 0).sum() > len(q[0])  # the queries find neighbours
    if name == "k_past_candidates":  # 27 candidates at most: the rest is padding
        assert (idx[:, 27:] == -1).all() and torch.isinf(d2[:, 27:]).all()
    if name.startswith("grid"):  # ties are there to break
        finite = np.where(jidx >= 0, jd2, np.nan)
        assert np.any(finite[:, 1:] == finite[:, :-1])


def _truncated_numpy(q, s, radius, cap):
    """Valid query rows whose 27 scanned cells include one with more than
    ``cap`` same-id support rows (cells shifted per id as the query does)."""
    (qp, qb, qv), (sp, sb, sv) = q, s
    inv = np.float32(1.0 / radius)
    qc = np.floor(qp * inv).astype(np.int64)
    sc = np.floor(sp * inv).astype(np.int64)
    counts = {}
    for b, c, v in zip(sb, sc, sv):
        if v:
            counts[(b,) + tuple(c)] = counts.get((b,) + tuple(c), 0) + 1
    out = 0
    for b, c, v in zip(qb, qc, qv):
        if v and any(counts.get((b, c[0] + dx, c[1] + dy, c[2] + dz), 0) > cap
                     for dx, dy, dz in itertools.product((-1, 0, 1), repeat=3)):
            out += 1
    return out


@pytest.mark.parametrize("name", ["cap_binds", "cross_ids", "self"])
def test_cell_cap_truncated_counts_rows(name):
    q, s, kw = _inputs(name)
    got = int(cell_cap_truncated(*(torch.from_numpy(a) for a in q + s), radius=kw["radius"],
                                 cell_cap=kw["cell_cap"]))
    assert got == _truncated_numpy(q, s, kw["radius"], kw["cell_cap"])
    assert (got > 0) == (name == "cap_binds")
