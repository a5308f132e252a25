"""Kernel B's pair tables: the pull over the candidate block pairs
(``min_pull_blocks_plain``, the plain version the CUDA kernel is held
against) equals the all-pairs spec ``min_pull_plain`` and the JAX package's
``min_pull_xla`` exactly on grid-quantized points, and the spec also on
points placed to test the skip's margin:
pairs at r (1 +- 1e-6) far from the origin, where the matmul-form d2 rounds
by ~1e-4 against r^2 = 0.0324; every same-id pair that qualifies lies in a
candidate block pair; region growing through the tables equals the JAX
package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from panopticsegforlargescalepointcloud_tpu.cluster import dense_grow as jdg
from panopticsegforlargescalepointcloud_tpu.cluster.region_grow import (
    region_grow_folded as j_region_grow,
)
from panopticsegforlargescalepointcloud_tpu_torch.cluster import dense_grow as tdg
from panopticsegforlargescalepointcloud_tpu_torch.cluster.region_grow import (
    region_grow_folded as t_region_grow,
)

torch.set_num_threads(2)

R = 0.18  # the flagship's cluster radius (1.5 x 0.12 m)


def _pulls(pos, ids, valid, labels, r):
    """(blocks plain, all-pairs plain, tables) of one pull."""
    q, s = tdg._operands(torch.from_numpy(pos), torch.from_numpy(valid))
    tid = torch.from_numpy(ids)
    lab = torch.from_numpy(labels)
    tab = tdg.pull_tables(q, s, tid, r * r)
    return (tdg.min_pull_blocks_plain(tab, lab).numpy(),
            tdg.min_pull_plain(q, s, tid, lab, r * r).numpy(), tab)


def _jax_pull(pos, ids, valid, labels, r):
    jq, js = jdg._operands(jnp.asarray(pos), jnp.asarray(valid))
    return np.asarray(jdg.min_pull_xla(jq, js, jnp.asarray(ids), jnp.asarray(labels), r * r))


@pytest.mark.parametrize("t", [2048, 4096])
def test_blocks_equal_spec_and_jax_on_grid_points(rng, t):
    """Grid-quantized points (step 0.25, radius 0.51: no pair near it)."""
    pos = (0.25 * rng.integers(-16, 17, size=(t, 3))).astype(np.float32)
    ids = rng.integers(0, 4, t).astype(np.int32)
    valid = rng.random(t) > 0.08
    labels = rng.permutation(t).astype(np.float32)
    got, spec, tab = _pulls(pos, ids, valid, labels, 0.51)
    np.testing.assert_array_equal(got, spec)
    np.testing.assert_array_equal(got, _jax_pull(pos, ids, valid, labels, 0.51))
    assert np.all(np.isinf(got[~valid]))
    assert int(tab.ncand.sum()) < (t // tdg.BR) ** 2  # some block pairs were skipped


@pytest.mark.parametrize("t", [2048, 4096])
def test_blocks_pull_among_negative_ids(rng, t):
    """Negative ids pull among themselves like any other id, as in the spec
    and the JAX package: a run of them is not mistaken for a run without
    valid rows, and their shared sort key changes only the order."""
    pos = (0.25 * rng.integers(-16, 17, size=(t, 3))).astype(np.float32)
    ids = rng.choice([-3, -2, -1, 1, 2], t).astype(np.int32)
    valid = rng.random(t) > 0.08
    labels = rng.permutation(t).astype(np.float32)
    got, spec, _ = _pulls(pos, ids, valid, labels, 0.51)
    np.testing.assert_array_equal(got, spec)
    np.testing.assert_array_equal(got, _jax_pull(pos, ids, valid, labels, 0.51))
    neg = valid & (ids < 0)
    assert np.isfinite(got[neg]).mean() > 0.5  # negative-id rows find neighbours


def _boundary_points(rng, t, kind):
    """Pairs (anchor, partner) at distance r (1 + d), d in {-1e-6, -3e-7, 0,
    3e-7, 1e-6}, the anchors in a 3 m cube (dense enough that many pairs
    cross the blocks of the order) centred 23 m from the origin, so |p| is
    19-27 m; 5% invalid rows. ``kind``: "pairs" (6 ids), "one_id" (all rows
    one id), "singletons" (a quarter of the rows carry an id of their
    own)."""
    half = t // 2
    centre = rng.normal(size=3)
    centre *= 23.0 / np.linalg.norm(centre)
    anchor = centre + rng.uniform(-1.5, 1.5, (half, 3))
    d = rng.normal(size=(half, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    scale = R * (1.0 + rng.choice([-1e-6, -3e-7, 0.0, 3e-7, 1e-6], half))
    partner = anchor + d * scale[:, None]
    pos = np.concatenate([anchor, partner]).astype(np.float32)
    if kind == "one_id":
        ids = np.zeros(t, np.int32)
    else:
        pid = rng.integers(0, 6, half)
        ids = np.concatenate([pid, pid]).astype(np.int32)
        if kind == "singletons":
            lone = rng.random(t) < 0.25
            ids[lone] = 100 + np.arange(int(lone.sum()))
    perm = rng.permutation(t)
    return pos[perm], ids[perm], rng.random(t) > 0.05


@pytest.mark.parametrize("t,kind", [(2048, "pairs"), (2048, "one_id"), (2048, "singletons"),
                                    (6144, "pairs"), (12288, "one_id")])
def test_blocks_exact_at_the_radius_far_from_the_origin(rng, t, kind):
    """Against the spec only: XLA's contraction (``min_pull_xla``) rounds d2
    otherwise than the port's term-by-term sum, so at these pairs it
    decides some of them the other way (146 of 2,048 rows at T = 2,048)."""
    pos, ids, valid = _boundary_points(rng, t, kind)
    labels = rng.permutation(t).astype(np.float32)
    got, spec, tab = _pulls(pos, ids, valid, labels, R)
    np.testing.assert_array_equal(got, spec)
    # the points test something: many rows find a neighbour, and many of
    # those neighbours sit in another block of the order
    found = np.isfinite(got) & (got != labels)
    assert found.mean() > 0.1
    where = np.empty(t, np.int64)
    where[tab.perm.numpy()] = np.arange(t) // tdg.BR
    nbr = got[found].astype(np.int64)
    src = np.nonzero(found)[0]
    other = where[np.argsort(labels)[nbr]] != where[src]
    assert other.sum() > 10


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), nblocks=st.integers(1, 4),
       offset=st.sampled_from([0.0, 8.0, 25.0]), n_ids=st.sampled_from([1, 2, 7]))
def test_every_qualifying_pair_is_a_candidate(seed, nblocks, offset, n_ids):
    """Every same-id pair whose d2, as the kernel's 5-term sum rounds it,
    is <= r^2 lies in a candidate block pair of the tables."""
    rng = np.random.default_rng(seed)
    t = nblocks * tdg.BR
    pos = (offset + rng.uniform(-1.0, 1.0, (t, 3)) * rng.choice([0.3, 1.0, 3.0])
           ).astype(np.float32)
    ids = rng.integers(0, n_ids, t).astype(np.int32)
    valid = rng.random(t) > 0.1
    q, s = tdg._operands(torch.from_numpy(pos), torch.from_numpy(valid))
    tab = tdg.pull_tables(q, s, torch.from_numpy(ids), R * R)
    qv, pv = tab.q, tab.p
    d2 = qv[:, 0:1] * pv[None, :, 0] + qv[:, 1:2] * pv[None, :, 1]
    d2 = ((d2 + qv[:, 2:3] * pv[None, :, 2]) + pv[None, :, 3]) + qv[:, 3:4]
    hit = (d2 <= R * R) & (tab.ids[:, None] == tab.ids[None, :])
    qb, sb = np.nonzero(hit.numpy())
    cand = np.zeros((nblocks, nblocks), bool)
    for b in range(nblocks):
        cand[b, tab.cand[b, : int(tab.ncand[b])].numpy()] = True
    assert cand[qb // tdg.BR, sb // tdg.BR].all()


def test_tables_order_and_lists(rng):
    """perm is a permutation with the invalid rows last; each list's
    candidates are ascending and hold the block itself where it has a valid
    row (the plain version lists the skipped blocks after them, ascending;
    the kernel writes only the candidates)."""
    t = 2048
    pos, ids, valid = _boundary_points(rng, t, "pairs")
    q, s = tdg._operands(torch.from_numpy(pos), torch.from_numpy(valid))
    tab = tdg.pull_tables(q, s, torch.from_numpy(ids), R * R)
    perm = tab.perm.numpy()
    np.testing.assert_array_equal(np.sort(perm), np.arange(t))
    nv = int(valid.sum())
    assert valid[perm[:nv]].all() and not valid[perm[nv:]].any()
    nb = t // tdg.BR
    for b in range(nb):
        n = int(tab.ncand[b])
        lst = tab.cand[b].numpy()
        assert np.all(np.diff(lst[:n]) > 0) and np.all(np.diff(lst[n:]) > 0)
        assert set(lst.tolist()) == set(range(nb))
        if valid[perm[b * tdg.BR:(b + 1) * tdg.BR]].any():
            assert b in lst[:n]


def test_region_grow_folded_through_the_tables_matches_jax(rng):
    """Streaks of points 0.15 apart on a 30 m plot, two samples, four
    classes: components that run across many blocks of the order."""
    n, k = 6000, 40
    start = rng.uniform(-15.0, 15.0, (k, 3)).astype(np.float32)
    step = rng.normal(size=(k, 3))
    step = 0.15 * step / np.linalg.norm(step, axis=1, keepdims=True)
    which = rng.integers(0, k, n)
    along = rng.integers(0, 60, n)
    pos = (start[which] + along[:, None] * step[which]
           + rng.normal(scale=0.01, size=(n, 3))).astype(np.float32)
    sem = (which % 4).astype(np.int32)
    batch = (which % 2).astype(np.int32)
    grow = rng.random(n) > 0.05
    kw = dict(radius=0.2, max_proposals=128, num_classes=4, num_samples=2,
              min_cluster_size=5, point_cap=4096)
    before = tdg.KERNEL.launches
    want = jax.jit(lambda *a: j_region_grow(*a, **kw, dense_pull=True))(
        jnp.asarray(pos), jnp.asarray(sem), jnp.asarray(batch), jnp.asarray(grow))
    got = t_region_grow(torch.from_numpy(pos), torch.from_numpy(sem),
                        torch.from_numpy(batch), torch.from_numpy(grow), **kw)
    for name in ("point_prop", "prop_valid", "prop_batch", "num_props", "overflow"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert int(got.prop_valid.sum()) > 10
    assert tdg.KERNEL.launches == before  # CPU tensors: the plain version


@settings(max_examples=300, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), axis=st.integers(0, 2),
       rel=st.floats(-3e-5, 3e-5), far=st.floats(16.0, 30.0))
def test_skip_test_keeps_pairs_at_the_radius(seed, axis, rel, far):
    """The candidate test on two one-row runs keeps every pair whose d2, as
    the kernel's 5-term sum rounds it, is <= r^2. The pair lies along an
    axis, r (1 + rel) apart, so the box distance is the pair's own: far
    from the origin d2 rounds by ~1e-4, and without the margin some pairs
    just beyond the radius that the sum counts in would be skipped."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=3)
    a = (far * a / np.linalg.norm(a)).astype(np.float32)
    b = a.copy()
    b[axis] = np.float32(a[axis] + R * (1.0 + rel))
    pos = np.stack([a, b])
    q, s = tdg._operands(torch.from_numpy(pos), torch.ones(2, dtype=torch.bool))
    d2 = (((q[0, 0] * s[0, 1] + q[1, 0] * s[1, 1]) + q[2, 0] * s[2, 1]) + s[3, 1]) + q[4, 0]
    if float(d2) > np.float32(R * R):
        return
    inf = float("inf")
    lo = torch.full((2 * tdg._SEGS, 3), inf)
    hi = torch.full((2 * tdg._SEGS, 3), -inf)
    idlo = torch.full((2 * tdg._SEGS,), 2**31 - 1, dtype=torch.int32)
    idhi = torch.full((2 * tdg._SEGS,), -2**31, dtype=torch.int32)
    nmax = torch.zeros(2 * tdg._SEGS)
    for blk in (0, 1):
        r = blk * tdg._SEGS
        lo[r] = hi[r] = torch.from_numpy(pos[blk])
        idlo[r] = idhi[r] = 0
        nmax[r] = s[3, blk]
    _, ncand = tdg._cands_plain(lo, hi, idlo, idhi, nmax, 2, R * R)
    assert ncand.tolist() == [2, 2]
