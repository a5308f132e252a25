"""Kernel C's new function, the whole mean-shift loop in one call:
``meanshift_converge`` on the CPU (its plain version, the loop around
``shift_iter_plain`` that the CUDA kernel is held against) equals the JAX
package's loop of ``_mean_shift_single`` (converged seeds within 1e-5,
counts and per-seed iteration counts exact, per sample); seeds run apart
converge as they do together, the property the one-launch kernel rests on;
``max_iter`` 0 and 1 agree with ``shift_iter_plain``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticsegforlargescalepointcloud_tpu.cluster import meanshift as jms
from panopticsegforlargescalepointcloud_tpu_torch.cluster import meanshift as tms

torch.set_num_threads(2)
BW = 0.6


def blobs(rng, b=2, np_=1024, e=5, k=6):
    centers = rng.normal(scale=2.0, size=(b, k, e))
    pick = rng.integers(0, k, (b, np_))
    x = np.take_along_axis(centers, pick[..., None], axis=1)
    x = (x + rng.normal(scale=0.25, size=(b, np_, e))).astype(np.float32)
    valid = rng.random((b, np_)) > 0.1
    return x, valid


def jax_converge(x, valid, max_seeds, max_iter):
    """The loop of the JAX package's ``_mean_shift_single`` (its XLA form,
    ``_shift_iter``), with a per-seed count of the updates taken: (seeds,
    svalid, seeds after the loop, final counts, updates per seed)."""
    bw2 = BW * BW
    tol = 1e-3 * BW
    seeds0, svalid = jms._bin_seeds(jnp.asarray(x), jnp.asarray(valid), BW, max_seeds)

    def cond(st):
        _, frozen, it, _ = st
        return (it < max_iter) & jnp.any(svalid & ~frozen)

    def body(st):
        seeds, frozen, it, n = st
        new, _ = jms._shift_iter(seeds, frozen, jnp.asarray(x), jnp.asarray(valid), bw2)
        shift2 = jnp.sum((new - seeds) ** 2, axis=-1)
        live = ~frozen & svalid
        upd = jnp.where(live[:, None], new, seeds)
        return upd, frozen | (shift2 < tol * tol) | ~svalid, it + 1, n + live

    seeds, _, _, n = jax.lax.while_loop(
        cond, body, (seeds0, jnp.zeros(seeds0.shape[0], bool), jnp.int32(0),
                     jnp.zeros(seeds0.shape[0], jnp.int32)))
    _, cnt = jms._shift_iter(seeds, None, jnp.asarray(x), jnp.asarray(valid), bw2)
    return (np.asarray(seeds0), np.asarray(svalid), np.asarray(seeds), np.asarray(cnt),
            np.asarray(n))


@pytest.mark.parametrize("max_seeds", [32, 64])
def test_converge_matches_jax_loop(rng, max_seeds):
    """Converged seeds only: XLA's d2 (a matrix product) and the port's
    term-by-term sum round otherwise, so a point within ~1e-6 of a seed's
    bandwidth may count in one and not the other; a loop cut before the
    seeds settle would show that step, a converged seed does not."""
    max_iter = 100
    x, valid = blobs(rng, b=3)
    valid[2, 200:] = False  # a sparse sample
    seeds, svalid, cnts, iters = [], [], [], []
    for i in range(3):
        s0, sv, want, wcnt, wn = jax_converge(x[i], valid[i], max_seeds, max_iter)
        seeds.append(s0)
        svalid.append(sv)
        cnts.append((want, wcnt, wn))
    got, gcnt, gn = tms.meanshift_converge(
        torch.from_numpy(np.stack(seeds)), torch.from_numpy(np.stack(svalid)),
        torch.from_numpy(x), torch.from_numpy(valid), BW, max_iter)
    for i, (want, wcnt, wn) in enumerate(cnts):
        np.testing.assert_allclose(got[i].numpy(), want, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(gcnt[i].numpy(), wcnt)
        np.testing.assert_array_equal(gn[i].numpy(), wn)
    assert int(gn.max()) > 1


def test_mean_shift_matches_mean_shift_single_per_sample(rng):
    """The port's batched mean shift (through ``meanshift_converge``) gives
    each sample what the JAX package's ``_mean_shift_single`` gives it."""
    x, valid = blobs(rng, b=2)
    got = tms.mean_shift(torch.from_numpy(x), torch.from_numpy(valid), bandwidth=BW,
                         max_seeds=48)
    for i in range(2):
        labels, centers, cvalid, ncl = jms._mean_shift_single(
            jnp.asarray(x[i]), jnp.asarray(valid[i]), BW, 48, 100)
        assert int(got.num_clusters[i]) == int(ncl) > 1
        np.testing.assert_array_equal(got.center_valid[i].numpy(), np.asarray(cvalid))
        np.testing.assert_array_equal(got.labels[i].numpy(), np.asarray(labels))
        np.testing.assert_allclose(got.centers[i].numpy(), np.asarray(centers),
                                   rtol=1e-5, atol=1e-5)


def test_seed_subsets_converge_as_together(rng):
    """Each seed's trajectory depends on that seed alone: any split of the
    seeds gives the same seeds, counts and iteration counts, bit for bit."""
    x, valid = blobs(rng, b=2)
    seeds, svalid = tms._bin_seeds(torch.from_numpy(x), torch.from_numpy(valid), BW, 40)
    svalid[:, 5] = False  # an invalid seed never moves
    xt, vt = torch.from_numpy(x), torch.from_numpy(valid)
    whole = tms.meanshift_converge(seeds, svalid, xt, vt, BW, 100)
    for idx in (np.arange(0, 40, 2), np.arange(7, 19), rng.permutation(40)[:11]):
        part = tms.meanshift_converge(seeds[:, idx].contiguous(), svalid[:, idx].contiguous(),
                                      xt, vt, BW, 100)
        for a, b in zip(part, whole):
            assert torch.equal(a, b[:, idx])
    assert torch.equal(whole[0][:, 5], seeds[:, 5]) and int(whole[2][:, 5].max()) == 0


def test_max_iter_0_and_1_agree_with_shift_iter(rng):
    x, valid = blobs(rng, b=2, np_=512)
    xt, vt = torch.from_numpy(x), torch.from_numpy(valid)
    seeds, svalid = tms._bin_seeds(xt, vt, BW, 24)
    seeds[:, 3] = 50.0  # no point in range: count 0, keeps its place, freezes
    svalid[:, 3] = True
    svalid[1, 7] = False
    new, cnt = tms.shift_iter_plain(seeds, xt, vt, BW * BW)
    got, gcnt, gn = tms.meanshift_converge(seeds, svalid, xt, vt, BW, 0)
    assert torch.equal(got, seeds) and torch.equal(gcnt, cnt) and int(gn.abs().max()) == 0
    got, gcnt, gn = tms.meanshift_converge(seeds, svalid, xt, vt, BW, 1)
    moved = torch.where(svalid[..., None], new, seeds)
    assert torch.equal(got, moved)
    assert torch.equal(gcnt, tms.shift_iter_plain(moved, xt, vt, BW * BW)[1])
    assert torch.equal(gn, svalid.to(torch.int32))
    assert torch.equal(got[:, 3], seeds[:, 3]) and int(gcnt[:, 3].max()) == 0
    # a seed with no points freezes after its first update
    _, _, gn = tms.meanshift_converge(seeds, svalid, xt, vt, BW, 100)
    assert int(gn[:, 3].max()) == 1


def test_converge_takes_the_plain_version_on_cpu(rng):
    x, valid = blobs(rng, b=1, np_=256)
    xt, vt = torch.from_numpy(x), torch.from_numpy(valid)
    seeds, svalid = tms._bin_seeds(xt, vt, BW, 8)
    before = tms.KERNEL.launches
    got = tms.meanshift_converge(seeds, svalid, xt, vt, BW, 100)
    want = tms.meanshift_converge_plain(seeds, svalid, xt, vt, BW, 100)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tms.KERNEL.launches == before
    with pytest.raises(ValueError, match="max_iter"):
        tms.meanshift_converge(seeds, svalid, xt, vt, BW, -1)
