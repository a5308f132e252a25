"""The sparse conv's backward in the port: ``sparse_conv(..., idx_t)`` is an
autograd Function whose dX is the conv on the transpose map and whose dW is
the per-offset ``fk^T @ g`` (the plain versions of kernels A and D, which
the CPU takes).

* Against ``jax.vjp`` of the JAX package's ``sparse_conv(..., nbr_idx_t=)``
  (its ``_conv_tm`` custom VJP) for same, down and up pairs of a real
  hierarchy: f32, rtol = 1e-5 and atol = 1e-5 of the tensor's max |value|
  (f32 sums in another order; a dW entry sums thousands of rows, so an
  entry that cancels to near 0 keeps the rounding of the large terms).
* Against torch autograd of the plain gather conv without a transpose map
  (whose gather VJP is a scatter-add). This holds the
  transpose identity independently of the JAX package. The same tolerance.
* The identity ``idx_t[j, K-1-k] = i  <=>  idx[i, k] = j`` itself, exactly,
  on every same map and down/up pair of ``build_hierarchy`` (with padding
  rows) and of the ScoreNet's hierarchy. Where a level overflows its
  capacity, the maps are the JAX package's, which break the identity for
  the down/up pair below the overflowing level: the up map misses the
  entries of coarse voxels that lost their own parent (the derived maps
  reach them through the coarse same map, whose row is empty for them).
  The case pins that behaviour."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticsegforlargescalepointcloud_tpu.ops.conv import sparse_conv as j_conv
from panopticsegforlargescalepointcloud_tpu_torch.data import collate_tiles, synthetic_tile
from panopticsegforlargescalepointcloud_tpu_torch.models import PanopticConfig, Proposals
from panopticsegforlargescalepointcloud_tpu_torch.models.pointgroup3heads import scorer_inputs
from panopticsegforlargescalepointcloud_tpu_torch.ops.conv import (
    sparse_conv,
    sparse_conv_dw,
    sparse_conv_dw_plain,
    sparse_conv_plain,
)
from panopticsegforlargescalepointcloud_tpu_torch.ops.hierarchy import build_hierarchy
from panopticsegforlargescalepointcloud_tpu_torch.ops.sparse import make_grid

torch.set_num_threads(2)


def _batch(seed=3):
    rng = np.random.default_rng(seed)
    return collate_tiles([synthetic_tile(rng, n_instances=4, pts_per_instance=80)
                          for _ in range(2)], capacity=4096, num_tiles=2)


@pytest.fixture(scope="module")
def vb():
    return _batch()


@pytest.fixture(scope="module")
def grid(vb):
    g, _ = make_grid(torch.from_numpy(vb.batch), torch.from_numpy(vb.coords),
                     torch.from_numpy(vb.mask))
    return g


@pytest.fixture(scope="module")
def hier(grid):
    return build_hierarchy(grid, 2, device="cpu")


def _pair(h, name):
    """(idx, idx_t, n_in) of a conv and its transpose partner."""
    return {
        "same0": (h.same_maps[0], h.same_maps[0], h.grids[0].capacity),
        "down0": (h.down_maps[0], h.up_maps[0], h.grids[0].capacity),
        "up0": (h.up_maps[0], h.down_maps[0], h.grids[1].capacity),
        "same1": (h.same_maps[1], h.same_maps[1], h.grids[1].capacity),
    }[name]


def _operands(idx, n_in, cin, cout, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_in, cin)).astype(np.float32)
    w = (rng.normal(size=(27, cin, cout)) / np.sqrt(27 * cin)).astype(np.float32)
    g = rng.normal(size=(idx.shape[0], cout)).astype(np.float32)
    return x, w, g


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(1.0, float(np.abs(want).max())))


def _port_grads(x, w, g, idx, idx_t):
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = sparse_conv(xt, idx, wt, idx_t)
    dx, dw = torch.autograd.grad(out, (xt, wt), torch.from_numpy(g))
    return out.detach().numpy(), dx.numpy(), dw.numpy()


CASES = [("same0", 4, 16), ("same0", 16, 16), ("down0", 16, 16), ("up0", 32, 16),
         ("same1", 16, 32), ("same1", 7, 3)]


@pytest.mark.parametrize("pair,cin,cout", CASES)
def test_function_matches_jax_vjp(hier, pair, cin, cout):
    idx, idx_t, n_in = _pair(hier, pair)
    x, w, g = _operands(idx, n_in, cin, cout, seed=cin * 100 + cout)
    out, dx, dw = _port_grads(x, w, g, idx, idx_t)
    jout, vjp = jax.vjp(
        lambda a, b: j_conv(a, jnp.asarray(idx.numpy()), b, nbr_idx_t=jnp.asarray(idx_t.numpy())),
        jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    _close(out, jout)
    _close(dx, jdx)
    _close(dw, jdw)


@pytest.mark.parametrize("pair,cin,cout", CASES)
def test_function_matches_scatter_add_autograd(hier, pair, cin, cout):
    idx, idx_t, n_in = _pair(hier, pair)
    x, w, g = _operands(idx, n_in, cin, cout, seed=cin * 7 + cout)
    _, dx, dw = _port_grads(x, w, g, idx, idx_t)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    want = torch.autograd.grad(sparse_conv_plain(xt, idx, wt), (xt, wt), torch.from_numpy(g))
    _close(dx, want[0].numpy())
    _close(dw, want[1].numpy())


def test_dx_is_skipped_for_inputs_without_grad(hier):
    idx, idx_t, n_in = _pair(hier, "same0")
    x, w, g = _operands(idx, n_in, 4, 8, seed=0)
    wt = torch.from_numpy(w).requires_grad_()
    out = sparse_conv(torch.from_numpy(x), idx, wt, idx_t)
    (dw,) = torch.autograd.grad(out, (wt,), torch.from_numpy(g))
    _close(dw.numpy(), sparse_conv_dw_plain(torch.from_numpy(x), idx, torch.from_numpy(g)))


def test_dw_wrapper_and_bf16(hier):
    """The dW wrapper takes the plain version on the CPU; bf16 operands give
    f32 sums of exact products, so they match the f32 version of the same
    (rounded) values."""
    idx, _, n_in = _pair(hier, "down0")
    x, _, _ = _operands(idx, n_in, 16, 8, seed=1)
    g = np.random.default_rng(2).normal(size=(idx.shape[0], 8)).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16()
    gb = torch.from_numpy(g).bfloat16()
    got = sparse_conv_dw(xb, idx, gb)
    assert got.dtype == torch.float32 and got.shape == (27, 16, 8)
    want = sparse_conv_dw_plain(xb.float(), idx, gb.float())
    _close(got.numpy(), want.numpy())


def test_transpose_map_shape_is_checked(hier):
    idx, _, n_in = _pair(hier, "down0")
    with pytest.raises(ValueError):
        sparse_conv(torch.zeros((n_in, 4)), idx, torch.zeros((27, 4, 4)), idx)


def _transpose_of(idx: np.ndarray, n_in: int) -> np.ndarray:
    k = idx.shape[1]
    rows, cols = np.nonzero(idx >= 0)
    j = idx[rows, cols]
    flat = j * k + (k - 1 - cols)
    assert np.unique(flat).size == flat.size, "two entries claim one transpose slot"
    t = np.full((n_in * k,), -1, np.int64)
    t[flat] = rows
    return t.reshape(n_in, k)


def _assert_transposes(idx, idx_t):
    a, b = idx.numpy(), idx_t.numpy()
    np.testing.assert_array_equal(_transpose_of(a, b.shape[0]), b)
    np.testing.assert_array_equal(_transpose_of(b, a.shape[0]), a)


def _assert_hierarchy(h):
    """Every same map is its own transpose; a down/up pair is exact unless
    the level above its coarse side overflowed, and then the up map only
    lacks entries of the down map's transpose."""
    for s in h.same_maps:
        _assert_transposes(s, s)
    for level, (d, u) in enumerate(zip(h.down_maps, h.up_maps)):
        if int(h.overflow[level + 1]) == 0:
            _assert_transposes(d, u)
        else:
            t, un = _transpose_of(d.numpy(), u.shape[0]), u.numpy()
            assert np.all((un == t) | (un == -1)) and np.any(un != t)


@pytest.mark.parametrize("capacities", [None, (4096, 768, 256)], ids=["default", "overflowing"])
def test_transpose_identity_on_hierarchy(grid, capacities):
    h = build_hierarchy(grid, 2, capacities=capacities, device="cpu")
    assert int(h.grids[0].mask.sum()) < h.grids[0].capacity  # padding rows present
    assert (int(h.overflow[1]) > 0) == (capacities is not None)
    _assert_hierarchy(h)


def test_transpose_identity_on_scorer_hierarchy(vb, grid):
    """The ScoreNet's hierarchy, built from per-instance proposals (the
    proposal id in the batch field, coords centered per proposal)."""
    cfg = PanopticConfig(num_classes=9, stuff_classes=(0, 7, 8), backbone="tiny", in_feat=8,
                         num_samples=2, max_props_rg=32, ms_max_clusters=16,
                         scorer_capacity_mult=0.375)
    n = grid.capacity
    _, inverse = make_grid(torch.from_numpy(vb.batch), torch.from_numpy(vb.coords),
                           torch.from_numpy(vb.mask))
    ok = inverse.numpy() >= 0
    inst = np.zeros(n, np.int64)
    inst[inverse.numpy()[ok]] = vb.instance_labels[ok]
    key = np.where(inst > 0, grid.batch.numpy() * 1000 + inst, -1)
    uniq = np.unique(key[key >= 0])
    assert 2 <= uniq.size <= cfg.total_props
    pid = np.where(key >= 0, np.searchsorted(uniq, key), -1).astype(np.int32)
    props = Proposals(
        point_idx=torch.from_numpy(np.where(pid >= 0, np.arange(n), -1).astype(np.int32)),
        prop_id=torch.from_numpy(pid),
        member_valid=torch.from_numpy(pid >= 0),
        prop_valid=torch.arange(cfg.total_props) < uniq.size,
        prop_batch=torch.full((cfg.total_props,), -1, dtype=torch.int32),
        prop_type=torch.zeros(cfg.total_props, dtype=torch.int32))
    sg, shier, _, _, overflow = scorer_inputs(cfg, props, grid.coords,
                                              torch.zeros((n, cfg.in_feat)))
    assert int(overflow) == 0
    assert 0 < int(sg.mask.sum()) < sg.capacity
    _assert_hierarchy(shier)
