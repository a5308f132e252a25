"""The CPU's own paths of two port functions against the plain versions
they stand in for, bit for bit (``torch.equal``, and the float bits of the
distances):

* ``ops/conv.py:sparse_conv_rows``, the CPU forward of the sparse conv
  where no autograd graph is built (the GEMM of each offset's present rows
  alone), against ``sparse_conv_plain`` (zero pad row, a GEMM over every
  row per offset): sparse and dense maps, empty maps, bf16 operands and
  non-finite weights; and ``sparse_conv`` under autograd, whose gradients
  stay the plain version's;
* ``cluster/neighbors.py:_k_nearest_rows``, the CPU's k-nearest selection
  over the in-cell candidates alone, against the dense scan of every slot
  (``_k_nearest_dense``): ``radius_query``'s 27 cells, ``radius_graph``'s
  half stencil with its own-cell runs, lattice positions (tied distances),
  invalid rows, binding cell caps, and runs that reach the last sorted row.

Both CPU paths exist for the cost of the port's CPU parity tests; the card
runs neither."""

import numpy as np
import pytest
import torch

from panopticsegforlargescalepointcloud_tpu_torch.cluster import neighbors
from panopticsegforlargescalepointcloud_tpu_torch.ops import conv

torch.set_num_threads(2)

# (rows in, rows out, Cin, Cout, share of present map entries): the tiny
# plan's conv shapes, an empty and a dense map
CONV_SHAPES = [(4096, 4096, 8, 8, 0.05), (4096, 4096, 4, 8, 0.05), (3072, 4096, 32, 32, 0.03),
               (2560, 2560, 16, 16, 0.1), (1024, 1024, 32, 16, 0.2), (1536, 3072, 24, 24, 0.04),
               (512, 512, 8, 8, 0.0), (512, 700, 16, 8, 0.9)]


def _conv_operands(seed, n_in, n_out, cin, cout, density, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn(n_in, cin, generator=g).to(dtype)
    w = torch.randn(27, cin, cout, generator=g).to(dtype)
    idx = torch.randint(0, n_in, (n_out, 27), generator=g, dtype=torch.int32)
    idx[torch.rand(n_out, 27, generator=g) >= density] = -1
    return feats, idx, w


@pytest.mark.parametrize("shape", CONV_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_sparse_conv_rows_equals_plain(shape):
    for seed in range(3):
        feats, idx, w = _conv_operands(seed, *shape)
        want = conv.sparse_conv_plain(feats, idx, w)
        assert torch.equal(conv.sparse_conv_rows(feats, idx, w), want)
        assert torch.equal(conv.sparse_conv(feats, idx, w), want)


def test_sparse_conv_rows_bf16_and_non_finite_weights():
    feats, idx, w = _conv_operands(4, 2048, 2048, 16, 8, 0.08, torch.bfloat16)
    assert torch.equal(conv.sparse_conv_rows(feats, idx, w), conv.sparse_conv_plain(feats, idx, w))
    feats, idx, w = _conv_operands(5, 1024, 1024, 8, 8, 0.08)
    w[3, 2, 1] = float("inf")  # the pad row's products turn NaN in the plain version
    want = conv.sparse_conv_plain(feats, idx, w)
    assert torch.isnan(want).any()
    assert torch.equal(conv.sparse_conv_rows(feats, idx, w).isnan(), want.isnan())
    got = conv.sparse_conv_rows(feats, idx, w)
    keep = ~want.isnan()
    assert torch.equal(got[keep], want[keep])


def test_sparse_conv_under_autograd_is_the_plain_version():
    """Without a transpose map the CPU conv differentiates through the plain
    version's own ops: the same gradients, bit for bit."""
    feats, idx, w = _conv_operands(6, 1024, 1024, 8, 16, 0.06)
    g = torch.randn(1024, 16, generator=torch.Generator().manual_seed(7))
    grads = []
    for fn in (conv.sparse_conv, conv.sparse_conv_plain):
        x, wt = feats.clone().requires_grad_(), w.clone().requires_grad_()
        grads.append(torch.autograd.grad(fn(x, idx, wt), (x, wt), g))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def _cloud(seed, n, lattice, ids=3):
    g = torch.Generator().manual_seed(seed)
    pos = torch.rand(n, 3, generator=g) * (float(torch.rand(1, generator=g)) * 6 + 0.5)
    if lattice:  # many equal distances
        pos = torch.floor(pos * 4) / 4
    return (pos, torch.randint(0, ids, (n,), generator=g, dtype=torch.int32),
            torch.rand(n, generator=g) > 0.1, g)


def _same(a, b):
    return torch.equal(a[0], b[0]) and torch.equal(a[1].view(torch.int32), b[1].view(torch.int32))


@pytest.mark.parametrize("k,cap", [(4, 4), (16, 16), (32, 64), (64, 16)])
@pytest.mark.parametrize("lattice", [False, True])
def test_k_nearest_rows_equals_dense(k, cap, lattice):
    for seed in range(3):
        s_pos, s_ids, s_valid, g = _cloud(seed, 1500, lattice)
        nq = 1200
        q_pos = s_pos[torch.randint(0, 1500, (nq,), generator=g)] + 0.2 * (
            torch.rand(nq, 3, generator=g) - 0.5)
        q_ids = torch.randint(0, 3, (nq,), generator=g, dtype=torch.int32)
        q_valid = torch.rand(nq, generator=g) > 0.1
        radius = float(torch.rand(1, generator=g)) + 0.1
        for offsets in (neighbors._CELL_OFFSETS, neighbors._HALF_OFFSETS):
            q_keys, _, skeys, order, start = neighbors._cell_scan(
                q_pos, q_ids, q_valid, s_pos, s_ids, s_valid, radius,
                neighbors.DEFAULT_CELL_BITS, 256, offsets)
            args = (q_pos, s_pos[order], q_keys, skeys, order, start, radius, k, cap)
            want = neighbors._k_nearest_dense(*args)
            assert _same(neighbors._k_nearest_rows(*args), want)
            assert _same(neighbors._k_nearest(*args), want)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_radius_graph_and_neighbors_equal_on_both_paths(seed, monkeypatch):
    pos, ids, valid, g = _cloud(10 + seed, 2000, seed % 2 == 1, ids=2)
    radius = float(torch.rand(1, generator=g)) * 0.8 + 0.1
    k, cap = [(8, 2), (32, 16), (4, 64), (16, 8)][seed]
    got = (neighbors.radius_graph(pos, ids, valid, radius, k, cap),
           neighbors.radius_neighbors(pos, ids, valid, radius, k, cap, include_self=seed < 2))
    with monkeypatch.context() as mp:
        mp.setattr(neighbors, "_k_nearest", neighbors._k_nearest_dense)
        want = (neighbors.radius_graph(pos, ids, valid, radius, k, cap),
                neighbors.radius_neighbors(pos, ids, valid, radius, k, cap,
                                           include_self=seed < 2))
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    assert _same(got[1], want[1])
    assert int((got[1][0] >= 0).sum()) > 0 and np.isfinite(got[1][1].numpy()).any()
