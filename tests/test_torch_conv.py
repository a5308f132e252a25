"""Port parity of the sparse-conv forward (the plain version that the CUDA
kernel is held against): ``sparse_conv`` of the port vs the JAX package's
``ops/conv.py:sparse_conv`` in f32, on real kernel maps of a hierarchy,
within atol = rtol = 1e-5 (f32 sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticsegforlargescalepointcloud_tpu.ops.conv import sparse_conv as j_conv
from panopticsegforlargescalepointcloud_tpu_torch.data import collate_tiles, synthetic_tile
from panopticsegforlargescalepointcloud_tpu_torch.ops.conv import sparse_conv
from panopticsegforlargescalepointcloud_tpu_torch.ops.hierarchy import build_hierarchy
from panopticsegforlargescalepointcloud_tpu_torch.ops.sparse import make_grid

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def hier():
    rng = np.random.default_rng(3)
    vb = collate_tiles([synthetic_tile(rng, n_instances=4, pts_per_instance=80)
                        for _ in range(2)], capacity=4096, num_tiles=2)
    grid, _ = make_grid(torch.from_numpy(vb.batch), torch.from_numpy(vb.coords),
                        torch.from_numpy(vb.mask))
    return build_hierarchy(grid, 2, device="cpu")


def _maps(h):
    return {
        "same0": (h.same_maps[0], h.grids[0].capacity),
        "down0": (h.down_maps[0], h.grids[0].capacity),
        "up0": (h.up_maps[0], h.grids[1].capacity),
        "same1": (h.same_maps[1], h.grids[1].capacity),
    }


@pytest.mark.parametrize(
    "map_name,cin,cout",
    [("same0", 4, 16), ("same0", 16, 16), ("down0", 16, 16), ("same1", 16, 32),
     ("up0", 64, 64), ("up0", 192, 80), ("same1", 7, 3)],
)
def test_sparse_conv_matches_jax(hier, map_name, cin, cout):
    nbr, n_in = _maps(hier)[map_name]
    rng = np.random.default_rng(cin * 1000 + cout)
    x = rng.normal(size=(n_in, cin)).astype(np.float32)
    w = (rng.normal(size=(27, cin, cout)) / np.sqrt(27 * cin)).astype(np.float32)
    got = sparse_conv(torch.from_numpy(x), nbr, torch.from_numpy(w))
    want = np.asarray(j_conv(jnp.asarray(x), jnp.asarray(nbr.numpy()), jnp.asarray(w)))
    assert got.dtype == torch.float32 and got.shape == (nbr.shape[0], cout)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # rows whose neighbors are all absent are exactly zero
    empty = (nbr < 0).all(dim=1)
    assert torch.all(got[empty] == 0)


def test_sparse_conv_bf16_accumulates_in_f32(hier):
    nbr, n_in = _maps(hier)["same0"]
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(n_in, 16)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.normal(size=(27, 16, 16)).astype(np.float32)).to(torch.bfloat16)
    got = sparse_conv(x, nbr, w)
    want = sparse_conv(x.float(), nbr, w.float())
    assert got.dtype == torch.float32
    # bf16 products are exact in f32: only the summation order may differ
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_sparse_conv_rejects_mismatched_weights(hier):
    nbr, n_in = _maps(hier)["same0"]
    with pytest.raises(ValueError):
        sparse_conv(torch.zeros((n_in, 4)), nbr, torch.zeros((27, 5, 8)))
