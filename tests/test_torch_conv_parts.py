"""Kernel E, the per-part probe of the sparse-conv kernel: the plain
version of each part (what the CUDA parts are held against on the card)
against its numpy definition on real kernel maps, exactly for ``index`` and
within 1e-5 (f32 sums in another order) elsewhere; the ``full`` part against
the JAX package's ``ops/conv.py:sparse_conv``; the wrapper's checks; the
probe's bound arithmetic."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticsegforlargescalepointcloud_tpu.ops.conv import sparse_conv as j_conv
from panopticsegforlargescalepointcloud_tpu_torch import bench_conv_parts
from panopticsegforlargescalepointcloud_tpu_torch.data import collate_tiles, synthetic_tile
from panopticsegforlargescalepointcloud_tpu_torch.ops import conv_parts
from panopticsegforlargescalepointcloud_tpu_torch.ops.hierarchy import build_hierarchy
from panopticsegforlargescalepointcloud_tpu_torch.ops.sparse import make_grid

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def hier():
    rng = np.random.default_rng(11)
    vb = collate_tiles([synthetic_tile(rng, n_instances=4, pts_per_instance=80)
                        for _ in range(2)], capacity=4096, num_tiles=2)
    grid, _ = make_grid(torch.from_numpy(vb.batch), torch.from_numpy(vb.coords),
                        torch.from_numpy(vb.mask))
    return build_hierarchy(grid, 2, device="cpu")


def _numpy_part(part, x, idx, w):
    """The definitions, row by row in float64."""
    n_in = x.shape[0]
    valid = (idx >= 0) & (idx < n_in)
    if part == "index":
        return valid.sum(1, keepdims=True).astype(np.float64)
    xz = np.concatenate([x, np.zeros((1, x.shape[1]))]).astype(np.float64)
    idx_z = np.where(valid, idx, n_in)
    if part == "gather":
        return xz[idx_z].sum(1)
    if part == "contig":
        return np.einsum("nk,nc,kcd->nd", valid.astype(np.float64), x.astype(np.float64), w)
    return np.einsum("nkc,kcd->nd", xz[idx_z], w.astype(np.float64))


def _operands(hier, level_map, cin, cout, seed):
    nbr, n_in = {"same0": (hier.same_maps[0], hier.grids[0].capacity),
                 "up0": (hier.up_maps[0], hier.grids[1].capacity)}[level_map]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_in, cin)).astype(np.float32)
    w = (rng.normal(size=(27, cin, cout)) / np.sqrt(27 * cin)).astype(np.float32)
    return nbr, x, w


# the probe's two shapes; contig reads row i for output row i, so it runs on
# the same-level map only
CASES = [(part, "same0", 16, 16) for part in conv_parts.PARTS] + [
    (part, "up0", 64, 64) for part in conv_parts.PARTS if part != "contig"]


@pytest.mark.parametrize("part,level_map,cin,cout", CASES)
def test_plain_part_matches_definition(hier, part, level_map, cin, cout):
    nbr, x, w = _operands(hier, level_map, cin, cout, seed=cin + len(part))
    got = conv_parts.sparse_conv_part_plain(part, torch.from_numpy(x), nbr, torch.from_numpy(w))
    want = _numpy_part(part, x, nbr.numpy(), w)
    assert got.dtype == torch.float32 and got.shape == want.shape
    if part == "index":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("level_map,cin,cout", [("same0", 16, 16), ("up0", 64, 64)])
def test_full_part_matches_jax_sparse_conv(hier, level_map, cin, cout):
    nbr, x, w = _operands(hier, level_map, cin, cout, seed=7)
    got = conv_parts.sparse_conv_part("full", torch.from_numpy(x), nbr, torch.from_numpy(w))
    want = np.asarray(j_conv(jnp.asarray(x), jnp.asarray(nbr.numpy()), jnp.asarray(w)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_index_part_counts_out_of_range_rows_as_absent():
    idx = torch.tensor([[0, -1, 5, 2], [9, 1, -1, -1]], dtype=torch.int32)
    x = torch.ones((6, 2))
    got = conv_parts.sparse_conv_part("index", x, idx, torch.ones((4, 2, 3)))
    assert got.tolist() == [[3.0], [1.0]]


def test_wrapper_on_cpu_is_plain_and_counts_no_launch(hier):
    nbr, x, w = _operands(hier, "same0", 16, 16, seed=1)
    before = conv_parts.KERNEL.launches
    for part in conv_parts.PARTS:
        a = conv_parts.sparse_conv_part(part, torch.from_numpy(x), nbr, torch.from_numpy(w))
        b = conv_parts.sparse_conv_part_plain(part, torch.from_numpy(x), nbr,
                                              torch.from_numpy(w))
        assert torch.equal(a, b)
    assert conv_parts.KERNEL.launches == before
    assert conv_parts.KERNEL.replaces == "scripts/bench_winkernel_parts.py:36"


def test_wrapper_rejects_what_the_kernel_does_not_take(hier):
    nbr, x, w = _operands(hier, "up0", 16, 16, seed=2)
    x, w = torch.from_numpy(x), torch.from_numpy(w)
    with pytest.raises(ValueError, match="same-level map"):
        conv_parts.sparse_conv_part("contig", x, nbr, w)
    with pytest.raises(ValueError, match="unknown part"):
        conv_parts.sparse_conv_part("dma", x, nbr, w)
    with pytest.raises(ValueError, match="Cin <= 192"):
        conv_parts.sparse_conv_part("gather", torch.zeros((x.shape[0], 200)), nbr,
                                    torch.zeros((27, 200, 4)))


def test_probe_shapes_and_bounds(hier):
    labels = [s[0] for s in bench_conv_parts.shapes(hier)]
    assert labels == ["L0 same 16->16", "L1->L0 up 64->64"]
    idx = torch.tensor([[0, -1], [1, 1]], dtype=torch.int32)
    b, by = bench_conv_parts.part_bound("index", 2, idx, 16, 16, torch.float32)
    assert by == "bytes" and b == pytest.approx((4 * 4 + 2 * 4) / 3.35e12 * 1e3)
    _, by = bench_conv_parts.part_bound("full", 2, idx, 16, 16, torch.bfloat16)
    assert by == "bytes"
