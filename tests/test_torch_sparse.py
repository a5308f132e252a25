"""Port parity, exact: key packing, lookup, grids, downsampling, kernel maps
and hierarchies of the PyTorch port against the JAX package on the same
numpy inputs; segment reductions against jax.ops."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticsegforlargescalepointcloud_tpu.data import collate_tiles, synthetic_tile
from panopticsegforlargescalepointcloud_tpu.cluster import neighbors as jnb
from panopticsegforlargescalepointcloud_tpu.ops import hashing as jh
from panopticsegforlargescalepointcloud_tpu.ops import hierarchy as jhier
from panopticsegforlargescalepointcloud_tpu.ops import scatter as jsc
from panopticsegforlargescalepointcloud_tpu.ops import sparse as jsp
from panopticsegforlargescalepointcloud_tpu_torch.cluster import neighbors as tnb
from panopticsegforlargescalepointcloud_tpu_torch.ops import hashing as th
from panopticsegforlargescalepointcloud_tpu_torch.ops import hierarchy as thier
from panopticsegforlargescalepointcloud_tpu_torch.ops import scatter as tsc
from panopticsegforlargescalepointcloud_tpu_torch.ops import sparse as tsp
from torch_jax_cache import jax_compilation_cache  # noqa: F401 (autouse)

torch.set_num_threads(2)


def eq(j, t):
    a = np.asarray(j)
    a = a.astype(np.int64) if a.dtype == np.uint32 else a
    np.testing.assert_array_equal(a, t.numpy())


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(11)
    tiles = [synthetic_tile(rng, n_instances=4, pts_per_instance=80) for _ in range(2)]
    vb = collate_tiles(tiles, capacity=4096, num_tiles=2)
    # shuffle rows and duplicate a few voxels so dedup and ordering matter
    perm = rng.permutation(4096)
    coords, b, mask = vb.coords[perm], vb.batch[perm], vb.mask[perm]
    coords[:7] = coords[100:107]
    b[:7] = b[100:107]
    mask[:7] = mask[100:107]
    return coords, b, mask


def j_grid(coords, b, mask, **kw):
    return jsp.make_grid(jnp.asarray(b), jnp.asarray(coords), jnp.asarray(mask), **kw)


def t_grid(coords, b, mask, **kw):
    return tsp.make_grid(torch.from_numpy(b), torch.from_numpy(coords), torch.from_numpy(mask),
                         **kw)


def test_pack_coords_and_lookup(rng):
    b = rng.integers(-1, 17, 3000).astype(np.int32)
    c = rng.integers(-600, 600, (3000, 3)).astype(np.int32)
    inv = rng.random(3000) < 0.1
    bits = jh.BitLayout(10, 10, 8)
    jk = jh.pack_coords(jnp.asarray(b), jnp.asarray(c), bits, jnp.asarray(inv))
    tk = th.pack_coords(torch.from_numpy(b), torch.from_numpy(c), th.BitLayout(10, 10, 8),
                        torch.from_numpy(inv))
    eq(jk, tk)
    table = np.sort(np.asarray(jk).astype(np.int64))
    q = np.concatenate([table[::3], rng.integers(0, 2**32, 500)]).astype(np.int64)
    got = th.lookup(torch.from_numpy(table), torch.from_numpy(q))
    want = jh.lookup(jnp.asarray(table.astype(np.uint32)), jnp.asarray(q.astype(np.uint32)))
    eq(want, got)


def test_make_grid_and_capacity(batch):
    coords, b, mask = batch
    for cap in (None, 1536):
        jg, jinv = j_grid(coords, b, mask, capacity=cap)
        tg, tinv = t_grid(coords, b, mask, capacity=cap)
        for x, y in zip(jg, tg):
            eq(x, y)
        eq(jinv, tinv)


def test_downsample_slot_table_same_map(batch):
    coords, b, mask = batch
    jg, _ = j_grid(coords, b, mask)
    tg, _ = t_grid(coords, b, mask)
    jc, jp = jsp.downsample(jg, 2048)
    tc, tp = tsp.downsample(tg, 2048)
    for x, y in zip(jc, tc):
        eq(x, y)
    eq(jp, tp)
    eq(jsp.slot_table_from_parent(jg, jp, 2048), tsp.slot_table_from_parent(tg, tp, 2048))
    eq(jsp.same_level_map(jc), tsp.same_level_map(tc))


def test_derive_level_maps(batch):
    coords, b, mask = batch
    jg, _ = j_grid(coords, b, mask)
    tg, _ = t_grid(coords, b, mask)
    jc, jp = jsp.downsample(jg, 3072)
    tc, tp = tsp.downsample(tg, 3072)
    jst = jsp.slot_table_from_parent(jg, jp, 3072)
    tst = tsp.slot_table_from_parent(tg, tp, 3072)
    jmaps = jax.jit(lambda g, p, st, c: jsp.derive_level_maps(g, p, st, jsp.same_level_map(c)))(
        jg, jp, jst, jc)
    tmaps = tsp.derive_level_maps(tg, tp, tst, tsp.same_level_map(tc))
    for x, y in zip(jmaps, tmaps):
        eq(x, y)
    # the derived maps equal the port's lookup-built oracles
    same, down, up = tmaps
    assert torch.equal(same, tsp.same_level_map(tg))
    assert torch.equal(down, tsp.down_map_fine_side(tg, tc))
    assert torch.equal(up, tsp.up_map_from_down(down, tg.capacity))
    eq(jax.jit(jsp.down_map_fine_side)(jg, jc), tsp.down_map_fine_side(tg, tc))


@pytest.mark.parametrize("num_down,caps", [(2, None), (3, (4096, 512, 128, 64))])
def test_build_hierarchy(batch, num_down, caps):
    coords, b, mask = batch
    jg, _ = j_grid(coords, b, mask)
    tg, _ = t_grid(coords, b, mask)
    jh_ = jax.jit(lambda g: jhier.build_hierarchy(g, num_down, capacities=caps))(jg)
    th_ = thier.build_hierarchy(tg, num_down, capacities=caps, device="cpu")
    assert len(th_.grids) == num_down + 1
    for jgr, tgr in zip(jh_.grids, th_.grids):
        for x, y in zip(jgr, tgr):
            eq(x, y)
    for name_j, name_t in (("bricks", "same_maps"), ("down_maps", "down_maps"),
                           ("up_maps", "up_maps"), ("parents", "parents")):
        for x, y in zip(getattr(jh_, name_j), getattr(th_, name_t)):
            eq(x, y)
    eq(jh_.overflow, th_.overflow)
    assert th_.overflow.shape == (num_down + 1,)
    if caps is not None:
        assert int(th_.overflow.sum()) > 0  # the tight capacities drop voxels


def test_default_capacities():
    for n in (4096, 32768, 131072):
        assert thier.default_capacities(n, 6) == jhier.default_capacities(n, 6)


def test_segment_ops(rng):
    n, s = 500, 37
    seg = rng.integers(-2, s + 3, n).astype(np.int32)
    data = rng.normal(size=(n, 4)).astype(np.float32)
    idata = rng.integers(-1000, 1000, (n, 3)).astype(np.int32)
    jseg, tseg = jnp.asarray(seg), torch.from_numpy(seg)
    np.testing.assert_allclose(jsc.segment_sum(jnp.asarray(data), jseg, s),
                               tsc.segment_sum(torch.from_numpy(data), tseg, s).numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(jsc.segment_mean(jnp.asarray(data), jseg, s),
                               tsc.segment_mean(torch.from_numpy(data), tseg, s).numpy(),
                               rtol=1e-5, atol=1e-5)
    for fill in (None, 0):
        eq(jsc.segment_max(jnp.asarray(idata), jseg, s, fill=fill),
           tsc.segment_max(torch.from_numpy(idata), tseg, s, fill=fill))
        eq(jsc.segment_min(jnp.asarray(idata), jseg, s, fill=fill),
           tsc.segment_min(torch.from_numpy(idata), tseg, s, fill=fill))
        eq(jsc.segment_max(jnp.asarray(data), jseg, s, fill=fill),
           tsc.segment_max(torch.from_numpy(data), tseg, s, fill=fill))


def test_run_starts_and_cell_seeds(rng):
    table = np.sort(rng.integers(0, 5000, 800)).astype(np.int64)
    q = rng.integers(-10, 5100, 700).astype(np.int64)
    q = q.clip(0)
    eq(jnb.run_starts(jnp.asarray(table.astype(np.uint32)), jnp.asarray(q.astype(np.uint32))),
       tnb.run_starts(torch.from_numpy(table), torch.from_numpy(q)))
    pos = (0.05 * rng.integers(-60, 60, (2048, 3))).astype(np.float32)
    ids = rng.integers(0, 18, 2048).astype(np.int32)
    valid = rng.random(2048) > 0.1
    bits = jh.BitLayout(9, 9, 9)
    want = jnb.cell_seed_labels(jnp.asarray(pos), jnp.asarray(ids), jnp.asarray(valid), 0.3,
                                bits, num_ids=18)
    got = tnb.cell_seed_labels(torch.from_numpy(pos), torch.from_numpy(ids),
                               torch.from_numpy(valid), 0.3, th.BitLayout(9, 9, 9),
                               num_ids=18)
    eq(want, got)
