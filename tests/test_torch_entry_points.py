"""The JAX package's remaining public entry points in the port, against the
JAX functions on the same numpy inputs (integer outputs exact):

* ``unpack_coords``, ``SparseGrid.count`` and the K2/K1 offset tables;
* the direct-lookup stride-2 maps ``down_map`` and ``up_map``, the split
  derivations ``derive_same_map``/``derive_down_map`` (also equal to the
  fused ``derive_level_maps``), and ``build_hierarchy(map_mode="lookup")``
  (also equal to the derived hierarchy where no level overflows), on random
  multi-sample grids with negative coordinates;
* the unfolded ``region_grow`` against the JAX one and against the port's
  ``region_grow_folded`` on its edge path;
* ``DistributionNeighbour`` and ``neighbour_count_stats(meter=...)``;
* the UNets' ``output_nc`` and ``Proposals.num_props``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticsegforlargescalepointcloud_tpu.cluster import region_grow as j_region_grow
from panopticsegforlargescalepointcloud_tpu.models import plans as jplans
from panopticsegforlargescalepointcloud_tpu.models.unet import SparseEncoder as JEncoder
from panopticsegforlargescalepointcloud_tpu.models.unet import SparseUNet as JUNet
from panopticsegforlargescalepointcloud_tpu.ops import hashing as jhash
from panopticsegforlargescalepointcloud_tpu.ops import hierarchy as jhier
from panopticsegforlargescalepointcloud_tpu.ops import sparse as jsp
from panopticsegforlargescalepointcloud_tpu.utils import debugging as jdebug
from panopticsegforlargescalepointcloud_tpu_torch.cluster import (
    region_grow,
    region_grow_folded,
)
from panopticsegforlargescalepointcloud_tpu_torch.models import plans
from panopticsegforlargescalepointcloud_tpu_torch.models.pointgroup3heads import Proposals
from panopticsegforlargescalepointcloud_tpu_torch.models.unet import SparseEncoder, SparseUNet
from panopticsegforlargescalepointcloud_tpu_torch.ops import (
    KERNEL_OFFSETS_K3,
    build_hierarchy,
    derive_down_map,
    derive_level_maps,
    derive_same_map,
    down_map,
    downsample,
    make_grid,
    pack_coords,
    same_level_map,
    unpack_coords,
    up_map,
)
from panopticsegforlargescalepointcloud_tpu_torch.ops import sparse as tsp
from panopticsegforlargescalepointcloud_tpu_torch.ops.sparse import slot_table_from_parent
from panopticsegforlargescalepointcloud_tpu_torch.utils import debugging as tdebug

torch.set_num_threads(2)

# the JAX functions, jitted (one compile per shape instead of one per op)
J_MAKE_GRID = jax.jit(jsp.make_grid)
J_DOWNSAMPLE = jax.jit(jsp.downsample, static_argnums=1)
J_SLOTS = jax.jit(jsp.slot_table_from_parent, static_argnums=2)
J_SAME = jax.jit(jsp.same_level_map)
J_DOWN, J_UP = jax.jit(jsp.down_map), jax.jit(jsp.up_map)
J_DERIVE_SAME, J_DERIVE_DOWN = jax.jit(jsp.derive_same_map), jax.jit(jsp.derive_down_map)
J_HIERARCHY = jax.jit(jhier.build_hierarchy, static_argnums=(1, 2), static_argnames="map_mode")
J_REGION_GROW = jax.jit(j_region_grow, static_argnames=(
    "radius", "max_proposals", "min_cluster_size", "k_neighbors", "cell_cap"))


def random_rows(rng, n_valid, capacity, n_batch=2, span=40):
    """(batch, coords, mask) numpy rows: n_valid random voxels (duplicates
    and negative coordinates included), then padding."""
    coords = rng.integers(-span, span, size=(n_valid, 3)).astype(np.int32)
    batch = rng.integers(0, n_batch, size=(n_valid,)).astype(np.int32)
    pad = capacity - n_valid
    return (np.concatenate([batch, -np.ones((pad,), np.int32)]),
            np.concatenate([coords, np.zeros((pad, 3), np.int32)]),
            np.concatenate([np.ones((n_valid,), bool), np.zeros((pad,), bool)]))


def grids(rows):
    """(JAX grid, port grid) of the same rows."""
    b, c, m = rows
    jg, _ = J_MAKE_GRID(jnp.asarray(b), jnp.asarray(c), jnp.asarray(m))
    tg, _ = make_grid(torch.from_numpy(b), torch.from_numpy(c), torch.from_numpy(m))
    return jg, tg


def eq(got, want, msg=""):
    np.testing.assert_array_equal(np.asarray(got).astype(np.int64),
                                  np.asarray(want).astype(np.int64), err_msg=msg)


def assert_same_grid(tg, jg):
    for f in ("coords", "batch", "keys", "mask"):
        eq(getattr(tg, f), getattr(jg, f), f)


# ------------------------------------------------------------------ hashing


def test_unpack_coords_matches_jax():
    rng = np.random.default_rng(0)
    b, c, m = random_rows(rng, 400, 512, n_batch=5, span=100)
    tkeys = pack_coords(torch.from_numpy(b), torch.from_numpy(c),
                        extra_invalid=torch.from_numpy(~m))
    jkeys = jhash.pack_coords(jnp.asarray(b), jnp.asarray(c), extra_invalid=jnp.asarray(~m))
    eq(tkeys, jkeys)
    tb, tc = unpack_coords(tkeys)
    jb, jc = jhash.unpack_coords(jkeys)
    assert tb.dtype == tc.dtype == torch.int32
    eq(tb, jb)
    eq(tc, jc)
    eq(tb[:400], b[:400])
    eq(tc[:400], c[:400])


def test_offset_tables_and_count_match_jax():
    for name in ("KERNEL_OFFSETS_K1", "KERNEL_OFFSETS_K2", "KERNEL_OFFSETS_K3"):
        eq(getattr(tsp, name), getattr(jsp, name), name)
    jg, tg = grids(random_rows(np.random.default_rng(1), 300, 512))
    assert tg.count().dtype == torch.int32
    assert int(tg.count()) == int(jg.count())


# --------------------------------------------------------------------- maps


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_down_and_up_maps_match_jax(seed):
    rng = np.random.default_rng(seed)
    jfine, tfine = grids(random_rows(rng, 900, 1024))
    jcoarse, jparent = J_DOWNSAMPLE(jfine, 1024)
    tcoarse, tparent = downsample(tfine, 1024)
    assert_same_grid(tcoarse, jcoarse)
    eq(tparent, jparent)
    tdown, tup = down_map(tfine, tcoarse), up_map(tfine, tcoarse)
    eq(tdown, J_DOWN(jfine, jcoarse), "down")
    eq(tup, J_UP(jfine, jcoarse), "up")
    # the direct queries equal the fine-side lookup and its transpose
    eq(tdown, tsp.down_map_fine_side(tfine, tcoarse))
    eq(tup, tsp.up_map_from_down(tdown, tfine.capacity))
    assert int((tdown >= 0).sum()) > 0


@pytest.mark.parametrize("seed,coarse_cap", [(0, 1024), (3, 1024), (5, 256)])
def test_split_derivations_match_jax_and_fused(seed, coarse_cap):
    rng = np.random.default_rng(seed)
    jfine, tfine = grids(random_rows(rng, 900, 1024, span=20))
    jcoarse, jparent = J_DOWNSAMPLE(jfine, coarse_cap)
    tcoarse, tparent = downsample(tfine, coarse_cap)
    if coarse_cap < 1024:  # the overflow case: dropped parents give -1 rows
        assert int(((tparent < 0) & tfine.mask).sum()) > 0
    jslots = J_SLOTS(jfine, jparent, coarse_cap)
    tslots = slot_table_from_parent(tfine, tparent, coarse_cap)
    jcmap = J_SAME(jcoarse)
    tcmap = same_level_map(tcoarse)
    eq(tcmap, jcmap)
    same = derive_same_map(tfine, tparent, tslots, tcmap)
    down = derive_down_map(tcmap, tslots)
    eq(same, J_DERIVE_SAME(jfine, jparent, jslots, jcmap), "same")
    eq(down, J_DERIVE_DOWN(jcmap, jslots), "down")
    fused = derive_level_maps(tfine, tparent, tslots, tcmap)
    eq(fused[0], same, "fused same")
    eq(fused[1], down, "fused down")
    if coarse_cap == 1024:
        eq(same, same_level_map(tfine), "lookup same")


@pytest.mark.parametrize("caps", [(2048, 2048, 1536, 768), (2048, 1024, 256, 64)])
def test_lookup_hierarchy_matches_jax(caps):
    rng = np.random.default_rng(7)
    jg, tg = grids(random_rows(rng, 1500, 2048, span=25))
    j = J_HIERARCHY(jg, 3, caps, map_mode="lookup")
    t = build_hierarchy(tg, 3, capacities=caps, map_mode="lookup", device="cpu")
    assert t.num_levels == j.num_levels == 4
    eq(t.overflow, j.overflow, "overflow")
    for lv in range(4):
        assert_same_grid(t.grids[lv], j.grids[lv])
        eq(t.same_maps[lv], j.bricks[lv], f"same L{lv}")
    for lv in range(3):
        eq(t.parents[lv], j.parents[lv], f"parent L{lv}")
        eq(t.down_maps[lv], j.down_maps[lv], f"down L{lv}")
        eq(t.up_maps[lv], j.up_maps[lv], f"up L{lv}")
    if int(t.overflow.sum()) == 0:  # where nothing drops, derived == lookup
        d = build_hierarchy(tg, 3, capacities=caps, device="cpu")
        for a, b in zip(d.same_maps + d.down_maps + d.up_maps,
                        t.same_maps + t.down_maps + t.up_maps):
            eq(a, b)
    else:
        assert caps[-1] == 64


def test_unknown_map_mode_raises():
    b, c, m = random_rows(np.random.default_rng(0), 10, 16)
    tg, _ = make_grid(torch.from_numpy(b), torch.from_numpy(c), torch.from_numpy(m))
    with pytest.raises(ValueError, match="map_mode"):
        build_hierarchy(tg, 1, map_mode="brick", device="cpu")


# ----------------------------------------------------------- region growing


def scene(rng, n=400):
    pos = (rng.random((n, 3)) * 4).astype(np.float32)
    batch = rng.integers(0, 2, size=n).astype(np.int32)
    sem = rng.integers(0, 3, size=n).astype(np.int32)
    mask = np.ones(n, bool)
    mask[-30:] = False
    return pos, batch, sem, mask & (sem != 0)


@pytest.mark.parametrize("min_size", [1, 5])
def test_region_grow_matches_jax_and_folded(min_size):
    pos, batch, sem, grow = scene(np.random.default_rng(min_size))
    kw = dict(radius=0.6, max_proposals=300, min_cluster_size=min_size, k_neighbors=64,
              cell_cap=64)
    want = J_REGION_GROW(jnp.asarray(pos), jnp.asarray(sem), jnp.asarray(batch),
                         jnp.asarray(grow), **kw)
    t = [torch.from_numpy(a) for a in (pos, sem, batch, grow)]
    got = region_grow(*t, **kw)
    for f in got._fields:
        eq(getattr(got, f), getattr(want, f), f)
    assert int(got.graph_trunc) == 0 and int(got.num_props) > 0
    folded = region_grow_folded(*t, num_classes=3, num_samples=2, dense_pull=False, **kw)
    assert int(folded.graph_trunc) == 0
    for f in ("point_prop", "prop_valid", "prop_batch", "num_props"):
        eq(getattr(got, f), getattr(folded, f), f)


def test_region_grow_counts_truncation_like_jax():
    """A budget that binds: the same truncated graph and grouping as JAX."""
    pos, batch, sem, grow = scene(np.random.default_rng(11), n=400)
    kw = dict(radius=1.5, max_proposals=300, min_cluster_size=1, k_neighbors=8, cell_cap=8)
    want = J_REGION_GROW(jnp.asarray(pos), jnp.asarray(sem), jnp.asarray(batch),
                         jnp.asarray(grow), **kw)
    got = region_grow(*[torch.from_numpy(a) for a in (pos, sem, batch, grow)], **kw)
    assert int(got.graph_trunc) > 0
    for f in got._fields:
        eq(getattr(got, f), getattr(want, f), f)


# ------------------------------------------------------------------ meters


def test_distribution_neighbour_matches_jax():
    rng = np.random.default_rng(3)
    pos = np.concatenate([rng.normal(scale=0.05, size=(64, 3)),
                          np.arange(16)[:, None] * 100.0 * np.ones(3)]).astype(np.float32)
    batch = (np.arange(80) % 2).astype(np.int32)
    valid = rng.random(80) > 0.1
    assert tdebug.DEBUGGING_VARS == jdebug.DEBUGGING_VARS
    tm, jm = tdebug.DistributionNeighbour(1.0, bins=20), jdebug.DistributionNeighbour(1.0, bins=20)
    for v in (valid, ~valid):
        got = tdebug.neighbour_count_stats(pos, batch, v, 1.0, 40, meter=tm, device="cpu")
        want = jdebug.neighbour_count_stats(pos, batch, v, 1.0, 40, meter=jm)
        assert got == want
    assert tm.radius == jm.radius == 1.0
    np.testing.assert_array_equal(tm.histogram, jm.histogram)
    np.testing.assert_array_equal(tm.histogram_non_zero, jm.histogram_non_zero)
    assert tm.histogram.sum() == 80 and tm.histogram[-1] > 0  # clipped at the last bin
    tm.reset()
    jm.reset()
    np.testing.assert_array_equal(tm.histogram, jm.histogram)
    assert len(tm.histogram_non_zero) == len(jm.histogram_non_zero) == 0
    tm.add_valid_neighbours([0, 3, 3, 99])
    jm.add_valid_neighbours([0, 3, 3, 99])
    np.testing.assert_array_equal(tm.histogram_non_zero, jm.histogram_non_zero)


# ---------------------------------------------------------- small accessors


def test_output_channels_and_proposal_count():
    plan = plans.paper_backbone_plan(4, 16)
    assert SparseUNet(**plan).output_nc == JUNet(**jplans.paper_backbone_plan(4, 16)).output_nc
    assert SparseUNet(**plan).output_nc == 16
    enc = plans.scorer_encoder_plan(16)
    assert SparseEncoder(**enc, num_segments=4).output_nc == JEncoder(
        **jplans.scorer_encoder_plan(16), num_segments=4).output_nc == 16
    z = torch.zeros
    props = Proposals(z(10), z(10), z(10), z(6), z(6), z(6))
    assert props.num_props == 6 and props.budget == 10
