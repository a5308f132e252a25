"""The grid hierarchy's constant tables kept per device (``ops/sparse.py:
constant``), and the parts of its CUDA graph (``ops/hierarchy.py``) that run
without a card: the engagement rule (a CUDA grid, the derived maps, no
capture under way) and its eager cases; the graph's cache key; the flat
buffers the graph's outputs land in and the copies a replay hands out; a
second build on one device uploads no table; the derived maps against the
lookup oracle. Tiny grids of a few thousand rows."""

import types

import numpy as np
import pytest
import torch

from panopticsegforlargescalepointcloud_tpu_torch.ops import hierarchy, sparse
from panopticsegforlargescalepointcloud_tpu_torch.ops.hashing import DEFAULT_BITS, BitLayout
from panopticsegforlargescalepointcloud_tpu_torch.ops.hierarchy import (
    build_hierarchy,
    build_hierarchy_eager,
    default_capacities,
)
from panopticsegforlargescalepointcloud_tpu_torch.ops.sparse import make_grid
from panopticsegforlargescalepointcloud_tpu_torch.utils import trace

torch.set_num_threads(2)

CAPACITY = 4096
NUM_DOWN = 3

# every numpy table ops/sparse.py uploads, as its callers hand them over
TABLES = {
    "same_offsets": sparse.KERNEL_OFFSETS_K3[:13],
    "offsets_k3": sparse.KERNEL_OFFSETS_K3,
    "offsets_k2": sparse.KERNEL_OFFSETS_K2,
    "down_choice": sparse._DOWN_CHOICE,
    "box_koff8": sparse._BOX_KOFF8,
    "box_col64": sparse._BOX_COL64,
    "box_dcol64": sparse._BOX_DCOL64,
    "up_koff": sparse._UP_KOFF,
    "up_valid": sparse._UP_VALID,
    "same_koff": sparse._SAME_KOFF,
    "same_slot": sparse._SAME_SLOT,
    "down_koff": sparse._DOWN_KOFF,
    "down_slot": sparse._DOWN_SLOT,
}


def _grid(seed, n=3000, span=12, samples=2):
    rng = np.random.default_rng(seed)
    coords = rng.integers(-span, span, (n, 3)).astype(np.int32)
    batch = rng.integers(0, samples, n).astype(np.int32)
    mask = rng.random(n) < 0.9
    grid, _ = make_grid(torch.from_numpy(batch), torch.from_numpy(coords),
                        torch.from_numpy(mask), capacity=CAPACITY)
    return grid


def _fake_cuda_grid():
    keys = types.SimpleNamespace(device=torch.device("cuda", 0))
    return sparse.SparseGrid(None, None, keys, None)


def _equal(a, b):
    ta, tb = hierarchy.hierarchy_tensors(a), hierarchy.hierarchy_tensors(b)
    return (len(ta) == len(tb)
            and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(ta, tb)))


def test_engagement_is_off_on_the_cpu_and_for_lookup(monkeypatch):
    assert not hierarchy.graph_engaged(_grid(0), "derived")
    assert not hierarchy.graph_engaged(_grid(0), "lookup")
    cuda = _fake_cuda_grid()
    assert not hierarchy.graph_engaged(cuda, "lookup")
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    assert hierarchy.graph_engaged(cuda, "derived")
    # a build inside another capture stays eager
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    assert not hierarchy.graph_engaged(cuda, "derived")


def test_a_cpu_build_is_the_eager_build_and_records_no_graph():
    grid = _grid(1)
    caps = default_capacities(CAPACITY, NUM_DOWN)
    cached = len(hierarchy._GRAPHS)
    with trace.span("unit", on=True):
        got = build_hierarchy(grid, NUM_DOWN, device="cpu")
    recs = trace.drain()
    assert not any(r.name == "hierarchy_graph" for r in recs)
    assert not any("hier_graph_replays" in (r.counts or {}) for r in recs)
    assert len(hierarchy._GRAPHS) == cached
    assert all(a is b for a, b in zip(got.grids[0], grid))
    assert _equal(got, build_hierarchy_eager(grid, NUM_DOWN, caps))


@pytest.mark.parametrize("change", ["capacities", "num_down", "bits", "map_mode", "rows",
                                    "dtype"])
def test_cache_key_separates_signatures(change):
    grid = _grid(2)
    args = dict(num_down=NUM_DOWN, capacities=default_capacities(CAPACITY, NUM_DOWN),
                bits=DEFAULT_BITS, map_mode="derived")
    base = hierarchy.graph_key(grid, **args)
    assert hierarchy.graph_key(_grid(3), **args) == base  # another batch, one signature
    other = dict(args)
    if change == "capacities":
        other["capacities"] = (CAPACITY, 2048, 1024, 512)
    elif change == "num_down":
        other["num_down"] = 2
        other["capacities"] = default_capacities(CAPACITY, 2)
    elif change == "bits":
        other["bits"] = BitLayout(7, 7, 9)
    elif change == "map_mode":
        other["map_mode"] = "lookup"
    elif change == "rows":
        grid = sparse.SparseGrid(*(t[:2048] for t in grid))
    else:
        grid = grid._replace(keys=grid.keys.to(torch.int32))
    assert hierarchy.graph_key(grid, **other) != base


def test_cache_key_takes_capacities_as_ints():
    grid = _grid(2)
    caps = default_capacities(CAPACITY, NUM_DOWN)
    a = hierarchy.graph_key(grid, NUM_DOWN, caps, DEFAULT_BITS, "derived")
    b = hierarchy.graph_key(grid, NUM_DOWN, [np.int64(c) for c in caps], DEFAULT_BITS,
                            "derived")
    assert a == b
    hash(a)


@pytest.mark.parametrize("name", sorted(TABLES))
def test_constant_equals_its_table_and_is_uploaded_once(name):
    table = TABLES[name]
    dev = torch.device("cpu")
    first = sparse.constant(table, dev)
    want = torch.as_tensor(table)
    assert first.dtype == want.dtype and torch.equal(first, want)
    assert sparse.constant(table, dev) is first
    # the same values from another array are the same entry
    assert sparse.constant(np.array(table, copy=True), dev) is first
    # a copy: writing the numpy table could not reach the device's tensor
    assert first.data_ptr() != want.data_ptr()


def test_constant_first_use_is_a_host_read(monkeypatch):
    monkeypatch.setattr(sparse, "_CONSTANTS", {})
    table = sparse._UP_VALID
    with trace.span("unit", on=True):
        sparse.constant(table, "cpu")
        sparse.constant(table, "cpu")
    recs = trace.drain()
    syncs = [r for r in recs if r.name == "sync::constant"]
    assert len(syncs) == 1 and syncs[0].counts == {"host_syncs": 1}


def test_a_second_build_uploads_no_constant():
    grid = _grid(4)
    for mode in ("derived", "lookup"):
        build_hierarchy(grid, NUM_DOWN, device="cpu", map_mode=mode)
        with trace.span("unit", on=True):
            build_hierarchy(_grid(5), NUM_DOWN, device="cpu", map_mode=mode)
        recs = trace.drain()
        assert not [r for r in recs if r.name == "sync::constant"], mode
    # the scorer's layout and depth
    bits = BitLayout(7, 7, 9)
    small = _grid(6)
    build_hierarchy(small, 2, bits=bits, device="cpu")
    with trace.span("unit", on=True):
        build_hierarchy(_grid(7), 2, bits=bits, device="cpu")
    assert not [r for r in trace.drain() if r.name == "sync::constant"]


@pytest.mark.parametrize("caps", [None, (CAPACITY, 3000, 1000, 300)])
def test_derived_maps_equal_the_lookup_oracle(caps):
    grid = _grid(8)
    d = build_hierarchy(grid, NUM_DOWN, capacities=caps, device="cpu")
    lk = build_hierarchy(grid, NUM_DOWN, capacities=caps, device="cpu", map_mode="lookup")
    # where nothing drops, derived == lookup
    assert int(d.overflow.sum()) == int(lk.overflow.sum()) == 0
    assert _equal(d, lk)


def test_tensors_round_trip_through_the_hierarchy():
    grid = _grid(9)
    hier = build_hierarchy(grid, NUM_DOWN, device="cpu")
    ts = hierarchy.hierarchy_tensors(hier)
    assert len(ts) == 8 * NUM_DOWN + 2
    back = hierarchy.from_tensors(grid, NUM_DOWN, ts)
    assert back.grids[0] is grid and _equal(back, hier)
    assert back.num_levels == NUM_DOWN + 1


@pytest.mark.parametrize("caps", [None, (CAPACITY, 3001, 1003, 301)])
def test_flat_buffers_hold_every_tensor_aligned(caps):
    grid = _grid(10)
    hier = build_hierarchy(grid, NUM_DOWN, capacities=caps, device="cpu")
    ts = hierarchy.hierarchy_tensors(hier)
    flats, layout = hierarchy.flatten(ts)
    assert len(flats) == len(layout.dtypes) == len({t.dtype for t in ts})
    views = hierarchy.unflatten(flats, layout)
    for v, t in zip(views, ts):
        assert v.dtype == t.dtype and v.shape == t.shape and v.is_contiguous()
        assert torch.equal(v, t)
        assert (v.storage_offset() * v.element_size()) % hierarchy.ALIGN_BYTES == 0
    # a replay's copies: clones of the buffers, viewed; writing the graph's
    # buffers afterwards leaves them as they were
    copies = [f.clone() for f in flats]
    out = hierarchy.from_tensors(grid, NUM_DOWN, hierarchy.unflatten(copies, layout))
    for f in flats:
        f.zero_() if f.dtype != torch.bool else f.fill_(False)
    assert _equal(out, hier)
    # no two tensors overlap in a buffer
    for b in range(len(flats)):
        spans = sorted((off, off + torch.Size(shape).numel())
                       for bb, off, shape, _ in layout.entries if bb == b)
        assert all(e0 <= s1 for (_, e0), (s1, _) in zip(spans, spans[1:]))
