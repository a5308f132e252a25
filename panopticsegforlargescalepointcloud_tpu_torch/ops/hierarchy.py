"""Multi-resolution sparse grid hierarchies (counterpart of the JAX
package's ``ops/hierarchy.py``, without bricks and windowed maps).

Capacities are static per level; voxels past a level's capacity drop
deterministically and are counted in ``overflow``.

On a CUDA device the derived build replays a CUDA graph. Eagerly it
dispatches some 1,600 small ops (num_down 6; about 620 at num_down 2),
each a few microseconds of device work behind a Python dispatch, so the
host sets its pace. Every shape there is static (the capacities are fixed
per level) and its constant tables stay on the card
(:func:`.sparse.constant`), so :func:`build_hierarchy` captures the build
once per input signature (:func:`graph_key`) and then replays it: four
copies into the graph's inputs, one graph launch and one copy of its
outputs a dtype.
"""

from __future__ import annotations

import collections
from typing import List, NamedTuple, Sequence, Tuple

import torch

from ..device import resolve_device
from ..utils import trace
from .hashing import DEFAULT_BITS, BitLayout
from .sparse import (
    KERNEL_OFFSETS_K3,
    SparseGrid,
    derive_level_maps,
    down_map_fine_side,
    downsample,
    same_level_map,
    slot_table_from_parent,
    up_map_from_down,
)


class Hierarchy(NamedTuple):
    """grids[l] at stride 2^l; same_maps[l] [N_l, 27] submanifold maps
    (``bricks`` in the JAX package); down_maps[l] [N_{l+1}, 27] gathers
    level l; up_maps[l] [N_l, 27] gathers level l+1; parents[l] [N_l] fine
    row -> coarse row; overflow [num_down + 1] int32 dropped-voxel counts."""

    grids: Tuple[SparseGrid, ...]
    same_maps: Tuple[torch.Tensor, ...]
    down_maps: Tuple[torch.Tensor, ...]
    up_maps: Tuple[torch.Tensor, ...]
    parents: Tuple[torch.Tensor, ...]
    overflow: torch.Tensor

    @property
    def num_levels(self) -> int:
        return len(self.grids)


# Occupancy-matched capacity ratios per level (JAX package, measured decay of
# ~3.5x per stride-2 level on NPM3D-scale batches, with ~2x headroom).
_CAP_RATIOS = (1.0, 0.75, 0.32, 0.105, 0.04, 0.016, 0.008, 0.004, 0.002)


def default_capacities(n0: int, num_down: int, floor: int = 1024) -> Tuple[int, ...]:
    caps = [n0]
    for level in range(1, num_down + 1):
        r = _CAP_RATIOS[min(level, len(_CAP_RATIOS) - 1)]
        c = -(-int(n0 * r) // 512) * 512
        caps.append(max(min(c, n0), min(floor, n0)))
    return tuple(caps)


def build_hierarchy(
    grid0: SparseGrid,
    num_down: int,
    capacities: Tuple[int, ...] | None = None,
    bits: BitLayout = DEFAULT_BITS,
    device=None,
    map_mode: str = "derived",
) -> Hierarchy:
    """Grids + submanifold maps + strided maps for an L-level UNet.

    ``map_mode="derived"``: only the topmost level pays a sort-join lookup;
    every other map is derived from the level above by index arithmetic.
    ``"lookup"``: every level's maps by sort-join lookups (submanifold maps,
    the down map from the fine side, the up map its transpose), the oracle
    of the derived maps.

    Where :func:`graph_engaged`, the build replays a CUDA graph, captured on
    the first call of its signature (:func:`graph_key`); the outputs are
    copies of the graph's, equal bit for bit to the eager build's
    (:func:`build_hierarchy_eager`), and ``grids[0]`` is ``grid0``."""
    if map_mode not in ("derived", "lookup"):
        raise ValueError(f"map_mode must be 'derived' or 'lookup', got {map_mode!r}")
    grid0 = grid0.to(resolve_device(device))
    if capacities is None:
        capacities = default_capacities(grid0.capacity, num_down)
    if len(capacities) != num_down + 1:
        raise ValueError(f"need {num_down + 1} capacities, got {len(capacities)}")
    if not graph_engaged(grid0, map_mode):
        return build_hierarchy_eager(grid0, num_down, capacities, bits, map_mode)
    key = graph_key(grid0, num_down, capacities, bits, map_mode)
    with trace.span("hierarchy_graph"):
        graph = _GRAPHS.get(key)
        if graph is None:
            graph = _GRAPHS[key] = _Graph(grid0, num_down, capacities, bits)
            trace.count("hier_graph_captures")
            while len(_GRAPHS) > GRAPH_CACHE_SIZE:
                _GRAPHS.popitem(last=False)
        _GRAPHS.move_to_end(key)
        trace.count("hier_graph_replays")
        return graph.replay(grid0)


def build_hierarchy_eager(
    grid0: SparseGrid,
    num_down: int,
    capacities: Tuple[int, ...],
    bits: BitLayout = DEFAULT_BITS,
    map_mode: str = "derived",
) -> Hierarchy:
    """:func:`build_hierarchy` op by op, on ``grid0``'s device."""
    grids, parents, slot_tables, overflows = [grid0], [], [], []
    fine = grid0
    for level in range(num_down):
        coarse, parent = downsample(fine, capacities[level + 1], bits)
        overflows.append(((parent < 0) & fine.mask).sum().to(torch.int32))
        grids.append(coarse)
        parents.append(parent)
        slot_tables.append(slot_table_from_parent(fine, parent, capacities[level + 1]))
        fine = coarse

    same_maps = [None] * (num_down + 1)
    down_maps = [None] * num_down
    up_maps = [None] * num_down
    same_maps[num_down] = same_level_map(grids[num_down], KERNEL_OFFSETS_K3, bits)
    for level in range(num_down - 1, -1, -1):
        if map_mode == "derived":
            same_maps[level], down_maps[level], up_maps[level] = derive_level_maps(
                grids[level], parents[level], slot_tables[level], same_maps[level + 1])
        else:
            same_maps[level] = same_level_map(grids[level], KERNEL_OFFSETS_K3, bits)
            down_maps[level] = down_map_fine_side(grids[level], grids[level + 1], bits)
            up_maps[level] = up_map_from_down(down_maps[level], capacities[level])
    overflows.append(torch.zeros((), dtype=torch.int32, device=grid0.keys.device))
    return Hierarchy(
        grids=tuple(grids),
        same_maps=tuple(same_maps),
        down_maps=tuple(down_maps),
        up_maps=tuple(up_maps),
        parents=tuple(parents),
        overflow=torch.stack(overflows),
    )


# ------------------------------------------------------------------ CUDA graphs

GRAPH_WARMUP = 2  # eager builds on a side stream before capture
GRAPH_CACHE_SIZE = 4  # graphs kept, the least recently used dropped

_GRAPHS: "collections.OrderedDict[tuple, _Graph]" = collections.OrderedDict()


def graph_engaged(grid0: SparseGrid, map_mode: str) -> bool:
    """Whether :func:`build_hierarchy` replays a CUDA graph: ``grid0`` on a
    CUDA device, the derived maps (``"lookup"``, their oracle, stays
    eager), and no capture under way on the current stream."""
    return (grid0.keys.device.type == "cuda" and map_mode == "derived"
            and not torch.cuda.is_current_stream_capturing())


def graph_key(grid0: SparseGrid, num_down: int, capacities: Sequence[int], bits: BitLayout,
              map_mode: str) -> tuple:
    """A graph's input signature: the shape, dtype and device of each of
    ``grid0``'s tensors, the capacities, the depth, the bit layout and the
    map mode."""
    return (tuple((tuple(t.shape), t.dtype, t.device) for t in grid0),
            tuple(int(c) for c in capacities), int(num_down), tuple(bits), map_mode)


def hierarchy_tensors(hier: Hierarchy) -> List[torch.Tensor]:
    """Every tensor of ``hier`` but ``grids[0]``'s, in a fixed order:
    the coarser grids' coords, batch, keys and mask, then the same, down
    and up maps, the parents and the overflow counts."""
    return [t for g in hier.grids[1:] for t in g] + [
        *hier.same_maps, *hier.down_maps, *hier.up_maps, *hier.parents, hier.overflow]


def from_tensors(grid0: SparseGrid, num_down: int, ts: Sequence[torch.Tensor]) -> Hierarchy:
    """The inverse of :func:`hierarchy_tensors`, with ``grid0`` as level 0."""
    n, g = num_down, 4 * num_down
    grids = (grid0,) + tuple(SparseGrid(*ts[4 * i:4 * i + 4]) for i in range(n))
    rest = ts[g:]
    return Hierarchy(grids=grids, same_maps=tuple(rest[:n + 1]),
                     down_maps=tuple(rest[n + 1:2 * n + 1]),
                     up_maps=tuple(rest[2 * n + 1:3 * n + 1]),
                     parents=tuple(rest[3 * n + 1:4 * n + 1]), overflow=rest[4 * n + 1])


ALIGN_BYTES = 512  # each tensor's start in its flat buffer, as the allocator aligns


class FlatLayout(NamedTuple):
    """Where :func:`flatten` puts each tensor: the buffers' dtypes and
    lengths, and per tensor its buffer's index, its offset there (a
    multiple of ``ALIGN_BYTES``), its shape and its contiguous strides."""

    dtypes: Tuple[torch.dtype, ...]
    lengths: Tuple[int, ...]
    entries: Tuple[Tuple[int, int, Tuple[int, ...], Tuple[int, ...]], ...]


def flat_layout(ts: Sequence[torch.Tensor]) -> FlatLayout:
    """One flat buffer a dtype, holding ``ts`` in order."""
    dtypes = tuple(dict.fromkeys(t.dtype for t in ts))
    lengths, entries = [0] * len(dtypes), []
    for t in ts:
        b = dtypes.index(t.dtype)
        step = max(ALIGN_BYTES // t.element_size(), 1)
        off = -(-lengths[b] // step) * step
        entries.append((b, off, tuple(t.shape), torch.empty(t.shape, device="meta").stride()))
        lengths[b] = off + t.numel()
    return FlatLayout(dtypes, tuple(lengths), tuple(entries))


def unflatten(flats: Sequence[torch.Tensor], layout: FlatLayout) -> List[torch.Tensor]:
    """The tensors of ``layout``, as views of ``flats``."""
    return [flats[b].as_strided(shape, stride, off) for b, off, shape, stride in layout.entries]


def flatten(ts: Sequence[torch.Tensor]) -> Tuple[List[torch.Tensor], FlatLayout]:
    """``ts`` copied into one flat buffer a dtype (:func:`flat_layout`)."""
    layout = flat_layout(ts)
    dev = ts[0].device
    flats = [torch.zeros(n, dtype=d, device=dev) for d, n in zip(layout.dtypes, layout.lengths)]
    for view, t in zip(unflatten(flats, layout), ts):
        view.copy_(t)
    return flats, layout


class _Graph:
    """One captured derived build: its static copy of grid0, the graph,
    and the flat buffers (:func:`flatten`) its outputs land in."""

    def __init__(self, grid0: SparseGrid, num_down: int, capacities: Sequence[int],
                 bits: BitLayout):
        self.num_down = num_down

        def build(g):
            return hierarchy_tensors(build_hierarchy_eager(g, num_down, capacities, bits))

        with torch.cuda.device(grid0.keys.device):
            torch.cuda.synchronize()
            self.inputs = SparseGrid(*(t.clone() for t in grid0))
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            # the warm-up uploads the constant tables, which a capture cannot
            with torch.cuda.stream(side):
                for _ in range(GRAPH_WARMUP):
                    build(self.inputs)
            torch.cuda.synchronize()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                self.outputs, self.layout = flatten(build(self.inputs))

    def replay(self, grid0: SparseGrid) -> Hierarchy:
        """The hierarchy of ``grid0``: its tensors copied in, the graph
        replayed, its outputs copied out (a caller may keep a hierarchy
        past the next replay)."""
        for s, t in zip(self.inputs, grid0):
            s.copy_(t)
        self.graph.replay()
        flats = [f.clone() for f in self.outputs]
        return from_tensors(grid0, self.num_down, unflatten(flats, self.layout))
