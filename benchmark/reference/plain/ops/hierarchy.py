"""Multi-resolution sparse grid hierarchies (counterpart of the JAX
package's ``ops/hierarchy.py``, without bricks and windowed maps).

Capacities are static per level; voxels past a level's capacity drop
deterministically and are counted in ``overflow``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..device import resolve_device
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
    of the derived maps."""
    if map_mode not in ("derived", "lookup"):
        raise ValueError(f"map_mode must be 'derived' or 'lookup', got {map_mode!r}")
    grid0 = grid0.to(resolve_device(device))
    if capacities is None:
        capacities = default_capacities(grid0.capacity, num_down)
    if len(capacities) != num_down + 1:
        raise ValueError(f"need {num_down + 1} capacities, got {len(capacities)}")

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
