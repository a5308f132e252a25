"""Fixed-shape sparse voxel grids and kernel-map construction.

Counterpart of the JAX package's ``ops/sparse.py``. A :class:`SparseGrid` is
a padded array of occupied voxels in canonical key-sorted order (INVALID_KEY
padding last). Kernel maps are dense ``[N, 27]`` int32 neighbor tables
(-1 = absent) with z-fastest offsets. Coordinates at level L are stored in
units of 2^L, so a stride-2 conv at any level reads ``fine = 2 * coarse +
offset``.

Below the topmost level every map is *derived* by index arithmetic from the
level above (:func:`derive_level_maps`): the stride-2 hierarchy doubles as a
2x2x2 brick tiling, so no hash lookups are needed there.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from .hashing import DEFAULT_BITS, INVALID_KEY, BitLayout, lookup, pack_coords
from ..utils import trace
from .scatter import scatter_drop


def _kernel_offsets(kernel_size: int) -> np.ndarray:
    """All integer offsets of a centered cubic kernel, [K, 3], z-fastest."""
    if kernel_size % 2 == 1:
        r = kernel_size // 2
        rng = np.arange(-r, r + 1)
    else:
        rng = np.arange(0, kernel_size)
    grid = np.stack(np.meshgrid(rng, rng, rng, indexing="ij"), axis=-1)
    return grid.reshape(-1, 3).astype(np.int32)


KERNEL_OFFSETS_K3 = _kernel_offsets(3)
KERNEL_OFFSETS_K2 = _kernel_offsets(2)
KERNEL_OFFSETS_K1 = _kernel_offsets(1)

_CONSTANTS: Dict[tuple, torch.Tensor] = {}


def constant(table: np.ndarray, device) -> torch.Tensor:
    """``torch.as_tensor(table, device=device)``, uploaded once a device.

    The first call for a table's values on a device uploads them (under
    ``trace.host_read("constant")``); every later call hands back the same
    tensor, which no caller writes. Entries are never dropped: a captured
    CUDA graph reads them by address (:func:`..hierarchy.build_hierarchy`)."""
    table = np.ascontiguousarray(table)
    key = (table.dtype.str, table.shape, table.tobytes(), torch.device(device))
    t = _CONSTANTS.get(key)
    if t is None:
        with trace.host_read("constant"):
            t = _CONSTANTS.setdefault(key, torch.tensor(table, device=device))
    return t


class SparseGrid(NamedTuple):
    """coords [N, 3] int32 (padding 0), batch [N] int32 (padding -1), keys
    [N] int64 ascending (INVALID_KEY padding), mask [N] bool."""

    coords: torch.Tensor
    batch: torch.Tensor
    keys: torch.Tensor
    mask: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    def count(self) -> torch.Tensor:
        """[] int32 number of valid rows."""
        return self.mask.sum().to(torch.int32)

    def to(self, device) -> "SparseGrid":
        return SparseGrid(*(t.to(device) for t in self))


def _first_of_run(skeys: torch.Tensor) -> torch.Tensor:
    first = torch.ones_like(skeys, dtype=torch.bool)
    first[1:] = skeys[1:] != skeys[:-1]
    return first & (skeys != INVALID_KEY)


def make_grid(
    batch: torch.Tensor,
    coords: torch.Tensor,
    mask: torch.Tensor,
    bits: BitLayout = DEFAULT_BITS,
    capacity: int | None = None,
) -> Tuple[SparseGrid, torch.Tensor]:
    """Canonical deduplicated grid from unsorted voxel coordinates.

    Returns (grid, inverse [N_in] int32: input row -> grid row, -1 for
    invalid rows and for uniques past ``capacity``)."""
    keys = pack_coords(batch, coords, bits, extra_invalid=~mask)
    order = torch.argsort(keys, stable=True)
    skeys = keys[order]
    first = _first_of_run(skeys)
    uidx = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    n = keys.shape[0]
    m = n if capacity is None else int(capacity)
    uidx = torch.where(uidx < m, uidx, torch.full_like(uidx, -1))
    tgt = torch.where(first & (uidx >= 0), uidx, torch.full_like(uidx, m))
    out_keys = scatter_drop(m, INVALID_KEY, tgt, skeys)
    out_batch = scatter_drop(m, -1, tgt, batch[order].to(torch.int32))
    out_coords = scatter_drop(m, 0, tgt, coords[order].to(torch.int32))
    inv_sorted = torch.where(skeys != INVALID_KEY, uidx, torch.full_like(uidx, -1))
    inverse = torch.empty_like(inv_sorted)
    inverse[order] = inv_sorted
    grid = SparseGrid(out_coords, out_batch, out_keys, out_keys != INVALID_KEY)
    return grid, inverse


def same_level_map(
    grid: SparseGrid,
    kernel_offsets: np.ndarray = KERNEL_OFFSETS_K3,
    bits: BitLayout = DEFAULT_BITS,
) -> torch.Tensor:
    """Submanifold kernel map by sort-join lookup: out row i gathers input
    row ``map[i, k]`` at ``coords[i] + offsets[k]``. Only the first (K-1)/2
    offsets are looked up; the mirrored half follows by transposition and
    the center is the identity."""
    n = grid.capacity
    k = kernel_offsets.shape[0]
    kq = (k - 1) // 2
    dev = grid.coords.device
    offs = constant(kernel_offsets[:kq], dev)
    q_coords = grid.coords[:, None, :] + offs[None, :, :]
    q_batch = grid.batch[:, None].expand(n, kq)
    invalid = (~grid.mask)[:, None].expand(n, kq)
    q_keys = pack_coords(q_batch.reshape(-1), q_coords.reshape(-1, 3), bits,
                         extra_invalid=invalid.reshape(-1))
    half = lookup(grid.keys, q_keys).reshape(n, kq)
    nbr = torch.full((n, k), -1, dtype=torch.int32, device=dev)
    nbr[:, :kq] = half
    arange = torch.arange(n, dtype=torch.int32, device=dev)
    nbr[:, kq] = torch.where(grid.mask, arange, torch.full_like(arange, -1))
    rows = arange[:, None].expand(n, kq)
    cols = (k - 1) - torch.arange(kq, dtype=torch.int32, device=dev)[None, :].expand(n, kq)
    tgt = torch.where(half >= 0, half.clamp(min=0) * k + cols, torch.full_like(half, n * k))
    flat = nbr.reshape(-1)
    keep = scatter_drop(n * k, -1, tgt.reshape(-1), rows.reshape(-1))
    # mirrored entries land in the second half only: merge where written
    flat = torch.where(keep >= 0, keep, flat)
    return flat.reshape(n, k)


def downsample(
    fine: SparseGrid, capacity: int, bits: BitLayout = DEFAULT_BITS
) -> Tuple[SparseGrid, torch.Tensor]:
    """Stride-2 coarsening: coarse coords = floor(fine / 2).

    Returns (coarse grid, parent [N_fine] int32 fine row -> coarse row, -1
    for padding and for voxels whose coarse voxel fell past ``capacity``)."""
    coarse_coords = torch.div(fine.coords, 2, rounding_mode="floor")
    keys = pack_coords(fine.batch, coarse_coords, bits, extra_invalid=~fine.mask)
    order = torch.argsort(keys, stable=True)
    skeys = keys[order]
    first = _first_of_run(skeys)
    uidx = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    tgt = torch.where(first & (uidx < capacity), uidx, torch.full_like(uidx, capacity))
    out_keys = scatter_drop(capacity, INVALID_KEY, tgt, skeys)
    out_batch = scatter_drop(capacity, -1, tgt, fine.batch[order])
    out_coords = scatter_drop(capacity, 0, tgt, coarse_coords[order])
    coarse = SparseGrid(out_coords, out_batch, out_keys, out_keys != INVALID_KEY)
    parent_sorted = torch.where((skeys != INVALID_KEY) & (uidx < capacity), uidx,
                                torch.full_like(uidx, -1))
    parent = torch.empty_like(parent_sorted)
    parent[order] = parent_sorted
    return coarse, parent


def _lookup_offsets(table: SparseGrid, q_batch: torch.Tensor, q_coords: torch.Tensor,
                    invalid: torch.Tensor, bits: BitLayout) -> torch.Tensor:
    """Row of ``table`` at each of the [N, K] query voxels, -1 where absent
    or ``invalid``."""
    n, k = invalid.shape
    q_keys = pack_coords(q_batch.reshape(-1), q_coords.reshape(-1, 3), bits,
                         extra_invalid=invalid.reshape(-1))
    return lookup(table.keys, q_keys).reshape(n, k)


def down_map(
    fine: SparseGrid,
    coarse: SparseGrid,
    kernel_offsets: np.ndarray = KERNEL_OFFSETS_K3,
    bits: BitLayout = DEFAULT_BITS,
) -> torch.Tensor:
    """Stride-2 kernel map by direct lookup: coarse row i gathers the fine
    row at ``2 * coarse.coords[i] + offsets[k]`` (ME's stride-2 semantics
    in stride units). Returns [N_coarse, K] int32 into fine rows."""
    n, k = coarse.capacity, kernel_offsets.shape[0]
    offs = constant(kernel_offsets, coarse.coords.device)
    q_coords = 2 * coarse.coords[:, None, :] + offs[None, :, :]
    return _lookup_offsets(fine, coarse.batch[:, None].expand(n, k), q_coords,
                           (~coarse.mask)[:, None].expand(n, k), bits)


def up_map(
    fine: SparseGrid,
    coarse: SparseGrid,
    kernel_offsets: np.ndarray = KERNEL_OFFSETS_K3,
    bits: BitLayout = DEFAULT_BITS,
) -> torch.Tensor:
    """Stride-2 transpose kernel map by direct lookup, writing onto the
    fine grid: fine row i gathers the coarse row at ``(fine.coords[i] +
    offsets[k]) / 2`` where that is integral. Column k pairs with the down
    conv's weight at the negated offset, so an imported transpose kernel
    has its K axis reversed. Returns [N_fine, K] int32 into coarse rows."""
    n, k = fine.capacity, kernel_offsets.shape[0]
    offs = constant(kernel_offsets, fine.coords.device)
    cand = fine.coords[:, None, :] + offs[None, :, :]
    divisible = ((cand & 1) == 0).all(dim=-1)
    q_coords = torch.div(cand, 2, rounding_mode="floor")
    return _lookup_offsets(coarse, fine.batch[:, None].expand(n, k), q_coords,
                           ~(fine.mask[:, None] & divisible), bits)


_DOWN_CHOICE = np.array(
    [[(j >> 2) & 1, (j >> 1) & 1, j & 1] for j in range(8)], dtype=np.int64
)


def down_map_fine_side(
    fine: SparseGrid, coarse: SparseGrid, bits: BitLayout = DEFAULT_BITS
) -> torch.Tensor:
    """Stride-2 kernel map by lookup (the oracle of the derived maps): coarse
    row c gathers the fine voxel at ``2c + off``. Built from the fine side,
    8 candidate parents per fine voxel. Returns [N_coarse, 27] int32."""
    n, nc = fine.capacity, coarse.capacity
    f = fine.coords
    dev = f.device
    cand = torch.stack([torch.div(f - 1, 2, rounding_mode="floor"),
                        torch.div(f + 1, 2, rounding_mode="floor")], dim=1)
    choice = constant(_DOWN_CHOICE, dev)[None].expand(n, 8, 3)
    c_comb = torch.gather(cand, 1, choice)
    off = f[:, None, :] - 2 * c_comb
    valid = (off.abs() <= 1).all(dim=-1) & fine.mask[:, None]
    k = ((off[..., 0] + 1) * 3 + (off[..., 1] + 1)) * 3 + (off[..., 2] + 1)
    q_batch = fine.batch[:, None].expand(n, 8)
    q_keys = pack_coords(q_batch.reshape(-1), c_comb.reshape(-1, 3), bits,
                         extra_invalid=(~valid).reshape(-1))
    c_row = lookup(coarse.keys, q_keys).reshape(n, 8)
    rows = torch.arange(n, dtype=torch.int32, device=dev)[:, None].expand(n, 8)
    tgt = torch.where(c_row >= 0, c_row * 27 + k, torch.full_like(c_row, nc * 27))
    return scatter_drop(nc * 27, -1, tgt.reshape(-1), rows.reshape(-1)).reshape(nc, 27)


def up_map_from_down(dmap: torch.Tensor, n_fine: int) -> torch.Tensor:
    """Transpose-conv map from the down map: umap[f, K-1-k] = c wherever
    dmap[c, k] = f (collision-free). Returns [N_fine, K] int32."""
    nc, k = dmap.shape
    dev = dmap.device
    cols = (k - 1) - torch.arange(k, dtype=torch.int32, device=dev)[None, :].expand(nc, k)
    crows = torch.arange(nc, dtype=torch.int32, device=dev)[:, None].expand(nc, k)
    tgt = torch.where(dmap >= 0, dmap.clamp(min=0) * k + cols,
                      torch.full_like(dmap, n_fine * k))
    return scatter_drop(n_fine * k, -1, tgt.reshape(-1), crows.reshape(-1)).reshape(n_fine, k)


def slot_table_from_parent(
    fine: SparseGrid, parent: torch.Tensor, coarse_capacity: int
) -> torch.Tensor:
    """[N_coarse, 8] int32: slot_table[c, sx*4+sy*2+sz] = fine row of the
    voxel at 2c + (sx, sy, sz), or -1."""
    par = fine.coords & 1
    slot = par[:, 0] * 4 + par[:, 1] * 2 + par[:, 2]
    ok = fine.mask & (parent >= 0)
    tgt = torch.where(ok, parent * 8 + slot, torch.full_like(parent, coarse_capacity * 8))
    rows = torch.arange(fine.capacity, dtype=torch.int32, device=parent.device)
    return scatter_drop(coarse_capacity * 8, -1, tgt, rows).reshape(coarse_capacity, 8)


# Static tables of the derived maps (see the JAX package for the derivation).


def _box_same_tables() -> Tuple[np.ndarray, np.ndarray]:
    """(KOFF8 [8, 8], COL64 [8, 27]): for parity p, the coarse offset index
    of box brick e, and for offset k the column e * 8 + slot of its voxel."""
    koff8 = np.zeros((8, 8), np.int64)
    col64 = np.zeros((8, 27), np.int64)
    for p in range(8):
        par = ((p >> 2) & 1, (p >> 1) & 1, p & 1)
        for e in range(8):
            ebits = ((e >> 2) & 1, (e >> 1) & 1, e & 1)
            d = [ebits[a] * (1 if par[a] else -1) for a in range(3)]
            koff8[p, e] = ((d[0] + 1) * 3 + (d[1] + 1)) * 3 + (d[2] + 1)
        for k, o in enumerate(KERNEL_OFFSETS_K3):
            q = [par[a] + int(o[a]) for a in range(3)]
            d = [q[a] >> 1 for a in range(3)]
            s = [q[a] & 1 for a in range(3)]
            e = (d[0] != 0) * 4 + (d[1] != 0) * 2 + (d[2] != 0)
            col64[p, k] = e * 8 + (s[0] * 4 + s[1] * 2 + s[2])
    return koff8, col64


def _box_down_tables() -> Tuple[np.ndarray, np.ndarray]:
    """(KOFFD [8], DCOL64 [27]) for the down map: coarse c gathers fine
    2c + o living in brick c + (o >> 1), at slot o & 1."""
    koffd = np.zeros((8,), np.int64)
    dcol = np.zeros((27,), np.int64)
    for e in range(8):
        d = [-((e >> (2 - a)) & 1) for a in range(3)]
        koffd[e] = ((d[0] + 1) * 3 + (d[1] + 1)) * 3 + (d[2] + 1)
    for k, o in enumerate(KERNEL_OFFSETS_K3):
        d = [int(o[a]) >> 1 for a in range(3)]
        s = [int(o[a]) & 1 for a in range(3)]
        e = (-d[0]) * 4 + (-d[1]) * 2 + (-d[2])
        dcol[k] = e * 8 + (s[0] * 4 + s[1] * 2 + s[2])
    return koffd, dcol


def _up_tables() -> Tuple[np.ndarray, np.ndarray]:
    """(KOFF [8, 27], VALID [8, 27]): up-map column j of a fine voxel with
    parity p reads parent-neighbor column KOFF[p, j] where VALID[p, j]."""
    koff = np.full((8, 27), 13, np.int64)
    valid = np.zeros((8, 27), bool)
    for p in range(8):
        par = ((p >> 2) & 1, (p >> 1) & 1, p & 1)
        for j, o in enumerate(KERNEL_OFFSETS_K3):
            q = [par[a] + int(o[a]) for a in range(3)]
            if all(v % 2 == 0 for v in q):
                d = [v // 2 for v in q]
                koff[p, j] = ((d[0] + 1) * 3 + (d[1] + 1)) * 3 + (d[2] + 1)
                valid[p, j] = True
    return koff, valid


_BOX_KOFF8, _BOX_COL64 = _box_same_tables()
_BOX_KOFFD, _BOX_DCOL64 = _box_down_tables()
_UP_KOFF, _UP_VALID = _up_tables()


def _gather_pad(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Row gather where rows < 0 hit the table's trailing all--1 pad row."""
    pad = table.shape[0] - 1
    return table[torch.where(rows >= 0, rows, torch.full_like(rows, pad)).long()]


def _pad_rows(table: torch.Tensor) -> torch.Tensor:
    return torch.cat([table, torch.full((1, table.shape[1]), -1, dtype=table.dtype,
                                        device=table.device)], dim=0)


def _parity_permute(table_nk: torch.Tensor, parity: torch.Tensor, perm: np.ndarray):
    """out[i, k] = table_nk[i, perm[parity[i], k]]."""
    p = constant(perm, table_nk.device)[parity.long()]
    return torch.gather(table_nk, 1, p)


def _same_parity_tables() -> Tuple[np.ndarray, np.ndarray]:
    """(KOFF [8, 27], SLOT [8, 27]): for parity p and offset k, the coarse
    offset index of the brick holding voxel c + o_k, and its slot there."""
    koff = np.zeros((8, 27), np.int64)
    slot = np.zeros((8, 27), np.int64)
    for p in range(8):
        par = ((p >> 2) & 1, (p >> 1) & 1, p & 1)
        for k, o in enumerate(KERNEL_OFFSETS_K3):
            q = [par[a] + int(o[a]) for a in range(3)]
            d = [v >> 1 for v in q]
            koff[p, k] = ((d[0] + 1) * 3 + (d[1] + 1)) * 3 + (d[2] + 1)
            slot[p, k] = (q[0] & 1) * 4 + (q[1] & 1) * 2 + (q[2] & 1)
    return koff, slot


_SAME_KOFF, _SAME_SLOT = _same_parity_tables()
# the down map's brick c + (o >> 1) and slot o & 1 of each offset o
_DOWN_KOFF = np.array([(((int(o[0]) >> 1) + 1) * 3 + ((int(o[1]) >> 1) + 1)) * 3
                       + ((int(o[2]) >> 1) + 1) for o in KERNEL_OFFSETS_K3], np.int64)
_DOWN_SLOT = np.array([(int(o[0]) & 1) * 4 + (int(o[1]) & 1) * 2 + (int(o[2]) & 1)
                       for o in KERNEL_OFFSETS_K3], np.int64)


def _slot_rows(slot_table: torch.Tensor, bricks: torch.Tensor, slots: torch.Tensor):
    """slot_table[bricks, slots], -1 where ``bricks`` < 0."""
    idx = torch.where(bricks >= 0, bricks * 8 + slots,
                      torch.full_like(bricks, slot_table.numel() - 1))
    rows = slot_table.reshape(-1)[idx.long()]
    return torch.where(bricks >= 0, rows, torch.full_like(rows, -1))


def derive_same_map(
    fine: SparseGrid,
    parent: torch.Tensor,
    slot_table: torch.Tensor,
    coarse_map: torch.Tensor,
) -> torch.Tensor:
    """The fine level's [N, 27] submanifold map from the coarse 27-map and
    the brick slot table, one [N, 27] element gather (the split form of
    :func:`derive_level_maps`' ``same``, equal to it)."""
    par_bits = fine.coords & 1
    parity = par_bits[:, 0] * 4 + par_bits[:, 1] * 2 + par_bits[:, 2]
    ok = fine.mask & (parent >= 0)
    pnbr = coarse_map[parent.clamp(min=0).long()]
    bricks = _parity_permute(pnbr, parity, _SAME_KOFF)
    slots = constant(_SAME_SLOT, pnbr.device)[parity.long()]
    rows = _slot_rows(slot_table, bricks, slots)
    return torch.where(ok[:, None], rows, torch.full_like(rows, -1))


def derive_down_map(coarse_map: torch.Tensor, slot_table: torch.Tensor) -> torch.Tensor:
    """The [N_coarse, 27] stride-2 map from the coarse 27-map and the slot
    table: coarse c gathers fine 2c + o, slot o & 1 of brick c + (o >> 1)
    (the split form of :func:`derive_level_maps`' ``down``, equal to it)."""
    dev = coarse_map.device
    bricks = coarse_map[:, constant(_DOWN_KOFF, dev)]
    return _slot_rows(slot_table, bricks, constant(_DOWN_SLOT, dev)[None, :])


def derive_level_maps(
    fine: SparseGrid,
    parent: torch.Tensor,
    slot_table: torch.Tensor,
    coarse_map: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(same [N, 27], down [N_coarse, 27], up [N, 27]) maps of one level,
    derived from the coarse level's 27-map and the brick slot table."""
    dev = coarse_map.device
    cmap_p = _pad_rows(coarse_map)
    st_p = _pad_rows(slot_table)
    pnbr = _gather_pad(cmap_p, parent)  # [N, 27]; dropped parents -> all -1
    par_bits = fine.coords & 1
    parity = par_bits[:, 0] * 4 + par_bits[:, 1] * 2 + par_bits[:, 2]

    box_rows = _parity_permute(pnbr, parity, _BOX_KOFF8)  # [N, 8]
    vals = torch.cat([_gather_pad(st_p, box_rows[:, e]) for e in range(8)], dim=1)
    same = _parity_permute(vals, parity, _BOX_COL64)
    same = torch.where(fine.mask[:, None], same, torch.full_like(same, -1))

    dvals = torch.cat(
        [
            slot_table if int(_BOX_KOFFD[e]) == 13
            else _gather_pad(st_p, coarse_map[:, int(_BOX_KOFFD[e])])
            for e in range(8)
        ],
        dim=1,
    )  # [Nc, 64]
    down = dvals[:, constant(_BOX_DCOL64, dev)]

    up = _parity_permute(pnbr, parity, _UP_KOFF)
    up_ok = constant(_UP_VALID, dev)[parity.long()] & fine.mask[:, None]
    up = torch.where(up_ok, up, torch.full_like(up, -1))
    return same, down, up
