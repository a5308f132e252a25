"""Fixed-shape batch structures and host-side assembly (numpy).

A copy of the JAX package's ``data/batch.py``: all tiles of a batch share one
padded [N_cap] row axis with a ``batch`` id per row and a valid ``mask`` -
the shape every op of the port consumes.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np


class VoxelBatch(NamedTuple):
    """One device-local batch of voxelized tiles (padded to capacity).

    All arrays have leading dim N (the voxel capacity); padding rows have
    mask=False, batch=-1, labels=-1/0.
    """

    coords: np.ndarray  # [N, 3] int32 quantized voxel coords (centered)
    batch: np.ndarray  # [N] int32 tile index within the batch
    feats: np.ndarray  # [N, F] float32 input features
    mask: np.ndarray  # [N] bool
    pos: np.ndarray  # [N, 3] float32 (centered) point positions
    y: np.ndarray  # [N] int32 semantic label, -1 = ignore
    instance_labels: np.ndarray  # [N] int32 compact per-tile id, 0 = none
    instance_mask: np.ndarray  # [N] bool
    vote_label: np.ndarray  # [N, 3] float32 center - pos
    origin_id: np.ndarray  # [N] int32 provenance into the full cloud (-1 pad)
    num_instances: np.ndarray  # [B] int32


def collate_tiles(
    tiles: List[dict],
    capacity: int,
    num_tiles: int,
    feat_dim: int = 4,
) -> VoxelBatch:
    """Assemble tile dicts (numpy) into one padded VoxelBatch.

    Each tile dict needs: coords [n,3] int32, feats [n,F], pos [n,3],
    y [n], instance_labels [n] (compact 1..K, 0 none), vote_label [n,3],
    origin_id [n] (optional), num_instances (int).
    Tiles are truncated if the total exceeds capacity (deterministically,
    later rows first) - size capacities to avoid this.
    """
    assert len(tiles) <= num_tiles
    coords = np.zeros((capacity, 3), np.int32)
    batch = np.full((capacity,), -1, np.int32)
    feats = np.zeros((capacity, feat_dim), np.float32)
    mask = np.zeros((capacity,), bool)
    pos = np.zeros((capacity, 3), np.float32)
    y = np.full((capacity,), -1, np.int32)
    inst = np.zeros((capacity,), np.int32)
    vote = np.zeros((capacity, 3), np.float32)
    origin = np.full((capacity,), -1, np.int32)
    ninst = np.zeros((num_tiles,), np.int32)

    ofs = 0
    for i, t in enumerate(tiles):
        n = len(t["coords"])
        take = min(n, capacity - ofs)
        if take <= 0:
            break
        sl = slice(ofs, ofs + take)
        coords[sl] = t["coords"][:take]
        batch[sl] = i
        feats[sl] = t["feats"][:take]
        mask[sl] = True
        pos[sl] = t["pos"][:take]
        y[sl] = t["y"][:take]
        inst[sl] = t["instance_labels"][:take]
        vote[sl] = t["vote_label"][:take]
        if "origin_id" in t and t["origin_id"] is not None:
            origin[sl] = t["origin_id"][:take]
        ninst[i] = int(t.get("num_instances", int(inst[sl].max()) if take else 0))
        ofs += take

    return VoxelBatch(
        coords=coords,
        batch=batch,
        feats=feats,
        mask=mask,
        pos=pos,
        y=y,
        instance_labels=inst,
        instance_mask=inst > 0,
        vote_label=vote,
        origin_id=origin,
        num_instances=ninst,
    )


def stack_device_batches(batches: List[VoxelBatch]) -> VoxelBatch:
    """Stack per-device batches along a new leading [D] axis (one entry per
    rank of a data-parallel mesh)."""
    return VoxelBatch(*[np.stack(arrs) for arrs in zip(*batches)])


def batch_arrays(vb: VoxelBatch) -> Tuple[np.ndarray, ...]:
    """The positional array tuple the eval forward and train step consume
    (the JAX package's ``train/step.py:batch_arrays`` order)."""
    return (vb.coords, vb.batch, vb.mask, vb.feats, vb.pos, vb.y, vb.instance_labels,
            vb.vote_label, vb.origin_id)
