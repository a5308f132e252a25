"""Synthetic labeled scenes (the MockDataset equivalent, utils/mock.py in the
reference): random cylinders with planted object instances for tests, CI and
benchmarks - no real data needed."""

from __future__ import annotations

import numpy as np


def synthetic_tile(
    rng: np.random.Generator,
    num_classes: int = 9,
    stuff_classes=(0, 7, 8),
    n_instances: int = 6,
    pts_per_instance: int = 120,
    n_ground: int = 800,
    radius: float = 8.0,
    grid_size: float = 0.2,
    max_instances: int = 64,
) -> dict:
    """One voxelized cylinder tile with planted blobby instances.

    Things are gaussian blobs of a random thing class; stuff is a ground
    plane. Returns a tile dict for :func:`..data.batch.collate_tiles`.
    """
    thing_classes = [c for c in range(num_classes) if c not in stuff_classes]
    pts, labels, inst = [], [], []
    for i in range(n_instances):
        center = np.array(
            [
                rng.uniform(-radius * 0.7, radius * 0.7),
                rng.uniform(-radius * 0.7, radius * 0.7),
                rng.uniform(0.5, 3.0),
            ]
        )
        blob = center + rng.normal(scale=0.4, size=(pts_per_instance, 3))
        pts.append(blob)
        labels.append(np.full(pts_per_instance, rng.choice(thing_classes)))
        inst.append(np.full(pts_per_instance, i + 1))
    ground = np.stack(
        [
            rng.uniform(-radius, radius, n_ground),
            rng.uniform(-radius, radius, n_ground),
            rng.normal(scale=0.05, size=n_ground),
        ],
        axis=1,
    )
    pts.append(ground)
    labels.append(np.full(n_ground, stuff_classes[0]))
    inst.append(np.zeros(n_ground))

    pos = np.concatenate(pts).astype(np.float32)
    y = np.concatenate(labels).astype(np.int32)
    instance = np.concatenate(inst).astype(np.int32)
    pos = pos - pos.mean(0, keepdims=True)  # Center transform

    # voxelize: one random point per voxel (GridSampling3D mode="last")
    coords = np.round(pos / grid_size).astype(np.int32)
    key = coords[:, 0].astype(np.int64) * 4_000_037 + coords[:, 1].astype(
        np.int64
    ) * 2_003 + coords[:, 2].astype(np.int64)
    perm = rng.permutation(len(key))
    _, first = np.unique(key[perm], return_index=True)
    sel = perm[first]
    pos, y, instance, coords = pos[sel], y[sel], instance[sel], coords[sel]

    # compact instance ids + vote labels (set_extra_labels semantics,
    # datasets/panoptic/utils.py:4-49)
    vote = np.zeros_like(pos)
    compact = np.zeros(len(pos), np.int32)
    next_id = 1
    for i in np.unique(instance):
        if i == 0:
            continue
        ind = instance == i
        if not ind.any():
            continue
        p = pos[ind]
        center = 0.5 * (p.min(0) + p.max(0))
        vote[ind] = center - p
        compact[ind] = next_id
        next_id += 1
    assert next_id - 1 <= max_instances

    feats = np.concatenate([pos, pos[:, 2:3]], axis=1).astype(np.float32)
    return dict(
        coords=coords,
        feats=feats,
        pos=pos.astype(np.float32),
        y=y,
        instance_labels=compact,
        vote_label=vote.astype(np.float32),
        origin_id=sel.astype(np.int32),
        num_instances=next_id - 1,
    )
