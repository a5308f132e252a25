"""The benchmark's inputs, drawn from ``--seed``: frozen copies of the
port's synthetic NPM3D tile (``data/synthetic.py:synthetic_tile``) and of
its forest scene (``flagship.write_forest_scene``), with the same draws in
the same order. The program and the reference are handed the same tiles
and read the same forest files."""

from __future__ import annotations

from typing import List

import numpy as np

from .reference.plain.data.ply import write_ply


def synthetic_tile(rng: np.random.Generator, num_classes: int, stuff_classes, n_instances: int,
                   pts_per_instance: int, n_ground: int, radius: float, grid_size: float) -> dict:
    """One voxelized cylinder tile with planted blobby instances (thing
    classes: gaussian blobs; stuff: a ground plane), centred, one random
    point per voxel; a tile dict for ``collate_tiles``."""
    thing_classes = [c for c in range(num_classes) if c not in stuff_classes]
    pts, labels, inst = [], [], []
    for i in range(n_instances):
        center = np.array([rng.uniform(-radius * 0.7, radius * 0.7),
                           rng.uniform(-radius * 0.7, radius * 0.7),
                           rng.uniform(0.5, 3.0)])
        pts.append(center + rng.normal(scale=0.4, size=(pts_per_instance, 3)))
        labels.append(np.full(pts_per_instance, rng.choice(thing_classes)))
        inst.append(np.full(pts_per_instance, i + 1))
    ground = np.stack([rng.uniform(-radius, radius, n_ground),
                       rng.uniform(-radius, radius, n_ground),
                       rng.normal(scale=0.05, size=n_ground)], axis=1)
    pts.append(ground)
    labels.append(np.full(n_ground, stuff_classes[0]))
    inst.append(np.zeros(n_ground))

    pos = np.concatenate(pts).astype(np.float32)
    y = np.concatenate(labels).astype(np.int32)
    instance = np.concatenate(inst).astype(np.int32)
    pos = pos - pos.mean(0, keepdims=True)
    coords = np.round(pos / grid_size).astype(np.int32)
    key = (coords[:, 0].astype(np.int64) * 4_000_037 + coords[:, 1].astype(np.int64) * 2_003
           + coords[:, 2].astype(np.int64))
    perm = rng.permutation(len(key))
    _, first = np.unique(key[perm], return_index=True)
    sel = perm[first]
    pos, y, instance, coords = pos[sel], y[sel], instance[sel], coords[sel]

    vote = np.zeros_like(pos)
    compact = np.zeros(len(pos), np.int32)
    next_id = 1
    for i in np.unique(instance):
        if i == 0:
            continue
        ind = instance == i
        p = pos[ind]
        vote[ind] = 0.5 * (p.min(0) + p.max(0)) - p
        compact[ind] = next_id
        next_id += 1
    feats = np.concatenate([pos, pos[:, 2:3]], axis=1).astype(np.float32)
    return dict(coords=coords, feats=feats, pos=pos.astype(np.float32), y=y,
                instance_labels=compact, vote_label=vote.astype(np.float32),
                origin_id=sel.astype(np.int32), num_instances=next_id - 1)


def tile_pool(seed: int, count: int, **tile_params) -> List[dict]:
    """``count`` tiles from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return [synthetic_tile(rng, **tile_params) for _ in range(count)]


def forest_scene(seed, extent: float, n_trees: int, pts_per_tree: int, n_ground: int):
    """(pos [N, 3] f32, semantic [N] int32, tree id [N] int32) of a forest
    plot: ``n_trees`` gaussian trunks-and-crowns (class 2) over a ground
    plane (class 1, tree id -1)."""
    rng = np.random.default_rng(seed)
    pts, sem, tid = [], [], []
    for t in range(n_trees):
        c = rng.uniform(2, extent - 2, 2)
        xy = c + rng.normal(scale=0.8, size=(pts_per_tree, 2))
        z = rng.uniform(0, 18, (pts_per_tree, 1)) * rng.uniform(0.5, 1.0)
        pts.append(np.concatenate([xy, z], 1))
        sem.append(np.full(pts_per_tree, 2))
        tid.append(np.full(pts_per_tree, t))
    pts.append(np.stack([rng.uniform(0, extent, n_ground), rng.uniform(0, extent, n_ground),
                         rng.normal(scale=0.05, size=n_ground)], 1))
    sem.append(np.full(n_ground, 1))
    tid.append(np.full(n_ground, -1))
    return (np.concatenate(pts).astype(np.float32), np.concatenate(sem).astype(np.int32),
            np.concatenate(tid).astype(np.int32))


def write_forest(path: str, seed, **scene_params) -> int:
    """:func:`forest_scene` as a binary PLY in the FOR-instance layout
    (x, y, z, semantic_seg, treeID); returns the point count."""
    pos, sem, tid = forest_scene(seed, **scene_params)
    write_ply(path, [pos, sem, tid], ["x", "y", "z", "semantic_seg", "treeID"])
    return len(pos)
