"""Host-side grid voxelization (GridSampling3D semantics).

A copy of the JAX package's ``data/voxelize.py`` on its numpy path (the
optional C++ ``ops/native`` path computes the same function and is not
ported).

Reproduces upstream ``torch_points3d/core/data_transform/
grid_transform.py:151-210``: cluster on round(pos/size); mode "last" =
random representative per voxel (shuffle + first occurrence); mode "mean" =
mean for continuous attrs, one-hot-majority for integer label keys
("y", "instance_labels"). Note the reference hard-sets mode to "last" at
runtime (grid_transform.py:196) - "last" is the behavior the paper pipeline
actually uses everywhere.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

INTEGER_LABEL_KEYS = ("y", "instance_labels")


def voxel_keys(pos: np.ndarray, size: float) -> np.ndarray:
    """int64 lattice key per point (collision-free for |coord| < 2^20)."""
    c = np.round(pos / size).astype(np.int64)
    c = c - c.min(0, keepdims=True)
    return (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]


def grid_sample(
    pos: np.ndarray,
    attrs: Dict[str, np.ndarray],
    size: float,
    mode: str = "last",
    rng: Optional[np.random.Generator] = None,
    return_cluster: bool = False,
):
    """Voxel-subsample a cloud.

    Returns (pos_out, attrs_out[, cluster]) where cluster maps each input
    point to its voxel index in the output.
    """
    n = len(pos)
    if mode == "last":
        if rng is None:
            rng = np.random.default_rng()
        perm = rng.permutation(n)
        keys = voxel_keys(pos[perm], size)
        _, first, inv = np.unique(keys, return_index=True, return_inverse=True)
        sel = perm[first]
        cluster = np.empty(n, np.int64)
        cluster[perm] = inv
        out_pos = pos[sel]
        out = {k: v[sel] for k, v in attrs.items()}
        if return_cluster:
            return out_pos, out, cluster
        return out_pos, out
    elif mode == "mean":
        keys = voxel_keys(pos, size)
        uniq, inv, counts = np.unique(keys, return_inverse=True, return_counts=True)
        m = len(uniq)
        out_pos = np.zeros((m, 3), pos.dtype)
        for d in range(3):
            out_pos[:, d] = np.bincount(inv, weights=pos[:, d], minlength=m) / counts
        out = {}
        for k, v in attrs.items():
            if k in INTEGER_LABEL_KEYS:
                vmin = v.min()
                shifted = (v - vmin).astype(np.int64)
                nl = shifted.max() + 1
                onehot_counts = np.zeros((m, nl), np.int64)
                np.add.at(onehot_counts, (inv, shifted), 1)
                out[k] = (np.argmax(onehot_counts, 1) + vmin).astype(v.dtype)
            elif np.issubdtype(v.dtype, np.floating):
                if v.ndim == 1:
                    out[k] = (
                        np.bincount(inv, weights=v, minlength=m) / counts
                    ).astype(v.dtype)
                else:
                    o = np.zeros((m,) + v.shape[1:], v.dtype)
                    for d in range(v.shape[1]):
                        o[:, d] = np.bincount(inv, weights=v[:, d], minlength=m) / counts
                    out[k] = o
            else:
                # non-label ints (e.g. origin_id): first occurrence
                first = np.zeros(m, np.int64)
                seen = np.zeros(m, bool)
                for i, c in enumerate(inv):
                    if not seen[c]:
                        seen[c] = True
                        first[c] = i
                out[k] = v[first]
        if return_cluster:
            return out_pos, out, inv
        return out_pos, out
    raise ValueError(f"unknown mode {mode}")
