"""Geometry helpers (reference ``utils/geometry.py`` / ``utils/box_utils.py``:
rodrigues rotation, axis-aligned box volume/IoU). A copy of the JAX
package's ``utils/geometry.py``."""

from __future__ import annotations

import numpy as np


def rodrigues(axis: np.ndarray, theta: float) -> np.ndarray:
    """Rotation matrix about ``axis`` by ``theta`` radians."""
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    k = np.array(
        [
            [0, -axis[2], axis[1]],
            [axis[2], 0, -axis[0]],
            [-axis[1], axis[0], 0],
        ]
    )
    return np.eye(3) + np.sin(theta) * k + (1 - np.cos(theta)) * (k @ k)


def box_volume(box: np.ndarray) -> float:
    """box = [xmin, ymin, zmin, xmax, ymax, zmax]."""
    d = np.maximum(box[3:] - box[:3], 0)
    return float(d.prod())


def box_iou(a: np.ndarray, b: np.ndarray) -> float:
    lo = np.maximum(a[:3], b[:3])
    hi = np.minimum(a[3:], b[3:])
    inter = float(np.maximum(hi - lo, 0).prod())
    union = box_volume(a) + box_volume(b) - inter
    return inter / union if union > 0 else 0.0


def instance_boxes(pos: np.ndarray, instance_labels: np.ndarray) -> dict:
    """Axis-aligned bbox per instance id (> 0)."""
    out = {}
    for g in np.unique(instance_labels):
        if g <= 0:
            continue
        p = pos[instance_labels == g]
        out[int(g)] = np.concatenate([p.min(0), p.max(0)])
    return out
