"""Instance label preparation (set_extra_labels semantics). A copy of the
JAX package's ``data/labels.py``.

Port of upstream ``torch_points3d/datasets/panoptic/utils.py:4-49``:
per tile, instances whose semantic class is a thing get compact ids 1..K,
bbox-center vote targets (center - pos), and an instance mask; computed
*after* geometric augmentation so votes match the augmented geometry.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def set_extra_labels(
    pos: np.ndarray,
    y: np.ndarray,
    raw_instance_labels: np.ndarray,
    thing_classes: Sequence[int],
    num_max_objects: int = 64,
) -> Dict[str, np.ndarray]:
    """Returns instance_labels (compact), vote_label, num_instances."""
    n = len(pos)
    vote = np.zeros((n, 3), np.float32)
    compact = np.zeros(n, np.int32)
    thing_set = set(int(c) for c in thing_classes)
    next_id = 1
    for inst in np.unique(raw_instance_labels):
        ind = np.where(raw_instance_labels == inst)[0]
        if ind.size == 0:
            continue
        # reference keys on the first point's semantic class (utils.py:26)
        cls = int(y[ind[0]])
        if cls not in thing_set:
            continue
        p = pos[ind]
        center = 0.5 * (p.min(0) + p.max(0))
        vote[ind] = center - p
        compact[ind] = next_id
        next_id += 1
    num = next_id - 1
    if num > num_max_objects:
        raise ValueError(
            f"{num} instances > NUM_MAX_OBJECTS={num_max_objects}; raise the cap"
        )
    return dict(
        instance_labels=compact,
        vote_label=vote,
        num_instances=num,
    )
