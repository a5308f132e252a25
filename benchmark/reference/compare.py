"""Gaps between the program's training numbers and the reference's:
the step losses' relative gap, and each leaf's gap between the norms of
the first gradient (the program's read back from its Adam state) or of
the parameters' change over the first steps, against the larger of the
reference's norm of that leaf and of the median leaf's."""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch


def loss_gap(prog: Iterable[float], ref: Iterable[float]) -> float:
    return max(abs(p - r) / max(abs(r), 1e-12) for p, r in zip(prog, ref))


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in leaves.items()}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep: Optional[set] = None) -> Dict[str, float]:
    """Each leaf's gap |‖p‖ - ‖r‖| / max(‖r‖, the median leaf's ‖r‖), over
    the leaves of ``keep`` (all where None)."""
    if set(prog) != set(ref):
        raise ValueError("the program's and the reference's leaves differ")
    pn, rn = _norms(prog), _norms(ref)
    names = [k for k in rn if keep is None or k in keep]
    med = float(np.median([rn[k] for k in names]))
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in names}


def moved_leaves(ref_grad: Dict[str, torch.Tensor], share: float = 1e-3) -> set:
    """The leaves whose first gradient in the reference reaches ``share``
    of the median leaf's norm; the others move under Adam by round-off."""
    rn = _norms(ref_grad)
    med = float(np.median(list(rn.values())))
    return {k for k, v in rn.items() if v >= share * med}
