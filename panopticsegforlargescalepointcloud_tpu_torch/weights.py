"""Carry weights from the JAX package's flax trees into the port's model.

The port's module names mirror the flax names, so the map is a rename:
``backbone/down_0/ConvBNReLU_0/SparseConv_0/kernel`` becomes
``backbone.down_0.ConvBNReLU_0.SparseConv_0.kernel``. Two kinds of leaf
change form: a 2-D ``kernel`` (``nn.Dense``: heads, MLPs, 1x1 shortcuts,
also where it is applied to [Q, M, C] groups) is stored [in, out] by flax
and becomes the transposed ``weight`` of an ``nn.Linear``; a 3-D ``kernel``
([27, Cin, Cout] sparse conv, [P, Cin, Cout] KPConv) stays as is, as do the
deformable KPConv's ``offset_kernel`` and ``offset_bias``.
``batch_stats`` ``mean``/``var`` become the MaskedBatchNorm buffers.
:func:`flax_paths` is the inverse, for a state_dict or for gradients.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

# parameter leaves that keep their flax form
_LEAVES = ("kernel", "bias", "scale", "offset_kernel", "offset_bias")


def _flatten(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        path = prefix + (str(k),)
        if isinstance(v, Mapping):
            yield from _flatten(v, path)
        else:
            yield path, v


def params_from_flax(params: Mapping[str, Any], batch_stats: Mapping[str, Any]
                     ) -> Dict[str, torch.Tensor]:
    """Nested dicts of numpy arrays (flax ``params`` and ``batch_stats``) ->
    the port model's ``state_dict``."""
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params):
        arr = np.asarray(leaf, dtype=np.float32)
        name = path[-1]
        if name == "kernel" and arr.ndim == 2:
            arr, name = arr.T, "weight"
        elif name not in _LEAVES:
            raise KeyError(f"unexpected flax parameter {'/'.join(path)}")
        sd[".".join(path[:-1] + (name,))] = torch.from_numpy(np.array(arr, order="C", copy=True))
    for path, leaf in _flatten(batch_stats):
        if path[-1] not in ("mean", "var"):
            raise KeyError(f"unexpected flax batch stat {'/'.join(path)}")
        sd[".".join(path)] = torch.from_numpy(np.array(leaf, dtype=np.float32, copy=True))
    return sd


def flax_paths(tensors: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of :func:`params_from_flax` for any name -> tensor map (a
    ``state_dict``, or ``{name: p.grad}``): flax paths joined by ``/``
    (``backbone/down_0/.../kernel``) -> f32 numpy arrays, with ``nn.Linear``
    weights transposed back into flax ``kernel``s. BN buffers keep their
    ``mean``/``var`` leaf names (the flax ``batch_stats`` paths)."""
    out: Dict[str, np.ndarray] = {}
    for name, t in tensors.items():
        path = name.split(".")
        arr = t.detach().float().cpu().numpy()
        if path[-1] == "weight":
            if arr.ndim != 2:
                raise KeyError(f"unexpected weight {name} of shape {arr.shape}")
            arr, path[-1] = arr.T, "kernel"
        elif path[-1] not in _LEAVES + ("mean", "var"):
            raise KeyError(f"unexpected tensor {name}")
        out["/".join(path)] = np.ascontiguousarray(arr)
    return out
