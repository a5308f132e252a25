"""Seeded weights, drawn on the device in a few large calls and handed to
the program and the reference alike.

Two schemes, by the parameter's last name part:

* ``init`` (the start of training, as the port's ``init_params`` draws its
  distributions): conv kernels [27, Cin, Cout] normal with std
  sqrt(2 / (27 Cout)); dense weights [out, in] std sqrt(1 / in), the
  ResBlock 1x1 shortcuts (``Dense_0`` beside a ``MaskedBatchNorm_0``) std
  sqrt(2 / out); biases 0; BN scale 1, bias 0, running mean 0, var 1.
* ``serve`` (a served model whose BN statistics are not the identity, as
  ``flagship.random_model``): the same weight stds; biases normal with std
  0.1; BN scale 1 + 0.1 n; running mean 0.1 n, var 0.5 + U[0, 1).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def _std(name: str, shape: Tuple[int, ...], shortcuts: set) -> float:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "kernel":
        return math.sqrt(2.0 / (shape[0] * shape[2]))
    if leaf == "weight":
        if name.rsplit(".", 1)[0] in shortcuts:
            return math.sqrt(2.0 / shape[0])
        return math.sqrt(1.0 / shape[1])
    return 0.0


def draw_state(shapes: List[Tuple[str, Tuple[int, ...]]], seed: int, scheme: str,
               device) -> Dict[str, torch.Tensor]:
    """A state dict {name: f32 tensor on ``device``} for the parameters and
    buffers ``shapes`` (name, shape), in their order, from a
    ``torch.Generator`` on ``device`` seeded with ``seed``: one normal draw
    and one uniform draw over all entries."""
    if scheme not in ("init", "serve"):
        raise ValueError(f"unknown weight scheme {scheme!r}")
    names = [n for n, _ in shapes]
    shortcuts = {n.rsplit(".", 1)[0] for n in names
                 if n.endswith("Dense_0.weight")
                 and n.rsplit(".", 2)[0] + ".MaskedBatchNorm_0.scale" in names}
    sizes = [math.prod(s) for _, s in shapes]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    uniform = torch.rand(sum(sizes), generator=gen, device=device)
    out, start = {}, 0
    for (name, shape), size in zip(shapes, sizes):
        n = normal[start:start + size].view(shape)
        u = uniform[start:start + size].view(shape)
        start += size
        leaf = name.rsplit(".", 1)[-1]
        serve = scheme == "serve"
        if leaf in ("kernel", "weight"):
            t = n * _std(name, shape, shortcuts)
        elif leaf == "bias":
            t = 0.1 * n if serve else torch.zeros_like(n)
        elif leaf == "scale":
            t = 1.0 + 0.1 * n if serve else torch.ones_like(n)
        elif leaf == "mean":
            t = 0.1 * n if serve else torch.zeros_like(n)
        elif leaf == "var":
            t = 0.5 + u if serve else torch.ones_like(n)
        else:
            raise ValueError(f"no draw for {name}")
        out[name] = t.clone()
    return out


def state_shapes(model: torch.nn.Module) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every parameter and floating buffer of ``model``."""
    return [(n, tuple(t.shape)) for n, t in model.state_dict().items()
            if t.is_floating_point()]
