"""Data-parallel training and serving over ``torch.distributed``.

Counterpart of the JAX package's ``parallel/mesh.py``. There a ``shard_map``
over a device mesh gives each device one [1, ...] block of the [D, ...]
batch; here each rank is a process of its own (started by
:mod:`.launch`), holds a full replica of the model and takes its block
with :func:`shard_batch`. The only communication is the train step's one
all-reduce and the serving path's gather of each tile's outputs to rank 0.

The train step (:func:`make_parallel_train_step`) computes what the JAX
mesh step computes:

1. each rank's loss gradients on its own block (the single-device step's
   forward, losses and backward; a parameter off the phase's path gets a
   zero gradient, as under ``jax.grad``);
2. one all-reduce (sum) of one flat buffer holding every gradient, the
   new BN running statistics and the losses, then a division by D: the
   ``pmean`` of the gradients, of the BN statistics (each rank still
   normalizes with its own batch's moments: this is not sync-BN) and of
   the losses;
3. the elementwise clip to +-``grad_clip_value`` after the mean;
4. the optimizer update (with ``grad_accum`` k > 1 optax ``MultiSteps``
   over the mean gradients).

Like the JAX mesh step it passes no subset counter to the forward: the
embed family's random-subset ops draw their fixed subsets (the
single-device step passes the mini-batch count). Every rank does the same
arithmetic on the same all-reduced values, so the replicas stay bit
identical (:func:`replica_checksum`).

Explicit collectives rather than ``DistributedDataParallel``: DDP copies
rank 0's BN buffers where the JAX step averages them, needs
``find_unused_parameters`` for the prepare step's idle ScoreNet, and hides
the order of mean, clip and update in its gradient buckets.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..eval.extract import dispatch_outputs, pull
from ..models.norm import MaskedBatchNorm
from ..models.pointgroup3heads import PanopticConfig, PointGroup3HeadsNet
from ..train.optim import Schedule, optimizer_step
from ..train.step import make_eval_forward, make_loss_and_grads
from ..utils import trace


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel group (the default process
    group): the device of every rank, this rank and the backend."""

    devices: Tuple[torch.device, ...]
    rank: int
    backend: str

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        return self.devices[self.rank]

    @property
    def is_root(self) -> bool:
        return self.rank == 0


def make_mesh(devices: Sequence) -> Mesh:
    """The mesh of a started group (:func:`.launch.spawn`, ``torchrun``):
    one device entry per rank, this process's being ``devices[rank]``."""
    from .launch import normalize

    devs = tuple(normalize(devices))
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a started process group: run in the ranks of "
                           "parallel.launch.spawn (or torchrun)")
    if dist.get_world_size() != len(devs):
        raise ValueError(f"{len(devs)} devices for a group of {dist.get_world_size()} ranks")
    rank = dist.get_rank()
    dev = resolve_device(devs[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(devs, rank, str(dist.get_backend()))


# ---------------------------------------------------------------- collectives


def _host_staged(mesh: Mesh, t: torch.Tensor) -> bool:
    # gloo's collectives run on host buffers: a card's tensor goes through
    # one explicit copy each way
    return mesh.backend == "gloo" and t.device.type != "cpu"


def all_reduce_sum_(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place; every rank gets the same bits."""
    if _host_staged(mesh, t):
        host = t.cpu()
        dist.all_reduce(host)
        t.copy_(host)
    else:
        dist.all_reduce(t)
    return t


def broadcast_(mesh: Mesh, t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank, in place."""
    if _host_staged(mesh, t):
        host = t.cpu()
        dist.broadcast(host, src)
        t.copy_(host)
    else:
        dist.broadcast(t, src)
    return t


def gather_to_root(mesh: Mesh, obj):
    """Every rank's ``obj`` (picklable, on the host) as a list in rank order
    on rank 0; None on the other ranks."""
    out = [None] * mesh.size if mesh.is_root else None
    dist.gather_object(obj, out, dst=0)
    return out


def broadcast_object(mesh: Mesh, obj, src: int = 0):
    """Rank ``src``'s ``obj`` (picklable) on every rank."""
    box = [obj if mesh.rank == src else None]
    dist.broadcast_object_list(box, src)
    return box[0]


# -------------------------------------------------------------------- replicas


def bn_statistics(model: torch.nn.Module) -> List[torch.Tensor]:
    """The BN running statistics (every ``MaskedBatchNorm``'s ``mean`` and
    ``var``), in module order."""
    return [b for m in model.modules() if isinstance(m, MaskedBatchNorm)
            for b in (m.mean, m.var)]


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).float() for t in tensors])


def _unflat_(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    ofs = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[ofs:ofs + n].reshape(t.shape))
        ofs += n


@torch.no_grad()
def replicate(mesh: Mesh, model: torch.nn.Module) -> torch.nn.Module:
    """Move ``model`` to this rank's device and overwrite its parameters and
    buffers with rank 0's (one broadcast of one flat buffer)."""
    model.to(mesh.device)
    tensors = list(model.parameters()) + list(model.buffers())
    flat = broadcast_(mesh, _flat(tensors))
    _unflat_(flat, tensors)
    return model


def replica_checksum(model: torch.nn.Module) -> str:
    """SHA-256 of every parameter's and buffer's bytes, in state-dict order:
    equal on every rank while the replicas are bit-identical."""
    h = hashlib.sha256()
    for name, t in model.state_dict().items():
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def shard_batch(mesh: Mesh, stacked) -> Tuple[torch.Tensor, ...]:
    """This rank's block of the [D, ...] arrays (a stacked ``VoxelBatch`` or
    its ``batch_arrays`` tuple), without the leading axis, on this rank's
    device."""
    out = []
    for a in stacked:
        if a.shape[0] != mesh.size:
            raise ValueError(f"a [{a.shape[0]}, ...] array for a mesh of {mesh.size} ranks")
        block = a[mesh.rank]
        if isinstance(block, np.ndarray):
            block = torch.from_numpy(np.ascontiguousarray(block))
        out.append(block.to(mesh.device))
    return tuple(out)


# ------------------------------------------------------------------ train step


def make_parallel_train_step(cfg: PanopticConfig, model: PointGroup3HeadsNet,
                             optimizer: torch.optim.Optimizer, schedule: Schedule, mesh: Mesh,
                             with_clustering: bool, grad_clip_value: float | None = None,
                             class_weights=None, epoch: Optional[int] = None,
                             grad_accum: int = 1, timer: Optional[Callable] = None):
    """``step(arrays, bn_momentum) -> metrics``: this rank's block
    (:func:`shard_batch`) through the single-device step's forward, losses
    and backward, then one all-reduce of the gradients, BN running
    statistics and losses, the clip and the optimizer update (module
    docstring). ``metrics``: every loss term and ``loss``, averaged over
    the ranks, and ``hier_overflow`` summed over them, as 0-dim tensors.
    ``timer(name)`` wraps the single-device step's phases and
    ``all_reduce``."""
    dev = mesh.device
    grads_of = make_loss_and_grads(cfg, model, with_clustering, class_weights, dev, timer,
                                   epoch)
    params = list(model.parameters())
    stats = bn_statistics(model)
    n_mean = sum(p.numel() for p in params) + sum(s.numel() for s in stats)

    def step(arrays, bn_momentum=0.1) -> Dict[str, torch.Tensor]:
        metrics = grads_of(arrays, bn_momentum, None)
        # the loss terms follow from the config, so every rank has the same
        # names; sorted, they lay out the buffer alike everywhere
        names = sorted(metrics)
        with torch.no_grad(), trace.phase(timer, "all_reduce"):
            flat = torch.cat([_flat([p.grad for p in params] + stats),
                              torch.stack([metrics[k].float() for k in names])])
            all_reduce_sum_(mesh, flat)
            mean = flat[:n_mean] / mesh.size
            _unflat_(mean, [p.grad for p in params] + stats)
            reduced = flat[n_mean:]
            out = {k: (reduced[i] if k == "hier_overflow" else reduced[i] / mesh.size)
                   for i, k in enumerate(names)}
        with torch.no_grad(), trace.phase(timer, "optimizer"):
            if grad_clip_value is not None:
                torch.nn.utils.clip_grad_value_(params, grad_clip_value)
            optimizer_step(optimizer, schedule, grad_accum)
        return out

    return step


# ------------------------------------------------------------------ serving


def make_parallel_eval_forward(cfg: PanopticConfig, model: PointGroup3HeadsNet, mesh: Mesh,
                               timer: Optional[Callable] = None):
    """Full-panoptic inference of one tile per rank, clustering and scores
    included, with no communication but the gather of the results:
    ``fwd(arrays, subset_seed) -> outputs``, where ``arrays`` is this rank's
    tile and ``outputs`` is, on rank 0, the list of every rank's host
    outputs in rank order (:func:`..eval.extract.dispatch_outputs`, pulled
    to numpy) and None on the other ranks. A model without a scorer gives
    no ``p_scores``: the host keeps every proposal, as the sequential path
    does with ``scores=None``."""
    local = make_eval_forward(cfg, model, device=mesh.device, timer=timer)

    def fwd(arrays, subset_seed=None):
        db, out = local(arrays, subset_seed=subset_seed)
        return gather_to_root(mesh, pull(dispatch_outputs(db, out)))

    return fwd
