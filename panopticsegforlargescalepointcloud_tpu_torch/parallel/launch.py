"""Start the ranks of a data-parallel mesh: one process per device entry.

The JAX package drives a device list from one controller; the port runs one
process per entry of the list instead (``torch.distributed``), and this
module starts them:

* :func:`spawn` starts one process per entry (start method ``spawn``),
  joins them through a ``FileStore`` in a temporary directory, gives each
  its rank's device and process group (``init_process_group`` with a
  timeout, so that a rank left waiting ends in an error), calls
  ``fn(mesh, *args)`` in each and returns the ranks' return values. If any
  rank raises, the others are stopped and :func:`spawn` raises.
* :func:`from_env` joins the group that ``torchrun`` describes
  (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) in the
  calling process.
* :func:`visible_devices` is the CLIs' device list for ``num_devices``: as
  many cards as asked, refused beyond the visible ones, or as many CPU
  ranks as asked.

The backend follows from the device list before the group starts
(:func:`backend_for`): ``nccl`` when every rank has a card of its own,
``gloo`` for CPU ranks and for ranks that share a card. Nothing retries
another backend after a failure.
"""

from __future__ import annotations

import datetime
import logging
import os
import shutil
import tempfile
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist

from ..device import resolve_device
from .mesh import Mesh, make_mesh

log = logging.getLogger(__name__)

# how long a rank waits in a collective (or at the rendezvous) before the
# group raises: long enough for rank 0's validation while the others wait
DEFAULT_TIMEOUT_S = 1800.0


def normalize(devices: Sequence) -> List[torch.device]:
    """``torch.device`` per entry; a bare ``cuda`` means ``cuda:0``."""
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", 0)
        out.append(d)
    if not out:
        raise ValueError("a mesh needs at least one device")
    return out


def backend_for(devices: Sequence) -> str:
    """``nccl`` when every rank has a card of its own, else ``gloo`` (CPU
    ranks, or ranks that share a card: NCCL refuses two ranks on one GPU)."""
    devs = normalize(devices)
    if all(d.type == "cuda" for d in devs) and len({d.index for d in devs}) == len(devs):
        return "nccl"
    return "gloo"


def visible_devices(num_devices: int, device=None) -> List[torch.device]:
    """The device list of ``num_devices`` ranks on ``device``'s type (the
    GPU unless ``device="cpu"``): on the GPU the first ``num_devices``
    cards, 0 meaning every visible card, more than are visible refused; on
    the CPU ``num_devices`` CPU ranks (0 meaning one)."""
    dev = resolve_device(device)
    nd = int(num_devices)
    if dev.type != "cuda":
        return [torch.device("cpu")] * max(nd, 1)
    count = torch.cuda.device_count()
    nd = count if nd == 0 else nd
    if nd > count:
        raise RuntimeError(f"num_devices={nd} but only {count} CUDA devices are visible")
    return [torch.device("cuda", i) for i in range(nd)]


def in_torchrun() -> bool:
    """Whether the environment describes a ``torchrun`` rank."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def _init(devices: List[torch.device], rank: int, timeout_s: float, store=None) -> Mesh:
    kwargs = dict(backend=backend_for(devices), rank=rank, world_size=len(devices),
                  timeout=datetime.timedelta(seconds=timeout_s))
    if store is not None:
        kwargs["store"] = store
    else:
        kwargs["init_method"] = "env://"
    dist.init_process_group(**kwargs)
    return make_mesh(devices)


def from_env(devices: Sequence, timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """Join the process group ``torchrun`` describes; this process is rank
    ``RANK`` of ``len(devices)`` (which must equal ``WORLD_SIZE``)."""
    devs = normalize(devices)
    world = int(os.environ["WORLD_SIZE"])
    if world != len(devs):
        raise ValueError(f"WORLD_SIZE={world} but {len(devs)} devices were asked for")
    return _init(devs, int(os.environ["RANK"]), timeout_s)


def _rank_entry(rank: int, fn: Callable, devices, store_dir: str, timeout_s: float,
                threads: int, args: tuple) -> None:
    logging.basicConfig(level=logging.INFO,
                        format=f"%(asctime)s [rank {rank}] %(message)s")
    if devices[rank].type == "cpu":
        # CPU ranks share the caller's cores
        torch.set_num_threads(max(1, threads // len(devices)))
    store = dist.FileStore(os.path.join(store_dir, "store"), len(devices))
    mesh = _init(devices, rank, timeout_s, store)
    try:
        result = fn(mesh, *args)
        torch.save(result, os.path.join(store_dir, f"result_{rank}.pt"))
    finally:
        shutdown()


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def spawn(fn: Callable[..., Any], devices: Sequence, *args,
          timeout_s: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """Run ``fn(mesh, *args)`` in one new process per entry of ``devices``
    and return the ranks' return values in rank order (each passed back
    through ``torch.save``). ``fn`` and ``args`` are pickled: ``fn`` must be
    importable (a module-level function). Raises when any rank raises or
    dies; the other ranks are then stopped."""
    import torch.multiprocessing as mp

    devs = normalize(devices)
    for d in devs:
        resolve_device(d)
    store_dir = tempfile.mkdtemp(prefix="pst_mesh_")
    try:
        log.info("starting %d ranks on %s (%s)", len(devs), [str(d) for d in devs],
                 backend_for(devs))
        mp.start_processes(_rank_entry, nprocs=len(devs), join=True, start_method="spawn",
                           args=(fn, devs, store_dir, timeout_s, torch.get_num_threads(),
                                 args))
        # written by this call's ranks only
        return [torch.load(os.path.join(store_dir, f"result_{r}.pt"), weights_only=False)
                for r in range(len(devs))]
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
