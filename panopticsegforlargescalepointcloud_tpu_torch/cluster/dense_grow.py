"""Dense min-label pull: connected components of the exact radius graph.

Counterpart of the JAX package's ``cluster/dense_grow.py``. Distances come
in matmul form from [8, T] operands (:func:`_operands`); one pull gives each
row the min label over its in-radius same-id rows. On a CUDA tensor
:func:`min_pull` launches ``csrc/dense_pull.cu``; on a CPU tensor it runs
:func:`min_pull_plain`, the ``min_pull_xla`` math. The pointer jumping and
the convergence loop of :func:`dense_components` stay in PyTorch.
"""

from __future__ import annotations

import torch

from .. import _cuda

KERNEL = _cuda.Kernel(
    "dense_pull",
    "pst_dense_pull",
    [_cuda.PTR, _cuda.PTR, _cuda.PTR, _cuda.PTR, _cuda.PTR, _cuda.INT, _cuda.FLOAT, _cuda.PTR],
    source="panopticsegforlargescalepointcloud_tpu_torch/csrc/dense_pull.cu",
    replaces="panopticsegforlargescalepointcloud_tpu/cluster/dense_grow.py:77",
)

_BQ = 256
_BS = 2048
_PLAIN_ROWS = 1024  # query rows per step of min_pull_plain
_INF = float("inf")


def supports_dense(t: int) -> bool:
    """The compacted row count must tile evenly (as in the JAX package)."""
    return t >= _BS and t % _BQ == 0 and t % _BS == 0


def _operands(pos: torch.Tensor, valid: torch.Tensor):
    """[8, T] operands: qmat rows (-2x, -2y, -2z, 1, qn, 0, 0, 0), smat rows
    (x, y, z, pn, 1, 0, 0, 0); invalid rows carry +inf norms."""
    x = pos.float()
    n2 = (x * x).sum(dim=1)
    n2 = torch.where(valid, n2, torch.full_like(n2, _INF))
    one = torch.ones_like(n2)
    zero = torch.zeros_like(n2)
    qmat = torch.stack([-2 * x[:, 0], -2 * x[:, 1], -2 * x[:, 2], one, n2, zero, zero, zero])
    smat = torch.stack([x[:, 0], x[:, 1], x[:, 2], n2, one, zero, zero, zero])
    return qmat.contiguous(), smat.contiguous()


def min_pull_plain(qmat, smat, ids, labels, r2: float) -> torch.Tensor:
    """One pull in plain PyTorch, a chunk of query rows at a time. d2 is
    summed term by term over the 8 operand rows, with separate multiplies
    and adds: the kernel's 5-term sum rounds the same (see min_pull)."""
    t = ids.shape[0]
    out = torch.empty(t, dtype=torch.float32, device=qmat.device)
    for r0 in range(0, t, _PLAIN_ROWS):
        r1 = min(t, r0 + _PLAIN_ROWS)
        q = qmat[:, r0:r1]
        d2 = q[0][:, None] * smat[0][None, :]
        for r in range(1, 8):
            d2 = d2 + q[r][:, None] * smat[r][None, :]
        ok = (d2 <= r2) & (ids[r0:r1, None] == ids[None, :])
        out[r0:r1] = torch.where(ok, labels[None, :], _INF).amin(dim=1)
    return out


def min_pull(qmat, smat, ids, labels, r2: float) -> torch.Tensor:
    """qmat, smat [8, T] f32 in the layout of :func:`_operands`, ids [T]
    int32, labels [T] f32 -> [T] f32 min neighbor label (+inf where none,
    including invalid rows). The kernel relies on that layout: it reads
    q rows 0-2 and 4 and s rows 0-3, since the other products are x * 1 and
    0 * 0, which round the 8-term sum no differently."""
    t = ids.shape[0]
    if qmat.shape != (8, t) or smat.shape != (8, t) or labels.shape != (t,):
        raise ValueError("min_pull: operands must be [8, T] and ids, labels [T]")
    if qmat.device.type == "cpu":
        return min_pull_plain(qmat, smat, ids, labels, r2)
    if not (qmat.dtype == smat.dtype == labels.dtype == torch.float32) or ids.dtype != torch.int32:
        raise TypeError("min_pull takes f32 operands and labels and int32 ids")
    if not all(a.device == qmat.device for a in (smat, ids, labels)):
        raise ValueError("min_pull operands must be on one device")
    if not all(a.is_contiguous() for a in (qmat, smat, ids, labels)):
        raise ValueError("min_pull needs contiguous operands")
    out = torch.empty(t, dtype=torch.float32, device=qmat.device)
    KERNEL(qmat.data_ptr(), smat.data_ptr(), ids.data_ptr(), labels.data_ptr(),
           out.data_ptr(), t, float(r2), _cuda.stream_ptr(qmat.device))
    return out


def dense_components(pos, ids, valid, radius: float, init_labels, max_iters: int = 64):
    """Connected components of the same-id radius graph by dense pulls and
    pointer jumping, from ``init_labels`` (cell_seed_labels contract).
    Returns int32 labels, each component carrying its min member row. The
    loop checks convergence on the host once per iteration."""
    t = pos.shape[0]
    qmat, smat = _operands(pos, valid)
    ids = ids.to(torch.int32).contiguous()
    r2 = float(radius) * float(radius)
    fill_t = torch.full((1,), t, dtype=torch.int32, device=pos.device)

    def pull(lab_i32):
        got = min_pull(qmat, smat, ids, lab_i32.float().contiguous(), r2)
        got_i32 = torch.where(torch.isfinite(got), got, float(t)).to(torch.int32)
        new = torch.minimum(lab_i32, got_i32)
        new = torch.where(valid, new, fill_t)
        for _ in range(3):
            ext = torch.cat([new, fill_t])
            new = torch.minimum(new, ext[new.clamp(max=t).long()])
        return new

    labels = init_labels.to(torch.int32)
    for _ in range(max_iters):
        new = pull(pull(labels))
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    return labels
