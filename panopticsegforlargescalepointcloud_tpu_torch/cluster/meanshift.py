"""Batched flat-kernel mean shift (counterpart of the JAX package's
``cluster/meanshift.py`` and ``cluster/pallas_meanshift.py``).

sklearn ``MeanShift(bin_seeding=True)`` semantics: seeds are the centers of
the most occupied bandwidth-sized bins; each iteration moves every seed to
the mean of the valid points within the bandwidth (flat kernel) and freezes
it once it moves less than 1e-3 * bandwidth; converged seeds are deduplicated
greedily by population; every point joins its nearest surviving center.

The samples of a batch are one leading dimension. The whole iteration of
every seed of every sample is one launch of ``csrc/meanshift.cu`` on a CUDA
tensor (:func:`meanshift_converge`), or the JAX package's loop around
:func:`shift_iter_plain` (its ``_shift_iter``) on a CPU tensor.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .. import _cuda
from ..ops.scatter import scatter_drop, segment_sum
from ..utils import trace

KERNEL = _cuda.Kernel(
    "meanshift_converge",
    "pst_meanshift_converge",
    [_cuda.PTR] * 7 + [_cuda.INT] * 5 + [_cuda.FLOAT, _cuda.FLOAT, _cuda.PTR],
    source="panopticsegforlargescalepointcloud_tpu_torch/csrc/meanshift.cu",
    replaces="panopticsegforlargescalepointcloud_tpu/cluster/pallas_meanshift.py:30",
)
_MAXE = 8  # largest embedding dimension of the kernel (csrc/meanshift.cu: MAXE)

_PRIMES = (73856093, 19349669, 83492791, 49979693, 86028157, 32452867, 67867967,
           2654435761)
_U32 = 0xFFFFFFFF


class MeanShiftResult(NamedTuple):
    labels: torch.Tensor  # [B, Np] int32 cluster id per point (-1 invalid)
    centers: torch.Tensor  # [B, S, E]
    center_valid: torch.Tensor  # [B, S] bool
    num_clusters: torch.Tensor  # [B] int32


def _sq_norm(v: torch.Tensor) -> torch.Tensor:
    """Sum of squares over the last dim, term by term in dimension order."""
    acc = v[..., 0] * v[..., 0]
    for e in range(1, v.shape[-1]):
        acc = acc + v[..., e] * v[..., e]
    return acc


def _pair_d2(seeds: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[B, S, Np] |s|^2 + |x|^2 - 2 s.x with every product and sum rounded
    separately, in dimension order (as ``csrc/meanshift.cu`` does)."""
    dot = seeds[..., 0][:, :, None] * x[..., 0][:, None, :]
    for e in range(1, seeds.shape[-1]):
        dot = dot + seeds[..., e][:, :, None] * x[..., e][:, None, :]
    return (_sq_norm(seeds)[:, :, None] + _sq_norm(x)[:, None, :]) - 2.0 * dot


def shift_iter_plain(seeds, x, pvalid, bw2: float):
    """One flat-kernel update of seeds [B, S, E] over points [B, Np, E]:
    returns (new seeds, counts [B, S]). The sums are taken in f64 and
    rounded once to f32, as the kernel's are, so that the two agree to the
    bit wherever an f64 sum does not fall on an f32 rounding boundary."""
    within = (_pair_d2(seeds, x) <= bw2) & pvalid[:, None, :]
    w = within.to(torch.float64)
    cnt = within.sum(dim=-1).to(torch.float32)
    new = (w @ x.to(torch.float64)).to(torch.float32) / cnt.clamp(min=1.0)[..., None]
    return torch.where((cnt > 0)[..., None], new, seeds), cnt


def meanshift_converge_plain(seeds, svalid, x, pvalid, bandwidth: float, max_iter: int):
    """The JAX package's loop (``_mean_shift_single``) with
    :func:`shift_iter_plain`, one host check per iteration: each valid,
    unfrozen seed takes the update; a seed whose shift^2 falls below
    (1e-3 bw)^2 keeps that step and freezes; the loop stops at ``max_iter``.
    Returns (seeds, counts at those seeds, updates each seed took [B, S]
    int32)."""
    bw2 = float(bandwidth) * float(bandwidth)
    tol = 1e-3 * float(bandwidth)
    active = svalid.clone()
    iters = torch.zeros(svalid.shape, dtype=torch.int32, device=seeds.device)
    for _ in range(max_iter):
        if not bool(active.any()):
            break
        new, _ = shift_iter_plain(seeds, x, pvalid, bw2)
        shift2 = _sq_norm(new - seeds)
        seeds = torch.where(active[..., None], new, seeds)
        iters = iters + active.to(torch.int32)
        active = active & ~(shift2 < tol * tol)
    _, cnt = shift_iter_plain(seeds, x, pvalid, bw2)
    return seeds, cnt, iters


def meanshift_converge(seeds, svalid, x, pvalid, bandwidth: float, max_iter: int):
    """Every seed's mean-shift loop to its own freeze, in one launch of
    ``csrc/meanshift.cu`` on a CUDA tensor (:func:`meanshift_converge_plain`
    on a CPU tensor). seeds [B, S, E] f32, svalid [B, S] bool, x [B, Np, E]
    f32, pvalid [B, Np] bool -> (seeds [B, S, E], counts [B, S] f32 at the
    returned seeds, iterations [B, S] int32). The kernel keeps a sample's
    points in the shared memory of 8 blocks and raises for more (above
    17,560 points at E = 5)."""
    b, s, e = seeds.shape
    np_ = x.shape[1]
    if (x.shape != (b, np_, e) or pvalid.shape != (b, np_) or svalid.shape != (b, s)
            or max_iter < 0):
        raise ValueError("mean shift: seeds [B,S,E], svalid [B,S], points [B,Np,E], "
                         "pvalid [B,Np], max_iter >= 0")
    if seeds.device.type == "cpu":
        return meanshift_converge_plain(seeds, svalid, x, pvalid, bandwidth, max_iter)
    if seeds.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError("mean shift takes f32 seeds and points")
    if svalid.dtype != torch.bool or pvalid.dtype != torch.bool:
        raise TypeError("mean shift takes bool svalid and pvalid")
    if not all(t.device == seeds.device for t in (svalid, x, pvalid)):
        raise ValueError("mean shift operands must be on one device")
    if not all(t.is_contiguous() for t in (seeds, svalid, x, pvalid)):
        raise ValueError("mean shift needs contiguous operands")
    if not 1 <= e <= _MAXE:
        raise ValueError(f"mean shift: embedding dimension {e} not in 1..{_MAXE}")
    bw2 = float(bandwidth) * float(bandwidth)
    tol = 1e-3 * float(bandwidth)
    out = torch.empty_like(seeds)
    cnt = torch.empty((b, s), dtype=torch.float32, device=seeds.device)
    iters = torch.empty((b, s), dtype=torch.int32, device=seeds.device)
    KERNEL(seeds.data_ptr(), svalid.data_ptr(), x.data_ptr(), pvalid.data_ptr(),
           out.data_ptr(), cnt.data_ptr(), iters.data_ptr(), b, s, np_, e,
           int(max_iter), bw2, tol * tol, _cuda.stream_ptr(seeds.device))
    return out, cnt, iters


def meanshift_update(seeds, x, pvalid, bandwidth: float):
    """One flat-kernel update. seeds [B, S, E] f32, x [B, Np, E] f32, pvalid
    [B, Np] bool -> (new seeds [B, S, E], counts [B, S] f32 at the input
    seeds). On a CUDA tensor: two launches of the converge kernel, one
    iteration for the seeds and none for the counts."""
    b, s, e = seeds.shape
    np_ = x.shape[1]
    if x.shape != (b, np_, e) or pvalid.shape != (b, np_):
        raise ValueError("meanshift_update: seeds [B,S,E], points [B,Np,E], pvalid [B,Np]")
    bw2 = float(bandwidth) * float(bandwidth)
    if seeds.device.type == "cpu":
        return shift_iter_plain(seeds, x, pvalid, bw2)
    svalid = torch.ones((b, s), dtype=torch.bool, device=seeds.device)
    new, _, _ = meanshift_converge(seeds, svalid, x, pvalid, bandwidth, 1)
    _, cnt, _ = meanshift_converge(seeds, svalid, x, pvalid, bandwidth, 0)
    return new, cnt


def _mul_u32(a: torch.Tensor, p: int) -> torch.Tensor:
    """(a * p) mod 2^32 for int64 a in [0, 2^32), without int64 overflow."""
    lo, hi = p & 0xFFFF, p >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _U32


def _bin_seeds(x: torch.Tensor, valid: torch.Tensor, bandwidth: float, s: int):
    """Top-s occupied bins by count, ties to the lower sorted position (as
    ``lax.top_k``). x [B, Np, E] -> (seeds [B, s, E], seed_valid [B, s])."""
    b, np_, e = x.shape
    dev = x.device
    bins = torch.round(x / bandwidth).to(torch.int32).long() & _U32  # uint32 view
    h = torch.zeros((b, np_), dtype=torch.int64, device=dev)
    for d in range(e):
        h = (h + _mul_u32(bins[..., d], _PRIMES[d])) & _U32
    h = torch.where(valid, h, torch.full_like(h, _U32))
    order = torch.argsort(h, dim=1, stable=True)
    sh = torch.gather(h, 1, order)
    first = torch.ones_like(sh, dtype=torch.bool)
    first[:, 1:] = sh[:, 1:] != sh[:, :-1]
    first = first & (sh != _U32)
    run_id = torch.cumsum(first.to(torch.int64), dim=1) - 1
    seg = torch.where(sh != _U32, run_id, torch.full_like(run_id, -1))
    # per-sample segment counts, flattened with a sample offset
    offs = torch.arange(b, device=dev)[:, None] * np_
    flat_seg = torch.where(seg >= 0, seg + offs, torch.full_like(seg, -1)).reshape(-1)
    counts = segment_sum(torch.ones(b * np_, dtype=torch.int32, device=dev), flat_seg,
                         b * np_).reshape(b, np_)
    score = torch.where(first, torch.gather(counts, 1, run_id.clamp(min=0)),
                        torch.full_like(run_id, -1, dtype=torch.int32))
    k = min(s, np_)
    top_score, top_pos = torch.sort(score, dim=1, descending=True, stable=True)
    top_score, top_pos = top_score[:, :k], top_pos[:, :k]
    rep_rows = torch.gather(order, 1, top_pos)
    rep = torch.gather(x, 1, rep_rows[..., None].expand(b, k, e))
    seeds = torch.round(rep / bandwidth) * bandwidth
    seed_valid = top_score > 0
    if s > np_:
        seeds = torch.cat([seeds, seeds.new_zeros((b, s - np_, e))], dim=1)
        seed_valid = torch.cat([seed_valid, seed_valid.new_zeros((b, s - np_))], dim=1)
    return seeds, seed_valid


def _dedup_keep(alive: torch.Tensor, order: torch.Tensor, near: torch.Tensor) -> torch.Tensor:
    """Greedy suppression in population order, on the device: seed j is kept
    when it is alive and no kept seed earlier in ``order`` is near it
    (``near[b, i, j]``: i suppresses j). A seed's decision depends only on
    seeds before it, so the rule has one fixed point, the sequential greedy
    result, and iterating it from ``alive`` settles one more position of
    ``order`` per round. The loop ends at the first round that changes
    nothing (one host check per round: a ``dedup`` host read and an
    ``ms_dedup_rounds`` count, :mod:`..utils.trace`), after at most S
    rounds."""
    b, s = alive.shape
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(s, device=order.device).expand(b, s).contiguous())
    sup = near & (rank[:, :, None] < rank[:, None, :])
    keep = alive
    for _ in range(s):
        new = alive & ~(keep[:, :, None] & sup).any(dim=1)
        trace.count("ms_dedup_rounds")
        with trace.host_read("dedup"):
            same = torch.equal(new, keep)
        if same:
            break
        keep = new
    return keep


def mean_shift(x: torch.Tensor, valid: torch.Tensor, bandwidth: float,
               max_seeds: int = 256, max_iter: int = 100,
               cols: torch.Tensor | None = None) -> MeanShiftResult:
    """Batched mean shift. x [B, Np, E] f32, valid [B, Np] bool.

    Every seed iterates to its own freeze or ``max_iter``
    (:func:`meanshift_converge`); a frozen seed never changes again, so this
    equals running each sample's loop on its own.

    ``cols`` [B, W] int64, when given, names the columns of each sample that
    can be nonzero (index E: a zero column): the seeds are binned in the
    whole space, where the bins' hash weighs each column by its own prime,
    and the loop runs on those W columns only. A zero column adds exactly 0
    to every distance and sum, so the result is the loop's on all E."""
    b, np_, e = x.shape
    dev = x.device
    x = x.float().contiguous()
    bw2 = float(bandwidth) * float(bandwidth)
    seeds, svalid = _bin_seeds(x, valid, bandwidth, max_seeds)
    if cols is None:
        seeds, cnt, _ = meanshift_converge(seeds.contiguous(), svalid.contiguous(), x,
                                           valid.contiguous(), bandwidth, max_iter)
    else:
        w = cols.shape[1]
        pad = lambda t: torch.cat([t, t.new_zeros(t.shape[:-1] + (1,))], dim=-1)  # noqa: E731
        xs = torch.gather(pad(x), 2, cols[:, None, :].expand(b, np_, w)).contiguous()
        ss = torch.gather(pad(seeds), 2, cols[:, None, :].expand(b, seeds.shape[1], w))
        ss, cnt, _ = meanshift_converge(ss.contiguous(), svalid.contiguous(), xs,
                                        valid.contiguous(), bandwidth, max_iter)
        seeds = pad(torch.zeros_like(seeds)).scatter(
            2, cols[:, None, :].expand_as(ss), ss)[..., :e]
    alive = svalid & (cnt >= 1)

    s = seeds.shape[1]
    order = torch.argsort(-torch.where(alive, cnt, torch.full_like(cnt, -1.0)), dim=1,
                          stable=True)
    ss = (seeds * seeds).sum(dim=-1)
    near = (ss[:, :, None] + ss[:, None, :] - 2.0 * (seeds @ seeds.transpose(1, 2))) <= bw2
    with trace.span("ms_dedup"):
        keep = _dedup_keep(alive, order, near)

    keep_o = torch.gather(keep, 1, order)
    rank = torch.cumsum(keep_o.to(torch.int64), dim=1) - 1
    tgt = torch.where(keep_o, rank, torch.full_like(rank, s))
    seeds_o = torch.gather(seeds, 1, order[..., None].expand(b, s, e))
    centers = torch.stack([scatter_drop(s, 0.0, tgt[i], seeds_o[i]) for i in range(b)])
    n_centers = keep.sum(dim=1).to(torch.int32)
    center_valid = torch.arange(s, device=dev)[None, :] < n_centers[:, None]

    xx = (x * x).sum(dim=-1)
    cc = (centers * centers).sum(dim=-1)
    d2_pc = xx[:, :, None] + cc[:, None, :] - 2.0 * (x @ centers.transpose(1, 2))
    d2_pc = torch.where(center_valid[:, None, :], d2_pc, torch.full_like(d2_pc, float("inf")))
    labels = torch.argmin(d2_pc, dim=-1).to(torch.int32)
    labels = torch.where(valid & (n_centers > 0)[:, None], labels, torch.full_like(labels, -1))
    return MeanShiftResult(labels, centers, center_valid, n_centers)


def pack_by_sample(x, batch, mask, num_samples: int, cap: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack masked flat rows into [B, cap] per-sample tensors. Returns (dense
    [B, cap, E], dvalid [B, cap], src_row [B, cap] int32 -1 pad, dropped []
    int32 masked rows past ``cap`` in their sample)."""
    n = x.shape[0]
    dev = x.device
    key = torch.where(mask, batch.long(), torch.full_like(batch, num_samples, dtype=torch.long))
    order = torch.argsort(key, stable=True)
    sb = key[order]
    start = torch.searchsorted(sb, torch.arange(num_samples, device=dev), side="left")
    slot = torch.arange(n, device=dev) - start[sb.clamp(max=num_samples - 1)]
    ok = (sb < num_samples) & (slot < cap)
    flat_tgt = torch.where(ok, sb * cap + slot, torch.full_like(sb, num_samples * cap))
    m = num_samples * cap
    e = x.shape[1]
    dense = scatter_drop(m, 0.0, flat_tgt, x[order])
    dvalid = scatter_drop(m, False, flat_tgt, ok)
    src = scatter_drop(m, -1, flat_tgt, order.to(torch.int32))
    dropped = ((sb < num_samples) & (slot >= cap)).sum().to(torch.int32)
    return (dense.reshape(num_samples, cap, e), dvalid.reshape(num_samples, cap),
            src.reshape(num_samples, cap), dropped)
