"""Operations and bytes of kernel C's work (flat-kernel mean shift) on the
operands of one call, from the benchmark's own plain loop.

Beside :mod:`.counts`, and like it independent of the program's outputs:
the operands are rebuilt from recorded heads by the plain reference
(:func:`.reference.embed.model.ms_operands`), the seeds are the plain
copy's bins, and each seed's iterations are those that the plain loop
(``meanshift_converge_plain``) takes, never the kernel's own count. Each
valid seed makes one pass over its sample's valid points per update and
one more for its count at the returned position; a pass over a point
costs the distance's E multiplies and E adds (the squared norms taken once
a point and once a seed), the least any flat-kernel loop does. The bytes
are each valid point read once (E f32 and its flag), each valid seed read
and written once (E f32 each way) and its count and iterations written.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .reference.plain.cluster.meanshift import _bin_seeds, meanshift_converge_plain

F32_PEAK_FLOPS = 67e12  # f32 non-tensor, one H100 SXM (NVIDIA's data sheet)


class MeanShiftWork(NamedTuple):
    ops: float
    bytes: float
    points: list  # valid points a sample
    seeds: list  # valid seeds a sample
    passes: list  # passes over the points a sample, summed over its seeds


def work(x: torch.Tensor, valid: torch.Tensor, cols: torch.Tensor, bandwidth: float,
         max_seeds: int, max_iter: int = 100) -> MeanShiftWork:
    """The work of one call on x [B, Np, D] (the loop runs on the columns
    ``cols`` [B, E]), valid [B, Np]."""
    b, np_, _ = x.shape
    e = cols.shape[1]
    x = x.float().contiguous()
    seeds, svalid = _bin_seeds(x, valid, bandwidth, max_seeds)
    xs = torch.gather(x, 2, cols[:, None, :].expand(b, np_, e)).contiguous()
    ss = torch.gather(seeds, 2, cols[:, None, :].expand(b, seeds.shape[1], e)).contiguous()
    _, _, iters = meanshift_converge_plain(ss, svalid, xs, valid, bandwidth, max_iter)
    points = valid.sum(dim=1).double()
    nseeds = svalid.sum(dim=1).double()
    passes = ((iters.double() + 1.0) * svalid.double()).sum(dim=1)
    ops = float((2.0 * e * points * passes).sum())
    nbytes = float((points * (4 * e + 1) + nseeds * (2 * 4 * e + 8)).sum())
    return MeanShiftWork(ops, nbytes, points.tolist(), nseeds.tolist(), passes.tolist())


def bound_s(w: MeanShiftWork, peak_flops: float, peak_bytes_s: float) -> float:
    """The least time of the work: the larger of its operations at the
    peak and its bytes at the memory's bandwidth."""
    return max(w.ops / peak_flops, w.bytes / peak_bytes_s)
