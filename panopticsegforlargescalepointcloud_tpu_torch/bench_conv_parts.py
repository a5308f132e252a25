"""Where a sparse conv's time goes: kernel A's body timed part by part
(kernel E, ``ops/conv_parts.py``) on the card.

    python3 -m panopticsegforlargescalepointcloud_tpu_torch.bench_conv_parts

The counterpart of the JAX package's TPU probe
``scripts/bench_winkernel_parts.py``. It builds the flagship hierarchy
(``flagship.build_inputs``: 4 synthetic tiles in 131,072 rows) and times
each part of A's body with CUDA events at two shapes, in bf16 and f32: the
probe's own shape, the L0 same-level map at 16 -> 16 channels, and A's
slowest main-path shape, the L1 -> L0 up conv at 64 -> 64 (no ``contig``
part there: it needs a same-level map). Per part it prints ms per call
(calls back to back, ``bench_conv.cuda_ms``), device ms (calls queued
behind a device sleep), ns per (tile, offset) and the part's bound (bytes
over 3.35 TB/s, or operations over the type's peak where that is larger),
one JSON object per line, after the card's name and power limit. A (tile, offset) is one of A's
row tiles x Cout tiles (``ops/conv.py:conv_plan``) x 27 offsets. Needs a
CUDA device.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List

import torch

from .bench_conv import HBM_BPS, PEAK_FLOPS, card_line, cuda_ms
from .ops.conv import conv_plan
from .ops.conv_parts import PARTS, sparse_conv_part
from .ops.hierarchy import build_hierarchy

def shapes(hier, f: int = 16):
    """(label, map, Cin, Cout, N_in, same-level) of the two timed convs."""
    g = hier.grids
    return [
        (f"L0 same {f}->{f}", hier.same_maps[0], f, f, g[0].capacity, True),
        (f"L1->L0 up {4 * f}->{4 * f}", hier.up_maps[0], 4 * f, 4 * f, g[1].capacity, False),
    ]


def part_bound(part: str, n_in: int, idx: torch.Tensor, cin: int, cout: int,
               dtype: torch.dtype):
    """(bound ms, "bytes" | "operations"): each input read once, each output
    written once; the operations those inputs need (2 per multiply-add)."""
    esz = torch.finfo(dtype).bits // 8
    n_out, kvol = idx.shape
    nnz = int(((idx >= 0) & (idx < n_in)).sum())
    nbytes = idx.numel() * 4
    ops = 0.0
    if part == "index":
        nbytes += n_out * 4
    elif part == "gather":
        nbytes += n_in * cin * esz + n_out * cin * 4
        ops = float(nnz * cin)
    else:
        nbytes += n_in * cin * esz + kvol * cin * cout * esz + n_out * cout * 4
        ops = 2.0 * nnz * cin * cout
    t_b, t_o = nbytes / HBM_BPS * 1e3, ops / PEAK_FLOPS[dtype] * 1e3
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def run(hier, f: int = 16, seed: int = 0, iters: int = 20) -> List[Dict]:
    """Time every part at both shapes (base width ``f``), bf16 and f32: one
    record per (shape, dtype, part)."""
    dev = hier.same_maps[0].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    recs = []
    for label, nbr, cin, cout, n_in, same in shapes(hier, f):
        n_out = nbr.shape[0]
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn((n_in, cin), generator=gen, device=dev).to(dt)
            w = (torch.randn((27, cin, cout), generator=gen, device=dev) * 0.2).to(dt)
            for part in PARTS:
                if part == "contig" and not same:
                    continue
                fn = lambda: sparse_conv_part(part, x, nbr, w)  # noqa: E731
                ms = cuda_ms(fn, iters=iters, warmup=3)
                device_ms = cuda_ms(fn, iters=iters, warmup=3, queued=True)
                # (row tile, Cout tile, offset) triples of A's plan in this dtype
                plan = conv_plan(n_out, cin, cout, nbr.shape[1], dt)
                ny = plan.n_tiles if part in ("full", "contig") else 1
                tile_offsets = -(-n_out // plan.bm) * ny * nbr.shape[1]
                bound, by = part_bound(part, n_in, nbr, cin, cout, dt)
                recs.append(dict(shape=label, dtype=str(dt).split(".")[-1], part=part,
                                 n_out=n_out, ms=ms, device_ms=device_ms,
                                 ns_per_tile_offset=ms * 1e6 / tile_offsets,
                                 bound_ms=bound, bound_by=by))
    return recs


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_conv_parts: needs a CUDA device", file=sys.stderr)
        return 2
    from .flagship import build_inputs, flagship_config
    from .train.step import canonicalize

    print(card_line(), flush=True)
    cfg = flagship_config()
    db = canonicalize(*build_inputs())
    hier = build_hierarchy(db.grid, cfg.num_down)
    for rec in run(hier, cfg.in_feat):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
