"""Sparse convolution ``out[i] = sum_k feats[idx[i, k]] @ W[k]`` and its
gradient.

Counterpart of the JAX package's ``ops/conv.py``: :func:`sparse_conv` with a
transpose map is the custom VJP ``_conv_tm``. Its backward runs through the
transpose map ``idx_t`` (``idx_t[j, K-1-k] = i  <=>  idx[i, k] = j``):

* dX is the same convolution on ``idx_t`` with the flipped, transposed
  weights, so it is kernel A again (``csrc/sparse_conv.cu``), counted apart
  in :data:`KERNEL_DX`;
* dW is ``dW[k] = sum_i feats[idx[i, k]]^T g[i]``, kernel D
  (``csrc/sparse_conv_dw.cu``).

On a CUDA tensor each wrapper launches its kernel; on a CPU tensor it runs
its plain version: :func:`sparse_conv_plain` (the JAX package's ``_apply``:
zero pad row, per-offset gather and GEMM, f32 accumulation) and
:func:`sparse_conv_dw_plain` (``_conv_tm_bwd``'s per-offset ``fk^T @ g``).
Each launch's plan (tile widths, splits, workspace) is a plain function of
the shapes, :func:`conv_plan` and :func:`dw_plan`, and the bf16 operands'
layout check is :func:`check_rows`: all three run on the CPU too. The C
launchers take the plan as given and refuse one their instances cannot
run; each wrapper raises on a refused launch.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import torch

from .. import _cuda

KERNEL = _cuda.Kernel(
    "sparse_conv_fwd",
    "pst_sparse_conv_fwd",
    [_cuda.PTR] * 5 + [_cuda.INT] * 11 + [_cuda.PTR],
    source="panopticsegforlargescalepointcloud_tpu_torch/csrc/sparse_conv.cu",
    replaces="panopticsegforlargescalepointcloud_tpu/ops/winconv.py:307",
)
# kernel A in its backward role (dX on the transpose map): the same entry
# point, launches counted apart from the forward's
KERNEL_DX = _cuda.Kernel(
    "sparse_conv_dx",
    "pst_sparse_conv_fwd",
    KERNEL.argtypes,
    source=KERNEL.source,
    replaces=KERNEL.replaces,
)
KERNEL_DW = _cuda.Kernel(
    "sparse_conv_dw",
    "pst_sparse_conv_dw",
    [_cuda.PTR] * 5 + [_cuda.INT] * 11 + [_cuda.PTR],
    source="panopticsegforlargescalepointcloud_tpu_torch/csrc/sparse_conv_dw.cu",
    replaces="panopticsegforlargescalepointcloud_tpu/ops/winconv.py:343",
)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_SMS = 132  # streaming multiprocessors of the H100 SXM the plans are tuned for
# The bf16 tensor-core kernels' tiles (csrc/sparse_conv_tile.cuh,
# csrc/sparse_conv_dw.cu): rows of A per block, the Cout tiles instantiated
# (accumulators BN / 2 a thread, no spills up to 192), D's flattened
# (offset, channel) entries per block and rows per chunk. The plans choose
# from them; the C launchers take the plan as given and refuse one that
# their instances cannot run, so the two sides cannot drift apart unseen.
_A_ROWS = 64
TILE_WIDTHS = (16, 32, 48, 64, 80, 96, 112, 128, 160, 192)
_DW_M = 64
_DW_CHUNK = 32
# A splits its offsets where its row tiles x Cout tiles leave fewer than 2
# blocks per SM (the deep levels), into at most 9 groups, towards 8 blocks
# per SM; D wants 8 blocks per SM.
_A_SPLIT_BELOW = 2 * _SMS
_A_MAX_SPLITS = 9
_BLOCKS = 8 * _SMS
# workspace caps: A's split partials, D's row-group partials
_A_WORKSPACE_BYTES = 64 << 20
_DW_WORKSPACE_BYTES = 32 << 20
# kernel D's f32 CUDA-core body: rows per chunk, tiles up to 64 wide
_DW_F32_ROWS = 64


class ConvPlan(NamedTuple):
    """Kernel A's launch: Cout tile ``bn`` (``n_tiles`` of them), the K
    offsets split into ``splits`` contiguous groups of ``kpg`` (f32 partials
    [splits, N_out, Cout] in a workspace of ``workspace_bytes``, summed in
    group order)."""
    bm: int
    bn: int
    n_tiles: int
    splits: int
    kpg: int
    workspace_bytes: int


class DwPlan(NamedTuple):
    """Kernel D's launch: Cout tile ``bn``, ``m_tiles`` x ``n_tiles`` output
    tiles, output rows in ``groups`` contiguous groups of ``rows_per_group``
    (f32 partials [groups, K, Cin, Cout] in ``workspace_bytes``, summed in
    group order)."""
    bn: int
    m_tiles: int
    n_tiles: int
    groups: int
    rows_per_group: int
    workspace_bytes: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def cout_tiles(cout: int) -> Tuple[int, int]:
    """(tile width, tiles) of the tensor-core kernels for ``cout`` channels:
    the fewest tiles of one instantiated width, the narrowest that covers."""
    n = _cdiv(max(cout, 1), TILE_WIDTHS[-1])
    per = _cdiv(max(cout, 1), n)
    return next(w for w in TILE_WIDTHS if w >= per), n


@functools.lru_cache(maxsize=1024)
def conv_plan(n_out: int, cin: int, cout: int, kvol: int, dtype: torch.dtype) -> ConvPlan:
    """Kernel A's plan, tuned for the 132 SMs of an H100 SXM. f32: the
    CUDA-core body's 64 x 64 tiles. bf16: a Cout tile shaped to the width.
    Where the row tiles x Cout tiles leave fewer than 2 blocks per SM and
    Cin is a multiple of 16 (the deep levels, whose few rows have few
    neighbors: each block's chain of stages, not the card's throughput, sets
    the time), the offsets are split into up to 9 groups towards 8 blocks
    per SM, within the workspace cap, and a Cout tile of 96 or more is
    halved if that still leaves the card short."""
    if dtype == torch.float32:
        return ConvPlan(64, 64, _cdiv(cout, 64), 1, kvol, 0)
    bn, n_tiles = cout_tiles(cout)
    rows = _cdiv(n_out, _A_ROWS)
    splits = 1
    if cin % 16 == 0 and 0 < rows * n_tiles < _A_SPLIT_BELOW:
        cap = max(1, _A_WORKSPACE_BYTES // max(1, n_out * cout * 4))
        splits = max(1, min(kvol, _A_MAX_SPLITS, _cdiv(_BLOCKS, rows * n_tiles), cap))
        if rows * n_tiles * splits < _BLOCKS and bn >= 96 and bn // 2 in TILE_WIDTHS:
            bn, n_tiles = bn // 2, _cdiv(cout, bn // 2)
    kpg = _cdiv(kvol, splits)
    splits = _cdiv(kvol, kpg)  # no empty group
    ws = splits * n_out * cout * 4 if splits > 1 else 0
    return ConvPlan(_A_ROWS, bn, n_tiles, splits, kpg, ws)


def offset_groups(plan: ConvPlan, kvol: int) -> List[range]:
    """The offsets each of the plan's groups sums, in group order."""
    return [range(g * plan.kpg, min(kvol, (g + 1) * plan.kpg)) for g in range(plan.splits)]


@functools.lru_cache(maxsize=1024)
def dw_plan(n_out: int, kvol: int, cin: int, cout: int, dtype: torch.dtype) -> DwPlan:
    """Kernel D's plan, tuned for the 132 SMs of an H100 SXM: enough row
    groups to fill the card (8 blocks per SM), at most one per row chunk,
    a workspace within its cap. f32: the CUDA-core kernel picks its own
    16/32/64 tiles and takes only the row groups, counted here as if its
    tiles were 64 wide."""
    if dtype == torch.float32:  # one offset and a Cin x Cout tile of 16..64 per block
        bn, chunk = 64, _DW_F32_ROWS
        m_tiles, n_tiles = kvol * _cdiv(cin, 64), _cdiv(cout, 64)
    else:
        (bn, n_tiles), chunk = cout_tiles(cout), _DW_CHUNK
        m_tiles = _cdiv(kvol * cin, _DW_M)
    want = _cdiv(_BLOCKS, m_tiles * n_tiles)
    cap = _DW_WORKSPACE_BYTES // max(1, kvol * cin * cout * 4)
    chunks = _cdiv(n_out, chunk)
    groups = max(1, min(want, cap, chunks))
    ws = groups * kvol * cin * cout * 4 if groups > 1 else 0
    return DwPlan(bn, m_tiles, n_tiles, groups, _cdiv(chunks, groups) * chunk, ws)


def check_rows(name: str, ptr: int, cols: int, pitch: int, dtype: torch.dtype,
               gathered: bool = False) -> None:
    """An operand of rows of ``cols`` elements of ``dtype``, ``pitch``
    elements apart, at byte address ``ptr``. The tensor-core kernels copy
    each row in 16-byte cp.async segments, or in 8-byte ones for a
    ``gathered`` feats row of 4 channels past a multiple of 8 (Cin 4), so
    the rows must be packed (pitch == cols) and every row must start on a
    segment boundary."""
    nbytes = cols * dtype.itemsize
    width = 8 if gathered and nbytes % 16 == 8 else 16
    if pitch != cols:
        raise ValueError(f"{name}: rows must be packed, got a pitch of {pitch} for {cols} columns")
    if ptr % width or nbytes % width:
        raise ValueError(f"{name}: rows must start on {width}-byte boundaries (address "
                         f"{ptr:#x}, {nbytes} bytes a row)")


def sparse_conv_plain(feats: torch.Tensor, idx: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """Zero-pad-row gathers + one GEMM per offset, accumulated in f32."""
    n_in, cin = feats.shape
    fz = torch.cat([feats, feats.new_zeros((1, cin))], dim=0).float()
    idx_z = torch.where(idx >= 0, idx, torch.full_like(idx, n_in)).long()
    w = weights.float()
    out = torch.zeros((idx.shape[0], weights.shape[2]), dtype=torch.float32,
                      device=feats.device)
    for k in range(idx.shape[1]):
        out += fz[idx_z[:, k]] @ w[k]
    return out


def sparse_conv_dw_plain(feats: torch.Tensor, idx: torch.Tensor,
                         g: torch.Tensor) -> torch.Tensor:
    """Per-offset gather and ``fk^T @ g``, in f32: [K, Cin, Cout]."""
    n_in, cin = feats.shape
    fz = torch.cat([feats, feats.new_zeros((1, cin))], dim=0).float()
    idx_z = torch.where(idx >= 0, idx, torch.full_like(idx, n_in)).long()
    gf = g.float()
    return torch.stack([fz[idx_z[:, k]].T @ gf for k in range(idx.shape[1])])


def check_operands(name: str, feats: torch.Tensor, dense: torch.Tensor,
                   idx: torch.Tensor) -> None:
    """What a conv kernel takes: ``feats`` and ``dense`` (W, or g) contiguous,
    both f32 or both bf16, an int32 contiguous map, all on one device, and
    in bf16 the layout of :func:`check_tc_operands`."""
    dt = feats.dtype
    if dt not in _DTYPES or dense.dtype != dt:
        raise TypeError(f"{name} takes f32 or bf16 operands of one dtype, got "
                        f"{feats.dtype} and {dense.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"{name}: kernel map must be int32, got {idx.dtype}")
    dev = feats.device
    if dense.device != dev or idx.device != dev:
        raise ValueError(f"{name}: operands and kernel map must be on one device")
    if not (feats.is_contiguous() and dense.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{name} needs contiguous operands and kernel map")
    if dt == torch.bfloat16:
        check_tc_operands(name, feats, dense)


def check_tc_operands(name: str, feats: torch.Tensor, dense: torch.Tensor) -> None:
    """The bf16 kernels' layout (:func:`check_rows`): ``feats`` rows
    gathered, ``dense`` (W as [K * Cin, Cout], or g) rows read whole."""
    if feats.dtype != torch.bfloat16:
        return
    cin = feats.shape[1]
    check_rows(f"{name} feats", feats.data_ptr(), cin, feats.stride(0), feats.dtype, True)
    cols = dense.shape[-1]
    check_rows(f"{name} {'weights' if dense.dim() == 3 else 'g'}", dense.data_ptr(), cols,
               dense.stride(-2), dense.dtype)


def sparse_conv_fwd(feats: torch.Tensor, idx: torch.Tensor, weights: torch.Tensor,
                    kernel: _cuda.Kernel = KERNEL) -> torch.Tensor:
    """Kernel A: feats [N_in, Cin], idx [N_out, K] int32 (-1 = absent),
    weights [K, Cin, Cout] in the feats dtype -> [N_out, Cout] f32.
    ``kernel`` names the role whose counter the launch adds to."""
    n_out, kvol = idx.shape
    if weights.dim() != 3 or weights.shape[0] != kvol or weights.shape[1] != feats.shape[1]:
        raise ValueError(f"weights {tuple(weights.shape)} do not match feats "
                         f"{tuple(feats.shape)} and map {tuple(idx.shape)}")
    if feats.device.type == "cpu":
        return sparse_conv_plain(feats, idx, weights)
    check_operands("sparse_conv", feats, weights, idx)
    n_in, cin = feats.shape
    cout = weights.shape[2]
    plan = conv_plan(n_out, cin, cout, kvol, feats.dtype)
    out = torch.empty((n_out, cout), dtype=torch.float32, device=feats.device)
    ws = (torch.empty((plan.splits, n_out, cout), dtype=torch.float32, device=feats.device)
          if plan.splits > 1 else None)
    kernel(feats.data_ptr(), idx.data_ptr(), weights.data_ptr(), out.data_ptr(),
           ws.data_ptr() if ws is not None else None, n_in, n_out, cin, cout, kvol, plan.bm,
           plan.bn, plan.n_tiles, plan.splits, plan.kpg, _DTYPES[feats.dtype],
           _cuda.stream_ptr(feats.device))
    return out


def sparse_conv_dw(feats: torch.Tensor, idx: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Kernel D: feats [N_in, Cin], idx [N_out, K] int32, g [N_out, Cout] in
    the feats dtype -> dW [K, Cin, Cout] f32."""
    n_out, kvol = idx.shape
    if g.dim() != 2 or g.shape[0] != n_out:
        raise ValueError(f"g {tuple(g.shape)} does not match map {tuple(idx.shape)}")
    if feats.device.type == "cpu":
        return sparse_conv_dw_plain(feats, idx, g)
    check_operands("sparse_conv_dw", feats, g, idx)
    n_in, cin = feats.shape
    cout = g.shape[1]
    out = torch.empty((kvol, cin, cout), dtype=torch.float32, device=feats.device)
    plan = dw_plan(n_out, kvol, cin, cout, feats.dtype)
    partial = (torch.empty((plan.groups, kvol, cin, cout), dtype=torch.float32,
                           device=feats.device) if plan.groups > 1 else out)
    KERNEL_DW(feats.data_ptr(), idx.data_ptr(), g.data_ptr(), partial.data_ptr(),
              out.data_ptr(), n_in, n_out, cin, cout, kvol, plan.bn, plan.m_tiles, plan.n_tiles,
              plan.groups, plan.rows_per_group, _DTYPES[feats.dtype],
              _cuda.stream_ptr(feats.device))
    return out


class _SparseConvTM(torch.autograd.Function):
    """``_conv_tm`` of the JAX package: forward through ``idx``, backward
    through the transpose map ``idx_t``."""

    @staticmethod
    def forward(ctx, feats, weights, idx, idx_t):
        ctx.save_for_backward(feats, weights, idx, idx_t)
        return sparse_conv_fwd(feats, idx, weights)

    @staticmethod
    def backward(ctx, g):
        feats, weights, idx, idx_t = ctx.saved_tensors
        gq = g.to(feats.dtype).contiguous()
        gf = gw = None
        if ctx.needs_input_grad[0]:
            w_t = weights.flip(0).transpose(1, 2).contiguous()
            gf = sparse_conv_fwd(gq, idx_t, w_t, kernel=KERNEL_DX).to(feats.dtype)
        if ctx.needs_input_grad[1]:
            gw = sparse_conv_dw(feats, idx, gq).to(weights.dtype)
        return gf, gw, None, None


def sparse_conv(feats: torch.Tensor, idx: torch.Tensor, weights: torch.Tensor,
                idx_t: torch.Tensor | None = None) -> torch.Tensor:
    """feats [N_in, Cin] f32|bf16, idx [N_out, K] int32 (-1 = absent),
    weights [K, Cin, Cout] in the feats dtype -> [N_out, Cout] f32.

    ``idx_t`` ([N_in, K]) is the transpose map: the submanifold map itself,
    or the partner of a down/up pair. With it the result is differentiable
    through the kernels (dX by kernel A on ``idx_t``, dW by kernel D).
    Without it only a CPU call is differentiable (through the plain
    version's own autograd); a CUDA call that needs a gradient raises."""
    if idx_t is None:
        if (feats.device.type != "cpu" and torch.is_grad_enabled()
                and (feats.requires_grad or weights.requires_grad)):
            raise ValueError("sparse_conv needs the transpose map idx_t to differentiate "
                             "on the GPU")
        return sparse_conv_fwd(feats, idx, weights)
    if idx_t.shape != (feats.shape[0], idx.shape[1]):
        raise ValueError(f"transpose map {tuple(idx_t.shape)} does not match feats "
                         f"{tuple(feats.shape)} and map {tuple(idx.shape)}")
    return _SparseConvTM.apply(feats, weights, idx, idx_t)
