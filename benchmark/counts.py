"""Operations and bytes of the sparse UNet's forward, from the inputs'
voxel coordinates and the configuration's widths alone.

A frozen plain count (numpy), independent of the port's grids and maps:
level l + 1 holds floor(coords_l / 2) of each sample; a submanifold conv at
level l pairs each voxel with its present neighbours among the 27 offsets
(itself included); a stride-2 conv pairs each coarse voxel c with the fine
voxels at 2c + o, o in {-1, 0, 1}^3, and the transpose (up) conv pairs the
same voxels the other way. A conv's operations are 2 x pairs x Cin x Cout;
a dense 1x1 shortcut's 2 x rows x Cin x Cout; the heads' 2 x rows x
(Cin x Cout) per linear layer. A conv's bytes read each input row, the
weights and the output's map row once and write each output row once
(inputs and weights at the operand width, the map int32, the output f32).
Padding rows, BN, activations, the ScoreNet and clustering are not counted.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence

import numpy as np

_OFFSETS = np.array([(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)],
                    dtype=np.int64)
_BITS = 18  # bits a coordinate: +-2^17 voxels a side
_BIAS = 1 << (_BITS - 1)


class Conv(NamedTuple):
    name: str
    pairs: int
    cin: int
    cout: int
    rows_in: int
    rows_out: int


def _keys(batch: np.ndarray, coords: np.ndarray) -> np.ndarray:
    """One int64 a voxel: the sample in bits 54-62, each coordinate in 18 bits."""
    c = coords.astype(np.int64) + _BIAS
    if c.size and (c.min() < 0 or c.max() >= 1 << _BITS):
        raise ValueError("voxel coordinates out of the count's range")
    return ((batch.astype(np.int64) << 3 * _BITS) | (c[:, 0] << 2 * _BITS) | (c[:, 1] << _BITS)
            | c[:, 2])


def _present(table: np.ndarray, keys: np.ndarray) -> np.ndarray:
    pos = np.searchsorted(table, keys)
    pos = np.minimum(pos, len(table) - 1)
    return table[pos] == keys


def levels(batch: np.ndarray, coords: np.ndarray, num_down: int):
    """[(batch, coords)] of levels 0..num_down: level 0 the unique voxels
    of (batch, coords), each next level their stride-2 parents."""
    out = []
    b, c = batch.astype(np.int64), coords.astype(np.int64)
    for lev in range(num_down + 1):
        k = np.unique(_keys(b, c), return_index=True)[1]
        b, c = b[k], c[k]
        out.append((b, c))
        if lev < num_down:
            c = np.floor_divide(c, 2)
    return out


def same_pairs(batch: np.ndarray, coords: np.ndarray) -> int:
    table = np.sort(_keys(batch, coords))
    total = 0
    for o in _OFFSETS:
        total += int(_present(table, _keys(batch, coords + o)).sum())
    return total


def down_pairs(fine, coarse) -> int:
    table = np.sort(_keys(*fine))
    cb, cc = coarse
    total = 0
    for o in _OFFSETS:
        total += int(_present(table, _keys(cb, 2 * cc + o)).sum())
    return total


def unet_convs(lv, down_channels: Sequence, up_channels: Sequence, down_strides: Sequence,
               up_strides: Sequence, num_blocks: int) -> List[Conv]:
    """The convs of the sparse UNet (each ResNetDown: a first conv, then
    ``num_blocks`` ResBlocks of two convs and, where the width changes, a
    1x1 shortcut, listed with ``pairs`` = its rows) over levels ``lv``."""
    n = [len(b) for b, _ in lv]
    same = [same_pairs(*x) for x in lv]
    down = [down_pairs(lv[i], lv[i + 1]) for i in range(len(lv) - 1)]
    convs: List[Conv] = []

    def block(tag, cin, cout, stride, conv_pairs, lin, lout):
        first = cin if stride > 1 else cout
        convs.append(Conv(f"{tag}.conv0", conv_pairs, cin, first, n[lin], n[lout]))
        c = first
        for b in range(num_blocks):
            convs.append(Conv(f"{tag}.res{b}.conv0", same[lout], c, cout, n[lout], n[lout]))
            convs.append(Conv(f"{tag}.res{b}.conv1", same[lout], cout, cout, n[lout], n[lout]))
            if c != cout:
                convs.append(Conv(f"{tag}.res{b}.dense", n[lout], c, cout, n[lout], n[lout]))
            c = cout

    level = 0
    for i, ((cin, cout), s) in enumerate(zip(down_channels, down_strides)):
        if s == 1:
            block(f"down{i}", cin, cout, 1, same[level], level, level)
        else:
            block(f"down{i}", cin, cout, 2, down[level], level, level + 1)
            level += 1
    for i, ((cin, cout), s) in enumerate(zip(up_channels, up_strides)):
        if s == 1:
            block(f"up{i}", cin, cout, 1, same[level], level, level)
        else:
            block(f"up{i}", cin, cout, 2, down[level - 1], level, level - 1)
            level -= 1
    return convs


def conv_ops(c: Conv) -> float:
    return 2.0 * c.pairs * c.cin * c.cout


def conv_bytes(c: Conv, operand_bytes: int = 2) -> float:
    if c.name.endswith(".dense"):
        return (c.rows_in * c.cin + c.cin * c.cout) * operand_bytes + c.rows_out * c.cout * 4
    return ((c.rows_in * c.cin + 27 * c.cin * c.cout) * operand_bytes
            + c.rows_out * 27 * 4 + c.rows_out * c.cout * 4)


class ForwardCount(NamedTuple):
    conv_ops: float  # the backbone's sparse convs (the kernel's work)
    conv_bound_s: float  # sum over those convs of max(ops / peak, bytes / bandwidth)
    model_ops: float  # backbone (convs and shortcuts) and heads


def forward_count(batch: np.ndarray, coords: np.ndarray, plan: Dict, head_widths: Sequence,
                  feat: int, peak_flops: float, peak_bytes_s: float) -> ForwardCount:
    """The counts of one forward over the voxels (batch, coords): ``plan``
    the UNet's channel plan, ``head_widths`` the heads' output widths (each
    head a ``feat`` -> ``feat`` layer and a ``feat`` -> width layer)."""
    num_down = sum(1 for s in plan["down_strides"] if s > 1)
    lv = levels(batch, coords, num_down)
    convs = unet_convs(lv, plan["down_channels"], plan["up_channels"], plan["down_strides"],
                       plan["up_strides"], plan["num_blocks"])
    sparse = [c for c in convs if not c.name.endswith(".dense")]
    ops = sum(conv_ops(c) for c in sparse)
    bound = sum(max(conv_ops(c) / peak_flops, conv_bytes(c) / peak_bytes_s) for c in sparse)
    heads = 2.0 * len(lv[0][0]) * sum(feat * feat + feat * w for w in head_widths)
    return ForwardCount(ops, bound, sum(conv_ops(c) for c in convs) + heads)
