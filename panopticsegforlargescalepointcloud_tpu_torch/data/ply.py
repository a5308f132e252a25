"""PLY file io (self-contained; no plyfile dependency). The JAX package's
``data/ply.py``, with a writer that builds ASCII bodies in bulk and writes
the same bytes.

Supports ascii and binary_little_endian vertex-element files - the formats
the reference reads (NPM3D/FOR-instance scans via plyfile,
upstream ``torch_points3d/datasets/segmentation/treeins.py:59-76``)
and writes (prediction exporters at ``datasets/panoptic/treeins.py:41-96``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..utils import trace

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_INV_DTYPES = {
    "i1": "char", "u1": "uchar", "i2": "short", "u2": "ushort",
    "i4": "int", "u4": "uint", "f4": "float", "f8": "double",
}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read the vertex element of a PLY file into {property: array}."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt = None
        elements: List[Tuple[str, int, List[Tuple[str, str]]]] = []
        props: List[Tuple[str, str]] = []
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in header")
            tokens = line.strip().decode("ascii", "replace").split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                props = []
                elements.append((tokens[1], int(tokens[2]), props))
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    props.append((tokens[-1], "list:" + tokens[2] + ":" + tokens[3]))
                else:
                    props.append((tokens[-1], _PLY_DTYPES[tokens[1]]))
            elif tokens[0] == "end_header":
                break
        if fmt not in ("ascii", "binary_little_endian", "binary_big_endian"):
            raise ValueError(f"unsupported PLY format {fmt}")

        out: Dict[str, np.ndarray] = {}
        for name, count, eprops in elements:
            if any(d.startswith("list:") for _, d in eprops):
                if name == "vertex":
                    raise ValueError("list properties on vertex not supported")
                # skip non-vertex list elements (e.g. faces) - read rest & stop
                break
            endian = ">" if fmt == "binary_big_endian" else "<"
            dt = np.dtype([(p, endian + d) for p, d in eprops])
            if fmt == "ascii":
                rows = np.loadtxt(
                    (f.readline() for _ in range(count)), dtype=np.float64, ndmin=2
                )
                arr = np.zeros(count, dtype=dt)
                for i, (p, d) in enumerate(eprops):
                    arr[p] = rows[:, i].astype(d)
            else:
                arr = np.frombuffer(f.read(count * dt.itemsize), dtype=dt, count=count)
            if name == "vertex":
                for p, _ in eprops:
                    out[p] = np.ascontiguousarray(arr[p])
        return out


# ------------------------------------------------------------------ writing
#
# An ASCII body holds the bytes ``np.savetxt`` wrote for the float64 stack
# of the columns under the format ``" ".join(fmts)``: ``%.9g`` for float32,
# ``%.17g`` for float64, ``%d`` for integers, ``\n`` after every row. It is
# built with the same Python ``%`` formatting, in bulk. A piece is one
# str a row: float columns formatted ``_BLOCK`` rows a ``%`` call, or an
# integer column looked up in the text of its unique values. The rows'
# pieces are interleaved in one list and joined, and the file is written
# in one call.

_BLOCK = 8192  # rows of float columns that one ``%`` call formats


def _code(c: np.ndarray) -> str:
    return c.dtype.str.lstrip("<>=|")


def _columns(arrays: Sequence[np.ndarray], names: Sequence[str]) -> List[np.ndarray]:
    cols: List[np.ndarray] = []
    for a in arrays:
        a = np.asarray(a)
        if a.ndim == 1:
            cols.append(a)
        else:
            cols.extend(a[:, i] for i in range(a.shape[1]))
    assert len(cols) == len(names), f"{len(cols)} columns != {len(names)} names"
    return cols


def _header(names: Sequence[str], codes: Sequence[str], n: int, text: bool) -> bytes:
    fmt = "ascii" if text else "binary_little_endian"
    lines = ["ply", f"format {fmt} 1.0", f"element vertex {n}"]
    lines += [f"property {_INV_DTYPES[code]} {nm}" for nm, code in zip(names, codes)]
    lines.append("end_header")
    return ("\n".join(lines) + "\n").encode()


def _float_piece(cols: Sequence[np.ndarray], lead: str = "") -> List[str]:
    """Float columns side by side, each row led by ``lead``."""
    fmt = lead + " ".join("%.9g" if c.dtype.itemsize <= 4 else "%.17g" for c in cols) + "\n"
    stack = np.stack([c.astype(np.float64) for c in cols], 1)
    rows: List[str] = []
    for s in range(0, len(stack), _BLOCK):
        part = stack[s:s + _BLOCK]
        rows += ((fmt * len(part)) % tuple(part.ravel().tolist()))[:-1].split("\n")
    return rows


def _table_piece(keys: np.ndarray, texts) -> List[str]:
    """Each row's text, ``texts(unique keys)`` looked up by its key."""
    uniq, inv = np.unique(keys, return_inverse=True)
    return np.array(texts(uniq), dtype=object)[inv.reshape(-1)].tolist()


def _int_piece(col: np.ndarray, lead: str = "") -> List[str]:
    # %d of the float64 value, as savetxt's stack holds it
    return _table_piece(col, lambda u: [lead + "%d" % v for v in u.astype(np.float64).tolist()])


def _text_body(pieces: Sequence[List[str]]) -> bytes:
    """The rows, each its pieces' text and a newline."""
    n, k = len(pieces[0]), len(pieces) + 1
    cells: List[str] = ["\n"] * (n * k)
    for i, p in enumerate(pieces):
        cells[i::k] = p
    return "".join(cells).encode("latin-1")


def _write(path: str, head: bytes, body: bytes) -> None:
    if not path.endswith(".ply"):
        path = path + ".ply"
    with open(path, "wb") as f:
        f.write(head)
        f.write(body)
        trace.count("ply_bytes", f.tell())


def write_ply(
    path: str,
    arrays: Sequence[np.ndarray],
    names: Sequence[str],
    text: bool = False,
) -> None:
    """Write a vertex-only PLY. ``arrays`` are columns (or [N,3] blocks whose
    names consume 3 entries), matching the reference's write_ply helper
    (``models/panoptic/ply.py``). Counts the file's bytes as ``ply_bytes``
    (:mod:`..utils.trace`)."""
    cols = _columns(arrays, names)
    if text:
        body = _text_body([_int_piece(c, " " if i else "") if c.dtype.kind in "iu"
                           else _float_piece([c], " " if i else "")
                           for i, c in enumerate(cols)])
    else:
        dt = np.dtype([(nm, "<" + _code(c)) for nm, c in zip(names, cols)])
        rec = np.zeros(len(cols[0]), dtype=dt)
        for nm, c in zip(names, cols):
            rec[nm] = c
        body = rec.tobytes()
    _write(path, _header(names, [_code(c) for c in cols], len(cols[0]), text), body)


_EVAL = (["x", "y", "z", "preds", "gt"], ["f4"] * 3 + ["i2"] * 2)
_INS = (["x", "y", "z", "red", "green", "blue"], ["f4"] * 3 + ["u1"] * 3)


def _xyz_piece(pos: np.ndarray) -> List[str]:
    pos = pos.astype(np.float32)
    return _float_piece([pos[:, 0], pos[:, 1], pos[:, 2]])


def _eval_ply(path: str, xyz: List[str], preds: np.ndarray, gt: np.ndarray) -> None:
    body = _text_body([xyz, _int_piece(preds.astype(np.int16), " "),
                       _int_piece(gt.astype(np.int16), " ")])
    _write(path, _header(*_EVAL, len(xyz), True), body)


def _ins_ply(path: str, xyz: List[str], label: np.ndarray, seed: int) -> None:
    label = np.asarray(label).astype(np.int64)
    rng = np.random.default_rng(seed)
    n_ids = max(int(label.max()) + 1 if label.size else 1, 1)
    colors = rng.integers(0, 255, size=(n_ids, 3), dtype=np.uint8)
    rgb = _table_piece(np.maximum(label, 0), lambda u: [
        " %d %d %d" % tuple(c) for c in colors[u].astype(np.float64).tolist()])
    _write(path, _header(*_INS, len(xyz), True), _text_body([xyz, rgb]))


def to_eval_ply(path: str, pos: np.ndarray, preds: np.ndarray, gt: np.ndarray) -> None:
    """The reference's evaluation exporter layout (``datasets/panoptic/
    treeins.py:59-75`` to_eval_ply): ASCII PLY with properties
    x/y/z float, preds/gt int16 - used for both Semantic_results_forEval and
    Instance_Results_forEval files so evaluation_stats_{FOR,NPM3D}.py and the
    reference's own offline tooling parse either framework's outputs."""
    _eval_ply(path, _xyz_piece(pos), preds, gt)


def to_ins_ply(path: str, pos: np.ndarray, label: np.ndarray,
               seed: int = 0) -> None:
    """Colored instance dump (reference to_ins_ply, treeins.py:78-96): a
    random uint8 RGB per instance id, ASCII PLY x/y/z/red/green/blue."""
    _ins_ply(path, _xyz_piece(pos), label, seed)


def write_report_plys(paths: Sequence[str], pos: np.ndarray, sem: np.ndarray,
                      ins: np.ndarray, gt_sem: np.ndarray, gt_ins: np.ndarray) -> None:
    """A served scene's three report files, ``paths`` in this order:
    ``to_eval_ply`` of the semantic labels, ``to_eval_ply`` of the instance
    labels, ``to_ins_ply`` of the instance labels, with the bytes of those
    three calls. Each file is written in a ``ply_write`` span; the
    positions' text is formatted once, in the first, and the other two
    reuse it (counter ``ply_xyz_reused``)."""
    sem_path, ins_path, color_path = paths
    with trace.span("ply_write"):
        xyz = _xyz_piece(pos)
        _eval_ply(sem_path, xyz, sem, gt_sem)
    with trace.span("ply_write"):
        trace.count("ply_xyz_reused")
        _eval_ply(ins_path, xyz, ins, gt_ins)
    with trace.span("ply_write"):
        trace.count("ply_xyz_reused")
        _ins_ply(color_path, xyz, ins, 0)
