"""PLY file io (self-contained; no plyfile dependency). A copy of the JAX
package's ``data/ply.py``.

Supports ascii and binary_little_endian vertex-element files - the formats
the reference reads (NPM3D/FOR-instance scans via plyfile,
upstream ``torch_points3d/datasets/segmentation/treeins.py:59-76``)
and writes (prediction exporters at ``datasets/panoptic/treeins.py:41-96``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

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


def write_ply(
    path: str,
    arrays: Sequence[np.ndarray],
    names: Sequence[str],
    text: bool = False,
) -> None:
    """Write a vertex-only PLY. ``arrays`` are columns (or [N,3] blocks whose
    names consume 3 entries), matching the reference's write_ply helper
    (``models/panoptic/ply.py``)."""
    cols: List[np.ndarray] = []
    for a in arrays:
        a = np.asarray(a)
        if a.ndim == 1:
            cols.append(a)
        else:
            cols.extend(a[:, i] for i in range(a.shape[1]))
    assert len(cols) == len(names), f"{len(cols)} columns != {len(names)} names"
    n = len(cols[0])
    dt = np.dtype(
        [(nm, "<" + c.dtype.str.lstrip("<>=|")) for nm, c in zip(names, cols)]
    )
    rec = np.zeros(n, dtype=dt)
    for nm, c in zip(names, cols):
        rec[nm] = c
    if not path.endswith(".ply"):
        path = path + ".ply"
    with open(path, "wb") as f:
        f.write(b"ply\n")
        fmt = "ascii" if text else "binary_little_endian"
        f.write(f"format {fmt} 1.0\n".encode())
        f.write(f"element vertex {n}\n".encode())
        for nm, c in zip(names, cols):
            f.write(
                f"property {_INV_DTYPES[c.dtype.str.lstrip('<>=|')]} {nm}\n".encode()
            )
        f.write(b"end_header\n")
        if text:
            fmts = [
                "%d" if c.dtype.kind in "iu" else
                ("%.9g" if c.dtype.itemsize <= 4 else "%.17g")
                for c in cols
            ]
            np.savetxt(
                f, np.stack([c.astype(np.float64) for c in cols], 1),
                fmt=" ".join(fmts),
            )
        else:
            f.write(rec.tobytes())


def to_eval_ply(path: str, pos: np.ndarray, preds: np.ndarray, gt: np.ndarray) -> None:
    """The reference's evaluation exporter layout (``datasets/panoptic/
    treeins.py:59-75`` to_eval_ply): ASCII PLY with properties
    x/y/z float, preds/gt int16 - used for both Semantic_results_forEval and
    Instance_Results_forEval files so evaluation_stats_{FOR,NPM3D}.py and the
    reference's own offline tooling parse either framework's outputs."""
    write_ply(
        path,
        [pos.astype(np.float32), preds.astype(np.int16), gt.astype(np.int16)],
        ["x", "y", "z", "preds", "gt"],
        text=True,
    )


def to_ins_ply(path: str, pos: np.ndarray, label: np.ndarray,
               seed: int = 0) -> None:
    """Colored instance dump (reference to_ins_ply, treeins.py:78-96): a
    random uint8 RGB per instance id, ASCII PLY x/y/z/red/green/blue."""
    label = np.asarray(label).astype(np.int64)
    rng = np.random.default_rng(seed)
    n_ids = max(int(label.max()) + 1 if label.size else 1, 1)
    colors = rng.integers(0, 255, size=(n_ids, 3), dtype=np.uint8)
    c = colors[np.maximum(label, 0)]
    write_ply(
        path,
        [pos.astype(np.float32), c[:, 0], c[:, 1], c[:, 2]],
        ["x", "y", "z", "red", "green", "blue"],
        text=True,
    )
