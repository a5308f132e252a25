"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process for ``sm_90a`` (all
started together), then the objects are linked into one shared library with
a plain C interface, loaded with ``ctypes``. The build goes to ``_build/``
beside this file, keyed by a hash of the sources and flags, on first use:
importing this module builds nothing.

Every kernel wrapper owns a :class:`Kernel`, whose ``launches`` counter goes
up by one for each launch of its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_COMMON = ["-O3", "-std=c++17", "-Xcompiler", "-fPIC"]
# Per-source flags. The clustering kernels compare distances against a
# radius, so their arithmetic must round exactly as the plain PyTorch
# versions do: no multiply-add contraction there. No source uses fast math
# (the dense pull relies on IEEE inf).
_SOURCES = {
    "sparse_conv.cu": [],
    "sparse_conv_parts.cu": [],
    "sparse_conv_dw.cu": [],
    "dense_pull.cu": ["-fmad=false"],
    "pull_tables.cu": ["-fmad=false"],
    "meanshift.cu": ["-fmad=false"],
}

_lock = threading.Lock()
_lib = None
build_log = ""


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256()
    for name in sorted(_SOURCES):
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
        h.update(" ".join(_ARCH + _COMMON + _SOURCES[name]).encode())
    for header in sorted(_CSRC.glob("*.cuh")):  # included by the sources
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile (if not built yet) and return the shared library's path.
    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory, spills) to
    :data:`build_log`."""
    global build_log
    out = _BUILD_DIR / _digest() / "libpst_kernels.so"
    if out.exists():
        return out
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for name, extra in _SOURCES.items():
            obj = Path(tmp) / (name + ".o")
            cmd = [nvcc, *_ARCH, *_COMMON, *extra, "-c", str(_CSRC / name), "-o", str(obj)]
            if verbose:
                cmd += ["-Xptxas", "-v"]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for name, _, p in procs:
            text = p.communicate()[0]
            logs.append(f"== {name}\n{text}")
            if p.returncode != 0:
                failed.append(name)
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")
        so = Path(tmp) / "lib.so"
        res = subprocess.run(
            [nvcc, *_ARCH, "-shared", "-o", str(so), *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}")
        os.replace(so, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call, once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.pst_cuda_error_string.argtypes = [ctypes.c_int]
            lib.pst_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


PTR = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float


class Kernel:
    """One C entry point of the library plus its launch counter."""

    def __init__(self, name: str, symbol: str, argtypes, source: str, replaces: str):
        """``source``: the CUDA file in the repo; ``replaces``: file:line of
        the TPU kernel it ports."""
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        rc = self._fn(*args)
        if rc != 0:
            msg = library().pst_cuda_error_string(rc).decode()
            raise RuntimeError(f"{self.name}: launch failed: {msg} ({rc})")
        self.launches += 1


def stream_ptr(device) -> int:
    """The current CUDA stream of ``device``, as the pointer the C entry
    points take."""
    return torch.cuda.current_stream(device).cuda_stream
