"""Nothing under benchmark/ imports JAX, Flax, Optax or the JAX package, and
the reference imports nothing of the port; the run's own check of
``sys.modules`` sees a loaded one."""

import ast
import os
import sys
import types

from benchmark import run
from benchmark.tests.tiny import HERE

JAX_NAMES = {"jax", "jaxlib", "flax", "optax", "panopticsegforlargescalepointcloud_tpu"}
PORT = "panopticsegforlargescalepointcloud_tpu_torch"


def _imports(path):
    """(top-level names of absolute imports, levels of relative ones)."""
    tree = ast.parse(open(path).read(), path)
    names, levels = set(), []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                levels.append((node.level, node.module))
            else:
                names.add(node.module.split(".")[0])
    return names, levels


def _files(root):
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere_in_the_benchmark():
    for path in _files(HERE):
        names, _ = _imports(path)
        assert not names & JAX_NAMES, (path, names & JAX_NAMES)


def test_reference_imports_nothing_of_the_port():
    ref = os.path.join(HERE, "reference")
    for path in _files(ref):
        names, levels = _imports(path)
        assert PORT not in names and "benchmark" not in names, path
        depth = os.path.relpath(path, ref).count(os.sep)
        for level, module in levels:
            assert level - 1 <= depth, (path, level, module)  # stays inside reference/


def test_forbidden_modules_are_seen(monkeypatch):
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "flax.core", types.ModuleType("flax.core"))
    monkeypatch.setitem(sys.modules, "panopticsegforlargescalepointcloud_tpu.ops",
                        types.ModuleType("panopticsegforlargescalepointcloud_tpu.ops"))
    assert run.forbidden_modules() == ["flax", "panopticsegforlargescalepointcloud_tpu"]
