"""JAX's persistent compilation cache for the port's parity tests.

The port's test files compile the JAX package's programs as their
references, and several files compile the same ones (the tiny plan's eval
forward and train steps, the evaluator's, the eager ops of canonicalize and
the hierarchy). Under ``--dist loadfile`` those files run on different
workers, each its own process, so each worker compiled them again.

:func:`jax_compilation_cache` is a module fixture, autouse in every port
test file that imports it. It points JAX's persistent compilation cache at
``jax_compilation_cache/`` under the run's own pytest temp root (the parent
of the ``popen-gw*`` worker directories under xdist), so that the workers
of one run share their XLA executables. Each run has a temp root of its own
and starts with an empty cache; pytest removes old temp roots.

The setting is global to the worker's process and stays on for the files
that run after on that worker, the JAX package's own test files included:
a cache hit skips XLA's compile of the same program, and the results are
those of the compiled program itself."""

import jax
import pytest
from jax.experimental.compilation_cache import compilation_cache


@pytest.fixture(scope="module", autouse=True)
def jax_compilation_cache(tmp_path_factory):
    root = tmp_path_factory.getbasetemp()
    if root.name.startswith("popen-gw"):  # an xdist worker's directory
        root = root.parent
    path = root / "jax_compilation_cache"
    path.mkdir(exist_ok=True)
    if jax.config.jax_compilation_cache_dir != str(path):
        jax.config.update("jax_compilation_cache_dir", str(path))
        # every program, however small: the eager ops are many
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
        compilation_cache.reset_cache()  # a cache already set up reads the new path
    yield
