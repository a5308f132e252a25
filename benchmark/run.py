"""Run one cell of the port's benchmark once.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``BENCHMARK.json`` names the cell's
configuration and traffic mix; the harness finds everything else by name:
the configuration in ``benchmark/configs/<config>.json``, the traffic mix in
``benchmark/traffic/<traffic>.json`` (with the driver it runs under,
``benchmark/drivers/<driver>.py``), the limits of the comparison that
decides ``correct`` in ``benchmark/limits/<workload>.json``, and each
per-layer metric's reader in ``benchmark/metrics/<metric>.py``.

Set-up (inputs and weights from the seed, the program's build and
warm-up) is timed from the process's start; the window then runs for
``--seconds``. With ``--trace 0`` the result holds the cell's end-to-end
metrics; with ``--trace 1`` its per-layer metrics, read from the
benchmark's own spans around the program's phases and from a profiler
trace of a short sub-window. After the window the program's state is
freed and the plain reference decides ``correct``. The last line of
standard output is one JSON object; the numbers compared, each beside its
limit, are the last lines of standard error and the result's last key.
Without a CUDA device, or with fewer than the cell asks for, it exits 2
and prints no result; so it does if the JAX package, JAX, Flax or Optax
has been loaded.
"""

from __future__ import annotations

import time

_T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Dict, Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "panopticsegforlargescalepointcloud_tpu")
# the host threads of torch and of the OpenMP and BLAS pools: one process with
# few threads, so that a run's load on the host's shared cores stays the same
HOST_THREADS = 4


def process_start() -> float:
    """The perf_counter reading at this process's start (from its start
    time in /proc, where there is one; else when this module loaded)."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = float(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        if 0.0 <= age < 3600.0:
            return time.perf_counter() - age
    except (OSError, ValueError, IndexError):
        pass
    return _T_IMPORT


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def load_reader(name: str):
    """The per-layer metric reader ``benchmark/metrics/<name>.py``: its
    ``read(layers)`` returns the metric's value, or None where the run has
    nothing to read."""
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", os.path.join(HERE, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(manifest: dict, cell: dict, trace: bool) -> list:
    """The metric entries this cell reports: its end-to-end metrics
    (``--trace 0``) or its per-layer ones (``--trace 1``)."""
    name = cell["name"]
    e2e = [m for m in manifest["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if ((name in m["workloads"]) if "workloads" in m else (m["moves"] in mine))]


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Optional[str]:
    """None where every number is within its limit (and every limit has
    its number), else what failed."""
    bad = []
    for key, limit in limits.items():
        v = numbers.get(key)
        if v is None or not math.isfinite(v) or v > limit:
            bad.append(f"{key}={v} over {limit}")
    return "; ".join(bad) or None


def execute(manifest: dict, cell: dict, config: dict, traffic: dict, limits: dict, seed: int,
            seconds: float, trace: bool, t_start: float, device: str = "cuda"):
    """Set-up, window and check of one run: (result, lines for standard
    output, lines for standard error)."""
    import torch

    from .timing import PhaseTimer

    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    timer = PhaseTimer(sync) if trace else None
    out = driver.run(config, traffic, seed, seconds, timer=timer, profile=trace, device=device)
    setup_s = out.setup_end - t_start

    metrics = {}
    for m in cell_metrics(manifest, cell, trace):
        if trace:
            value = load_reader(m["name"])(out.layers)
        elif m["name"] == "setup_s":
            value = setup_s
        else:
            value = out.metrics.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    out.lines.append("reference numbers " + json.dumps(out.numbers))
    failed = judge(out.numbers, limits)
    checks = {k: {"value": out.numbers.get(k), "limit": v} for k, v in limits.items()}
    kind = torch.cuda.get_device_name(0) if device != "cpu" else "cpu"
    dev = {"platform": "gpu" if device != "cpu" else "cpu", "kind": kind,
           "count": int(cell["chips"]), "memory_peak_bytes": int(out.memory_peak)}
    result = {"correct": failed is None, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": dev}
    tr = out.layers.trace if (trace and out.layers is not None) else None
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    result["checks"] = checks
    err = [f"setup_s {setup_s}"] + ([f"not correct: {failed}"] if failed else [])
    err += [f"check {k} {v['value']} limit {v['limit']}" for k, v in checks.items()]
    return result, out.lines, err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start()

    root = os.getcwd()
    manifest = load_json(root, "BENCHMARK.json")
    cells = {c["name"]: c for c in manifest["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    # the program's build and kernel caches stay inside the checkout
    cache = os.path.join(root, ".bench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(HOST_THREADS)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    torch.set_num_threads(HOST_THREADS)

    result, out_lines, err_lines = execute(
        manifest, cell, load_json(HERE, "configs", f"{cell['config']}.json"),
        load_json(HERE, "traffic", f"{cell['traffic']}.json"),
        load_json(HERE, "limits", f"{args.workload}.json"), args.seed, args.seconds,
        bool(args.trace), t_start)
    loaded = forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded: {loaded}", file=sys.stderr)
        return 2
    for line in out_lines:
        print(line, flush=True)
    for line in err_lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
