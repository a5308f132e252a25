"""Device-time breakdown of the flagship eval forward on one GPU.

    python3 -m panopticsegforlargescalepointcloud_tpu_torch.trace_eval

Runs the bf16 eval forward of the flagship configuration (the main path of
``chip_smoke.py``) under ``torch.profiler`` and prints one JSON line: the
host wall time of the traced forwards, the device-busy time (union of GPU
kernel intervals) and the idle share, and device time per kernel name,
largest first. The full table goes to ``chiprun_out/trace_eval.txt``.
Without a CUDA device it exits with code 2.
"""

from __future__ import annotations

import json
import os
import sys
import time


def _union_us(intervals):
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


_FORWARDS = 2  # traced forwards, after one warm-up


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("trace_eval: no CUDA device", file=sys.stderr)
        return 2
    from .flagship import build_inputs, flagship_config, random_model
    from .train import make_eval_forward

    cfg = flagship_config(num_samples=4, compute_dtype="bfloat16")
    arrays = build_inputs()
    fwd = make_eval_forward(cfg, random_model(cfg, seed=5))
    fwd(arrays)  # warm-up: kernel build, allocator
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(_FORWARDS):
            fwd(arrays)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / _FORWARDS
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    per_name = {}
    for e in kernels:
        per_name[e.name] = per_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    busy_ms = _union_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3 / _FORWARDS
    top = sorted(per_name.items(), key=lambda kv: -kv[1])
    res = dict(
        device=torch.cuda.get_device_name(0),
        wall_ms_per_forward=wall_ms,
        device_busy_ms_per_forward=busy_ms if kernels else "not measured",
        device_idle_share=(1.0 - busy_ms / wall_ms) if kernels else "not measured",
        gpu_kernel_launches_per_forward=len(kernels) / _FORWARDS,
        top_kernels_ms_per_forward=[(n[:80], us / 1e3 / _FORWARDS) for n, us in top[:12]],
    )
    out_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "trace_eval.txt"), "w") as fh:
        fh.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=60))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
