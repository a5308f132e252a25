"""Device-time breakdown of one flagship full train step on one GPU.

    python3 -m panopticsegforlargescalepointcloud_tpu_torch.trace_train [--models NAME]

Runs the bf16 full train step (clustering, ScoreNet and score loss
included) of the flagship configuration, or of the model yaml ``NAME`` of
``conf/models/panoptic`` on the flagship's data (say ``kpconv``), from the JAX package's
initializers, under ``torch.profiler``, after two warm-up steps, and prints
one JSON line: the host wall time of the traced step, the device-busy time
(union of GPU kernel intervals) and the idle share, the device time of each
of the port's kernels (A, D and their second pass, B, C), and device time per
kernel name, largest first. The full table goes to
``chiprun_out/trace_train.txt`` (``trace_train_<NAME>.txt``). Without a
CUDA device it exits with code 2.
"""

from __future__ import annotations

import json
import os
import sys
import time

from .trace_eval import _union_us

_WARMUP = 2
# the port's own kernels by the names nvcc gives them: (kernel, name part)
_FAMILIES = (
    ("A", "sparse_conv_mma<"),          # forward and dX, bf16
    ("A f32", "sparse_conv_tile<"),
    ("D", "sparse_conv_dw_mma<"),
    ("D f32", "sparse_conv_dw_partial_kernel<"),
    ("A, D second pass", "ordered_sum_kernel"),
    ("B", "dense_pull_blocks_kernel"),
    ("B tables", "pull_keys_kernel"),
    ("B tables", "pull_blocks_kernel"),
    ("B tables", "pull_cands_kernel"),
    ("C", "meanshift_converge_kernel<"),
)


def main(argv=None) -> int:
    import argparse

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("trace_train: no CUDA device", file=sys.stderr)
        return 2
    from .flagship import SETTINGS, build_inputs, flagship_config, flagship_training
    from .train import make_train_step

    ap = argparse.ArgumentParser()
    ap.add_argument("--models", default=SETTINGS["IV"])
    models = ap.parse_args(argv).models
    cfg = flagship_config(num_samples=4, compute_dtype="bfloat16", models=models)
    arrays = build_inputs()
    state, schedule, tc = flagship_training(cfg, seed=5)
    step = make_train_step(cfg, state.model, state.optimizer, schedule, True, tc.grad_clip_value)
    for _ in range(_WARMUP):  # kernel build, allocator
        step(arrays, state.bn_momentum)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        metrics = step(arrays, state.bn_momentum)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    per_name = {}
    for e in kernels:
        per_name[e.name] = per_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    busy_ms = _union_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3
    top = sorted(per_name.items(), key=lambda kv: -kv[1])
    families = {}
    for name, us in per_name.items():
        fam = next((f for f, part in _FAMILIES if part in name), None)
        if fam is not None:
            families[fam] = families.get(fam, 0.0) + us / 1e3
    res = dict(
        device=torch.cuda.get_device_name(0),
        models=models,
        wall_ms_per_step=wall_ms,
        device_busy_ms_per_step=busy_ms if kernels else "not measured",
        device_idle_share=(1.0 - busy_ms / wall_ms) if kernels else "not measured",
        gpu_kernel_launches_per_step=len(kernels),
        loss=float(metrics["loss"]),
        port_kernels_ms_per_step=families,
        top_kernels_ms_per_step=[(n[:80], us / 1e3) for n, us in top[:16]],
    )
    out_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    name = "trace_train.txt" if models == SETTINGS["IV"] else f"trace_train_{models}.txt"
    with open(os.path.join(out_dir, name), "w") as fh:
        fh.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=80))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
