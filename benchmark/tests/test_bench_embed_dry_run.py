"""The embed family's cell (``train-full.setting1-npm3d``, driver
``train_embed``) through the harness's path on the CPU at a tiny size:
correct, its metrics as listed, and not correct with the timed path broken
underneath or with the fp8 control in the program's place."""

import json
import time

import pytest

from benchmark import run
from benchmark.tests.tiny import HERE, load, manifest, tiny_train
from benchmark.tools import calibrate_embed, faults

WORKLOAD = "train-full.setting1-npm3d"


def _execute(trace=False, seed=2**31 + 54321, seconds=1.0):
    cell, config, traffic = tiny_train(WORKLOAD)
    limits = load(HERE, "limits", f"{WORKLOAD}.json")
    return run.execute(manifest(), cell, config, traffic, limits, seed, seconds, trace,
                       time.perf_counter(), device="cpu")


def test_dry_run():
    result, lines, err = _execute()
    assert result["correct"], err
    assert result["attempted"] >= 1 and result["failed"] == 0
    names = {m["name"] for m in run.cell_metrics(manifest(), tiny_train(WORKLOAD)[0], False)}
    assert set(result["metrics"]) == names == {"train_step_ms", "setup_s"}
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert any(line.startswith("mean shift pack, step 1: points") for line in lines)
    assert list(result)[-1] == "checks"
    json.dumps(result)


def test_traced_dry_run():
    # long enough that the profiled steps (the window's third to fifth) come
    result, lines, err = _execute(trace=True, seconds=6.0)
    assert result["correct"], err
    want = {m["name"] for m in run.cell_metrics(manifest(), tiny_train(WORKLOAD)[0], True)}
    got = set(result["metrics"])
    # the CPU has no device trace: only the spans' and the counts' metrics,
    # the mean-shift ones among them
    assert got and got <= want
    assert {"ms_dedup_ms.train", "ms_dedup_rounds.train", "cluster_ms.train"} <= got
    assert not {"scorenet_ms.train", "grow_rounds.train"} & want
    assert result["metrics"]["ms_dedup_rounds.train"]["value"] >= 1
    assert any(line.startswith("profiled mean shift: 3 calls") for line in lines)


@pytest.mark.parametrize("fault", ["frozen_state", "half_batch"])
def test_fault_is_not_correct(fault):
    undo = faults.FAULTS[fault]()
    try:
        result, _, err = _execute()
    finally:
        undo()
    assert result["correct"] is False, err


def test_control_is_not_correct():
    """The embed reference with fp8 conv operands in the program's place
    fails the cell's limits (at the tests' tiny size; the limits are set
    from the chip's readings at the cell's own)."""
    _, config, traffic = tiny_train(WORKLOAD)
    got = dict(calibrate_embed.readings(config, traffic, 2**31 + 99, True, False,
                                        device="cpu"))
    limits = load(HERE, "limits", f"{WORKLOAD}.json")
    assert run.judge(got["program"], limits) is None
    control = {k: v for k, v in got["control"].items() if k in limits}
    assert control and run.judge(control, {k: limits[k] for k in control}) is not None
