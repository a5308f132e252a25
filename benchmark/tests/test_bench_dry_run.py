"""Each driver through the harness's path on the CPU at a tiny size, and the
same with the timed path broken underneath: ``correct`` comes out false.
The run on the card itself is marked ``card`` and skips here."""

import json
import time

import pytest
import torch

from benchmark import run
from benchmark.tests.tiny import HERE, cell, load, manifest, tiny_serve, tiny_train
from benchmark.tools import faults

TRAIN = ["train-full.setting4-npm3d", "train-prepare.setting4-npm3d"]
SERVE = ["serve-ply.setting4-forinstance", "serve-noply.setting4-forinstance"]


def _execute(workload, trace=False, seed=2**31 + 12345, seconds=1.0):
    cell, config, traffic = (tiny_train if workload in TRAIN else tiny_serve)(workload)
    limits = load(HERE, "limits", f"{workload}.json")
    return run.execute(manifest(), cell, config, traffic, limits, seed, seconds, trace,
                       time.perf_counter(), device="cpu")


@pytest.mark.parametrize("workload", TRAIN + SERVE)
def test_dry_run(workload):
    result, lines, err = _execute(workload)
    assert result["correct"], err
    assert result["attempted"] >= 1 and result["failed"] == 0
    names = {m["name"] for m in run.cell_metrics(manifest(), run_cell(workload), False)}
    assert set(result["metrics"]) == names
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert list(result)[-1] == "checks"
    assert err[-len(result["checks"]):] == [
        f"check {k} {v['value']} limit {v['limit']}" for k, v in result["checks"].items()]
    json.dumps(result)


def run_cell(workload):
    return cell(workload)


@pytest.mark.parametrize("workload", [TRAIN[0], SERVE[0]])
def test_traced_dry_run(workload):
    # long enough that the profiled steps (the window's third to fifth) or
    # scene (its second) come
    result, _, err = _execute(workload, trace=True, seconds=6.0)
    assert result["correct"], err
    want = {m["name"] for m in run.cell_metrics(manifest(), run_cell(workload), True)}
    # the CPU has no device trace: only the spans' and the counts' metrics
    got = set(result["metrics"])
    assert got and got <= want
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("workload,fault", [
    (TRAIN[0], "frozen_state"), (TRAIN[0], "half_batch"),
    (TRAIN[1], "frozen_state"), (TRAIN[1], "half_batch"),
    (SERVE[0], "altered_answer"), (SERVE[1], "altered_answer")])
def test_fault_is_not_correct(workload, fault):
    undo = faults.FAULTS[fault]()
    try:
        result, _, err = _execute(workload)
    finally:
        undo()
    assert result["correct"] is False, err


def test_main_without_a_card_prints_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", TRAIN[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


@pytest.mark.card
def test_main_on_the_card(card, capsys):
    rc = run.main(["--workload", TRAIN[0], "--seed", str(2**31 + 7), "--seconds", "2",
                   "--trace", "0"])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    result = json.loads(out[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"


@pytest.mark.parametrize("workload", [TRAIN[0], TRAIN[1], SERVE[0]])
def test_control_is_not_correct(workload):
    """The reference with fp8 conv operands in the program's place fails
    the cell's limits (at the tests' tiny size; the limits are set from the
    chip's readings at the cell's own)."""
    from benchmark.tools import calibrate

    cell, config, traffic = (tiny_train if workload in TRAIN else tiny_serve)(workload)
    readings = calibrate.train_readings if workload in TRAIN else calibrate.serve_readings
    got = dict(readings(config, traffic, 2**31 + 99, True, False, device="cpu"))
    limits = load(HERE, "limits", f"{workload}.json")
    assert run.judge(got["program"], limits) is None
    control = {k: v for k, v in got["control"].items() if k in limits}
    assert control and run.judge(control, {k: limits[k] for k in control}) is not None
