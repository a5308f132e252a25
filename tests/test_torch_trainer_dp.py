"""The data-parallel trainer: the port's ``Trainer`` with
``training.num_devices`` 2 in two gloo CPU ranks (started by
``parallel.launch.spawn``) against the JAX package's ``Trainer`` with
``num_devices`` 2 on the virtual CPU devices, configured as
``test_torch_trainer.py``'s fixture (synthetic tiles of the 9-class layout,
tiny plan, f32; synchronous sampling) with 1 tile per device and 4
samples an epoch: 2 steps of the prepare phase and a validation, from the
same weights (the JAX trainer's, loaded into rank 0 and replicated).

Compared: ``steps_per_epoch`` (the global batch divides the samples); each
rank's tiles of every step, exactly, against that device's slice of the
JAX step's stacked batch; the first step's losses (rtol 1e-4, atol 1e-5)
and the second's (rtol 1e-3, atol 1e-4: Adam moves weight elements whose
gradient rounds differently by up to the lr, as in
``test_torch_trainer.py``); the validation metrics, equal; the ranks'
replicas bit-identical; one ``metrics.jsonl`` line a run (rank 0 alone
writes); a resume in both ranks to epoch 2. Then the train CLI with
``training.num_devices=2 device=cpu`` and its refusal of more ranks than
visible cards."""

import json
import os.path as osp

import jax
import numpy as np
import pytest
import torch

from panopticsegforlargescalepointcloud_tpu.train.trainer import Trainer as JTrainer
from panopticsegforlargescalepointcloud_tpu_torch.cli import train as cli_train
from panopticsegforlargescalepointcloud_tpu_torch.config import load_config
from panopticsegforlargescalepointcloud_tpu_torch.parallel import (
    replica_checksum,
    replicate,
    spawn,
)
from panopticsegforlargescalepointcloud_tpu_torch.train.checkpoint import ModelCheckpoint
from panopticsegforlargescalepointcloud_tpu_torch.train.trainer import Trainer
from panopticsegforlargescalepointcloud_tpu_torch.weights import params_from_flax

torch.set_num_threads(2)

CONF = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "conf")
OVERRIDES = ["training.epochs=1", "training.batch_size=1", "training.samples_per_epoch=4",
             "training.num_devices=2", "training.num_workers=0", "data=panoptic/treeins_rad8"]
BUDGETS = dict(in_feat=8, max_instances=16, max_props_rg=32, ms_max_seeds=32,
               ms_max_clusters=8, ms_point_cap=1024, cluster_radius=0.9, min_cluster_points=20,
               prepare_epoch=30, compute_dtype="float32", min_score=0.0)
JAX_ONLY = dict(rg_dense="on", use_winconv="off")
FIRST = dict(rtol=1e-4, atol=1e-5)
LATER = dict(rtol=1e-3, atol=1e-4)


def _cfg():
    cfg = load_config(CONF, OVERRIDES)
    cfg["data"]["class"] = "npm3d"  # synthetic tiles have the 9-class layout
    return cfg


def _trainer_worker(mesh, run_dir, state_dict):
    """One rank: the trainer on the mesh with rank 0's weights replicated;
    its prepare step wrapped to record this rank's arrays and metrics. Then
    a second trainer on the same run directory resumes to epoch 2."""
    torch.set_num_threads(1)
    tr = Trainer(_cfg(), capacity=4096, backbone="tiny", checkpoint_dir=run_dir, device="cpu",
                 mesh=mesh, **BUDGETS)
    if mesh.is_root:
        tr.model.load_state_dict(state_dict, strict=True)
    replicate(mesh, tr.model)
    steps = []
    step = tr._prepare_step

    def recorded(arrays, bn_momentum):
        out = step(arrays, bn_momentum)
        steps.append(dict(arrays=[a.numpy().copy() for a in arrays],
                          metrics={k: float(v) for k, v in out.items()}))
        return out

    tr._prepare_step = recorded
    vals = []
    validate = tr._validate

    def validated(epoch, num_batches):
        vals.append(validate(epoch, num_batches))
        return vals[-1]

    tr._validate = validated
    try:
        tr.train()
    finally:
        tr.close()
    out = dict(steps=steps, steps_per_epoch=tr.steps_per_epoch, step=tr.state.step,
               checksum=replica_checksum(tr.model), val=vals)
    again = Trainer(_cfg(), capacity=4096, backbone="tiny", checkpoint_dir=run_dir,
                    device="cpu", mesh=mesh, **BUDGETS)
    out["resumed"] = dict(start_epoch=again.start_epoch, step=again.state.step,
                          checksum=replica_checksum(again.model))
    try:
        again.train(epochs=2)
    finally:
        again.close()
    out["resumed"].update(step_after=again.state.step, checksum_after=replica_checksum(again.model))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer_dp")
    jt = JTrainer(_cfg(), capacity=4096, backbone="tiny", checkpoint_dir=str(tmp / "jax"),
                  **BUDGETS, **JAX_ONLY)
    params = jax.tree.map(np.asarray, jax.device_get(jt.state.params))
    stats = jax.tree.map(np.asarray, jax.device_get(jt.state.batch_stats))
    state_dict = {k: torch.from_numpy(np.array(v))
                  for k, v in params_from_flax(params, stats).items()}
    jsteps = []
    step = jt._prepare_step

    def recorded(state, arrays):
        new_state, metrics = step(state, arrays)
        jsteps.append(dict(arrays=[np.asarray(a) for a in arrays],
                           metrics={k: float(v) for k, v in metrics.items()}))
        return new_state, metrics

    jt._prepare_step = recorded
    jt.train()
    ranks = spawn(_trainer_worker, ["cpu", "cpu"], str(tmp / "port"), state_dict)
    return dict(tmp=tmp, jt=jt, jsteps=jsteps, ranks=ranks)


def _metrics_lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_steps_per_epoch_matches_jax(runs):
    assert runs["jt"].num_devices == 2 and runs["jt"].steps_per_epoch == 2
    assert all(r["steps_per_epoch"] == 2 for r in runs["ranks"])


def test_rank_tiles_are_the_jax_device_slices(runs):
    for rank, r in enumerate(runs["ranks"]):
        assert len(r["steps"]) == len(runs["jsteps"]) == 2
        for got, want in zip(r["steps"], runs["jsteps"]):
            for a, b in zip(got["arrays"], want["arrays"]):
                np.testing.assert_array_equal(a, b[rank])


@pytest.mark.parametrize("i", [0, 1])
def test_step_losses_match_jax(runs, i):
    want = runs["jsteps"][i]["metrics"]
    for r in runs["ranks"]:
        got = r["steps"][i]["metrics"]
        assert set(want) <= set(got)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, **(FIRST if i == 0 else LATER), err_msg=k)


def test_validation_metrics_match_jax(runs):
    want = runs["jt"].checkpoint._data["stats"]["val"]
    for r in runs["ranks"]:
        assert len(r["val"]) == len(want) == 1
        assert set(r["val"][0]) == set(want[0])
        for k, v in want[0].items():
            assert r["val"][0][k] == v, k


def test_replicas_and_one_writer(runs):
    """After the first run: equal replicas, one log line and one
    checkpoint epoch; the resume (every rank loads, then replicates) goes
    on to epoch 2 with the count at 4 and the log at two lines."""
    a, b = runs["ranks"]
    assert a["checksum"] == b["checksum"] and a["step"] == b["step"] == 2
    port = runs["tmp"] / "port"
    lines = _metrics_lines(port / "metrics.jsonl")
    assert [line["step"] for line in lines] == [2, 4]
    assert ModelCheckpoint(str(port)).start_epoch == 3
    for r in (a, b):
        res = r["resumed"]
        assert res["start_epoch"] == 2 and res["step"] == 2 and res["step_after"] == 4
        assert res["checksum"] == a["checksum"]
    assert a["resumed"]["checksum_after"] == b["resumed"]["checksum_after"] != a["checksum"]


def test_cli_trains_on_two_ranks(tmp_path):
    run_dir = tmp_path / "run"
    args = OVERRIDES + ["backbone=tiny", "data.class=npm3d", "data.voxel_capacity=4096",
                        f"checkpoint_dir={run_dir}", "device=cpu", "pretty_print=False",
                        "models.PointGroup-PAPER.feat_size=8",
                        "models.PointGroup-PAPER.ms_point_cap=1024"]
    ranks = cli_train.main(args)
    assert [r["rank"] for r in ranks] == [0, 1]
    assert ranks[0]["checksum"] == ranks[1]["checksum"]
    assert all(r["step"] == 2 and r["start_epoch"] == 1 for r in ranks)
    assert len(_metrics_lines(run_dir / "metrics.jsonl")) == 1
    assert (run_dir / "config_composed.yaml").exists()


def test_cli_refuses_more_ranks_than_cards(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="num_devices=2 but only 1 CUDA devices"):
        cli_train.main(OVERRIDES + [f"checkpoint_dir={tmp_path}", "pretty_print=False"])
