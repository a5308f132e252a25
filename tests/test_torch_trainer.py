"""The port's ``Trainer`` against the JAX package's, configured as
``tests/test_trainer.py``'s fixture (synthetic tiles of the 9-class layout,
tiny plan, 2 tiles in 4,096 rows, 2 epochs of 2 steps, the full phase in
epoch 2, two prefetch workers), from the same weights: the JAX trainer's
initial ``params``/``batch_stats`` are loaded into the port's model with
``params_from_flax`` before either trains; both optimizers start fresh.
Both run in f32 and keep every cluster whatever its score (``min_score``
0, so that the untrained model's validation has instances to measure); the
JAX side also takes ``rg_dense="on"`` and
``use_winconv="off"``, the paths the port computes (it has the dense pull
only and no TPU conv), so those two switches are JAX-only overrides.

Tolerances:

* the first train step's losses: rtol 1e-4, atol 1e-5 (the train step's);
* the later steps' losses and the per-epoch means: rtol 1e-3 and atol
  1e-4. Measured worst cases: 1.9e-5 absolute (step 3, ``ins_var_loss``)
  and 7.0e-4 relative (step 3, ``offset_dir_loss``, 2.0e-7 absolute). Adam
  normalizes each gradient element, so elements near 0 whose f32 rounding
  differs take updates up to the lr apart, and the weights drift apart after
  step 1;
* ``eval_epoch`` on the shared initial weights, before any step: mIoU, acc,
  macc and the instance metrics exactly equal; after training within 5e-3
  (measured: equal, 0 difference);
* the learning-rate and step bookkeeping exactly.

Then the port alone: resume (``start_epoch`` and the step count as the JAX
package sets them), the train CLI's ``config_composed.yaml`` (the text the
JAX CLI writes) and its ``metrics.jsonl`` (one line per epoch, the JAX
trainer's keys), the trainer's refusal of more than one device outside a
mesh, the
trainer, the train CLI and the learning run defaulting to the GPU; and the
validation's PLY dumps (``Visualizer``) byte for byte against the JAX
package's."""

import json
import os.path as osp

import jax
import numpy as np
import pytest
import torch
import yaml

from panopticsegforlargescalepointcloud_tpu.config import load_config as j_load_config
from panopticsegforlargescalepointcloud_tpu.eval.visualizer import Visualizer as JVisualizer
from panopticsegforlargescalepointcloud_tpu.train.trainer import Trainer as JTrainer
from panopticsegforlargescalepointcloud_tpu_torch import smoke_learning
from panopticsegforlargescalepointcloud_tpu_torch.cli import train as cli_train
from panopticsegforlargescalepointcloud_tpu_torch.config import load_config
from panopticsegforlargescalepointcloud_tpu_torch.eval.visualizer import Visualizer
from panopticsegforlargescalepointcloud_tpu_torch.train.trainer import Trainer
from panopticsegforlargescalepointcloud_tpu_torch.weights import params_from_flax

torch.set_num_threads(2)

CONF = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "conf")
OVERRIDES = ["training.epochs=2", "training.batch_size=2", "training.samples_per_epoch=4",
             "data=panoptic/treeins_rad8"]
BUDGETS = dict(in_feat=8, max_instances=16, max_props_rg=32, ms_max_seeds=32,
               ms_max_clusters=8, ms_point_cap=1024, cluster_radius=0.9, min_cluster_points=20,
               prepare_epoch=1, compute_dtype="float32", min_score=0.0)
JAX_ONLY = dict(rg_dense="on", use_winconv="off")
FIRST = dict(rtol=1e-4, atol=1e-5)
LATER = dict(rtol=1e-3, atol=1e-4)
EVAL_AFTER = 5e-3
INSTANCE_KEYS = ["pos", "neg", "Iacc", "cov", "wcov", "mIPre", "mIRec", "F1"]


def _cfg():
    cfg = load_config(CONF, OVERRIDES)
    cfg["data"]["class"] = "npm3d"  # synthetic tiles have the 9-class layout
    return cfg


def _recorded(step, out, unpack):
    def run(*args):
        res = step(*args)
        out.append({k: float(v) for k, v in unpack(res).items()})
        return res

    return run


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer")
    jt = JTrainer(_cfg(), capacity=4096, backbone="tiny", checkpoint_dir=str(tmp / "jax"),
                  **BUDGETS, **JAX_ONLY)
    pt = Trainer(_cfg(), capacity=4096, backbone="tiny", checkpoint_dir=str(tmp / "port"),
                 device="cpu", **BUDGETS)
    params = jax.tree.map(np.asarray, jt.state.params)
    stats = jax.tree.map(np.asarray, jt.state.batch_stats)
    pt.model.load_state_dict(params_from_flax(params, stats), strict=True)

    before = (jt.eval_epoch(2, num_batches=1), pt.eval_epoch(2, num_batches=1))
    jsteps, psteps = [], []
    jt._prepare_step = _recorded(jt._prepare_step, jsteps, lambda r: r[1])
    build = jt._build_full
    jt._build_full = lambda epoch: _recorded(build(epoch), jsteps, lambda r: r[1])
    pt._prepare_step = _recorded(pt._prepare_step, psteps, lambda r: r)
    full_for = pt._full_step_for
    pt._full_step_for = lambda epoch: _recorded(full_for(epoch), psteps, lambda r: r)
    jt.train()
    pt.train()
    pt.close()
    after = (jt.eval_epoch(2, num_batches=1), pt.eval_epoch(2, num_batches=1))
    return dict(tmp=tmp, jt=jt, pt=pt, before=before, after=after, steps=(jsteps, psteps))


def test_first_step_losses_match_jax(runs):
    jsteps, psteps = runs["steps"]
    assert len(jsteps) == len(psteps) == 4
    assert set(psteps[0]) == set(jsteps[0])
    for k, v in jsteps[0].items():
        np.testing.assert_allclose(psteps[0][k], v, **FIRST, err_msg=k)


def _shared(want, got):
    """Both report the same terms; ``rg_graph_trunc``, the rows whose edges
    region growing's edge path truncated, is 0 on the dense path of both."""
    assert set(want) == set(got)
    assert want.get("rg_graph_trunc", 0) == got.get("rg_graph_trunc", 0) == 0
    return list(want)


def test_later_step_losses_match_jax(runs):
    jsteps, psteps = runs["steps"]
    for i, (want, got) in enumerate(zip(jsteps[1:], psteps[1:]), 2):
        assert "score_loss" in got if i > 2 else "score_loss" not in got
        for k in _shared(want, got):
            np.testing.assert_allclose(got[k], want[k], **LATER, err_msg=f"step {i} {k}")


def _metrics_lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_epoch_metrics_match_jax(runs):
    """The run logs: one line per epoch, the same keys and steps, the same
    lr, and per-epoch means as the steps'."""
    tmp = runs["tmp"]
    want = _metrics_lines(tmp / "jax" / "metrics.jsonl")
    got = _metrics_lines(tmp / "port" / "metrics.jsonl")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        w = {k.replace("train_", "", 1): v for k, v in w.items()}
        g = {k.replace("train_", "", 1): v for k, v in g.items()}
        assert g["step"] == w["step"] and g["lr"] == pytest.approx(w["lr"], rel=1e-6)
        for k in _shared(w, g):
            if k not in ("ts", "step", "lr") and not k.startswith("time_"):
                np.testing.assert_allclose(g[k], w[k], **LATER, err_msg=k)


def test_eval_before_training_matches_jax_exactly(runs):
    want, got = runs["before"]
    assert set(got) == set(want)
    assert all(k in got for k in INSTANCE_KEYS + ["miou", "acc", "macc"])
    for k, v in want.items():
        assert got[k] == v, k


def test_eval_after_training_matches_jax(runs):
    want, got = runs["after"]
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=EVAL_AFTER), k


def test_state_and_checkpoint_bookkeeping(runs):
    jt, pt = runs["jt"], runs["pt"]
    assert pt.state.step == int(jt.state.step) == 4
    assert pt.optimizer.param_groups[0]["count"] == 4
    assert pt.state.bn_momentum == pytest.approx(float(jt.state.bn_momentum))
    assert pt.checkpoint.start_epoch == jt.checkpoint.start_epoch == 3
    assert sorted(pt.checkpoint.weight_names) == sorted(jt.checkpoint._data["models"])


def test_resume_continues_the_count(runs):
    pt = runs["pt"]
    t2 = Trainer(_cfg(), capacity=4096, backbone="tiny",
                 checkpoint_dir=str(runs["tmp"] / "port"), device="cpu", **BUDGETS)
    try:
        assert t2.start_epoch == 3
        # the JAX package sets step = (start_epoch - 1) * steps_per_epoch
        assert t2.state.step == (t2.start_epoch - 1) * t2.steps_per_epoch == 4
        assert t2.optimizer.param_groups[0]["count"] == 4
        for (k, a), b in zip(pt.model.state_dict().items(), t2.model.state_dict().values()):
            assert torch.equal(a, b), k
        st = t2.optimizer.state_dict()["state"]
        for i, s in pt.optimizer.state_dict()["state"].items():
            assert torch.equal(s["exp_avg"], st[i]["exp_avg"])
        t2.train(epochs=3)
        assert t2.state.step == 6 and t2.optimizer.param_groups[0]["count"] == 6
        assert len(_metrics_lines(runs["tmp"] / "port" / "metrics.jsonl")) == 3
    finally:
        t2.close()


def test_cli_train_run_dir_and_logs(tmp_path):
    run_dir = tmp_path / "run"
    args = OVERRIDES + ["backbone=tiny", "data.class=npm3d", "data.voxel_capacity=4096",
                        f"checkpoint_dir={run_dir}", "device=cpu", "pretty_print=False",
                        "training.num_workers=0", "models.PointGroup-PAPER.feat_size=8",
                        "models.PointGroup-PAPER.prepare_epoch=1",
                        "models.PointGroup-PAPER.ms_point_cap=1024"]
    trainer = cli_train.main(args)
    composed = (run_dir / "config_composed.yaml").read_text()
    assert composed == yaml.safe_dump(j_load_config(CONF, args), default_flow_style=None)
    lines = _metrics_lines(run_dir / "metrics.jsonl")
    assert [line["step"] for line in lines] == [2, 4]
    assert trainer.checkpoint.start_epoch == 3 and trainer.state.step == 4
    # the same run directory resumes
    again = cli_train.main([a.replace("epochs=2", "epochs=3") for a in args])
    assert again.start_epoch == 3 and again.state.step == 6
    assert len(_metrics_lines(run_dir / "metrics.jsonl")) == 3


def test_trainer_refuses_more_devices_and_defaults_to_gpu(tmp_path):
    cfg = _cfg()
    cfg["training"]["num_devices"] = 2
    # more than one device runs in the ranks of a mesh (tests/test_torch_trainer_dp.py)
    with pytest.raises(ValueError, match="each rank of a mesh of 2 ranks"):
        Trainer(cfg, capacity=4096, backbone="tiny", device="cpu", **BUDGETS)
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(_cfg(), capacity=4096, backbone="tiny", **BUDGETS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_train.main(OVERRIDES + [f"checkpoint_dir={tmp_path / 'gpu'}", "pretty_print=False"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        smoke_learning.run(epochs=1, steps=1)


def test_visualizer_dumps_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    n = 300
    arrays = dict(pos=rng.normal(size=(n, 3)).astype(np.float32), mask=rng.random(n) < 0.8,
                  y=rng.integers(-1, 3, n), pred_sem=rng.integers(0, 3, n))
    extra = dict(instance_labels=rng.integers(0, 4, n), pred_instance=rng.integers(-1, 4, n),
                 offsets=rng.normal(size=(n, 3)).astype(np.float32),
                 embeds=rng.normal(size=(n, 5)).astype(np.float32))
    paths = []
    for cls, d in ((Visualizer, "port"), (JVisualizer, "jax")):
        viz = cls(out_dir=str(tmp_path / d), num_samples_per_epoch=2)
        viz.begin_epoch(3)
        got = [viz.maybe_save(**arrays, **extra), viz.maybe_save(**arrays),
               viz.maybe_save(**arrays)]
        assert got[2] is None  # the epoch's budget is spent
        paths.append(got[:2])
    for a, b in zip(*paths):
        assert open(a, "rb").read() == open(b, "rb").read()
