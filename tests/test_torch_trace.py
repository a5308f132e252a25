"""The port's span-and-counter recorder (``utils/trace.py``): nesting,
parent and unit ids, counts in the innermost span, per-thread stacks and a
unit handed to another thread, the cap and its drop count, the recorder
off, spans that record alone, ``host_read`` on CPU tensors;
then the program's phases as a ``timer(name)`` hook sees them in a tiny
CPU eval forward, train step and served scene, pinned to the list the hook
saw before the recorder stood behind it, and the spans and counts the
recorder keeps there."""

import contextlib
import os
import threading

import numpy as np
import pytest
import torch

from panopticsegforlargescalepointcloud_tpu_torch.cli import eval as cli_eval
from panopticsegforlargescalepointcloud_tpu_torch.config import load_config
from panopticsegforlargescalepointcloud_tpu_torch.data import batch_arrays, collate_tiles
from panopticsegforlargescalepointcloud_tpu_torch.data.ply import write_ply
from panopticsegforlargescalepointcloud_tpu_torch.data.synthetic import synthetic_tile
from panopticsegforlargescalepointcloud_tpu_torch.models.pointgroup3heads import (
    PanopticConfig, PointGroup3HeadsNet)
from panopticsegforlargescalepointcloud_tpu_torch.train import make_lr_schedule, make_train_step
from panopticsegforlargescalepointcloud_tpu_torch.train.checkpoint import ModelCheckpoint
from panopticsegforlargescalepointcloud_tpu_torch.train.optim import make_optimizer
from panopticsegforlargescalepointcloud_tpu_torch.train.step import make_eval_forward
from panopticsegforlargescalepointcloud_tpu_torch.utils import trace

torch.set_num_threads(2)

CAPACITY = 4096
CFG = dict(backbone="tiny", feat_dim=4, in_feat=8, max_instances=16, max_props_rg=32,
           ms_max_seeds=32, ms_max_clusters=8, ms_point_cap=1024, cluster_radius=0.9,
           min_cluster_points=10, rg_point_cap=0.5, compute_dtype="float32")
FORWARD = ["hierarchy", "backbone_heads", "region_growing", "mean_shift", "scorenet"]
# the hook's names of one step and of one dispatch of a scene, as the
# program's phases were before the recorder
TRAIN_STEP = FORWARD + ["losses", "backward", "optimizer"]
DISPATCH = ["collate"] + FORWARD + ["extract", "extract", "merge"]
# Setting I's full step (the embed family, strategy 7): mean shift on the
# embedding is the only clustering, and no ScoreNet runs
EMBED_STEP = ["hierarchy", "backbone_heads", "mean_shift", "losses", "backward", "optimizer"]


class Hook:
    """A ``timer(name)`` hook that keeps the names it is handed, in order."""

    def __init__(self):
        self.names = []

    def __call__(self, name):
        self.names.append(name)
        return contextlib.nullcontext()


def _by_id(records):
    return {r.id: r for r in records}


def _children(records, parent):
    return [r.name for r in sorted(records, key=lambda r: r.start_ns) if r.parent == parent.id]


@pytest.fixture
def recorder():
    trace.drain()
    yield trace.RECORDER
    trace.drain()


def test_nesting_parents_and_units():
    rec = trace.Recorder()
    with rec.span("step", on=True):
        with rec.span("forward"):
            with rec.span("conv"):
                pass
        with rec.span("backward"):
            pass
    with rec.span("scene", on=True):
        pass
    by = {r.name: r for r in rec.records}
    assert by["step"].parent == 0 and by["step"].unit == by["step"].id
    assert by["forward"].parent == by["step"].id
    assert by["conv"].parent == by["forward"].id
    assert by["backward"].parent == by["step"].id
    assert {by[n].unit for n in ("forward", "conv", "backward")} == {by["step"].id}
    assert by["scene"].parent == 0 and by["scene"].unit == by["scene"].id != by["step"].id
    assert len({r.id for r in rec.records}) == 5
    for r in rec.records:
        assert r.start_ns <= r.end_ns
    assert by["step"].start_ns <= by["conv"].start_ns <= by["conv"].end_ns <= by["step"].end_ns


def test_counts_land_in_the_innermost_span():
    rec = trace.Recorder()
    with rec.span("step", on=True):
        rec.count("grow_rounds")
        with rec.span("cluster"):
            rec.count("grow_rounds", 2)
            rec.count("grow_rounds")
            with rec.host_read("grow"):
                pass
        rec.count("other")
    by = {r.name: r for r in rec.records}
    assert by["step"].counts == {"grow_rounds": 1, "other": 1}
    assert by["cluster"].counts == {"grow_rounds": 3}
    assert by["sync::grow"].counts == {"host_syncs": 1}
    assert by["sync::grow"].parent == by["cluster"].id


def test_stacks_are_per_thread():
    rec = trace.Recorder()
    seen = {}

    def work():
        seen["open"] = rec.innermost()
        with rec.span("prefetch"):
            rec.count("tiles")
            seen["inside"] = rec.innermost()

    with rec.span("step", on=True):
        with rec.span("forward"):
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
            assert rec.innermost() == "forward"
    by = {r.name: r for r in rec.records}
    # the other thread's span is a root of its own: it does not nest into
    # the step that turned the recorder on
    assert seen == {"open": None, "inside": "prefetch"}
    assert by["prefetch"].parent == 0 and by["prefetch"].unit == by["prefetch"].id
    assert by["prefetch"].counts == {"tiles": 1}
    assert by["forward"].parent == by["step"].id and by["forward"].counts is None


def test_cap_drops_and_counts_the_rest():
    rec = trace.Recorder(cap=3)
    with rec.span("root", on=True):
        for _ in range(5):
            with rec.span("leaf"):
                pass
    assert [r.name for r in rec.records] == ["leaf"] * 3
    assert rec.dropped == 3  # two leaves and the root
    assert len(rec.drain()) == 3 and rec.records == []
    with rec.span("again", on=True):
        pass
    assert [r.name for r in rec.records] == ["again"]


def test_off_records_nothing():
    rec = trace.Recorder()
    assert rec.span("forward") is trace.NULL
    assert rec.phase(None, "hierarchy") is trace.NULL
    assert rec.host_read("grow") is trace.NULL
    with rec.host_read("grow"):
        rec.count("grow_rounds")
    assert rec.records == [] and rec.dropped == 0
    assert trace.phase(None, "hierarchy") is trace.NULL
    assert trace.span("conv_backward") is trace.NULL
    assert trace.host_read("pull") is trace.NULL


def test_alone_spans_record_themselves_and_turn_nothing_on():
    rec = trace.Recorder()
    with rec.span("data", alone=True) as data:
        # the recorder stays off below an alone span
        assert rec.span("collate") is trace.NULL and rec.host_read("batch") is trace.NULL
        assert rec.unit() == 0
    with rec.span("step", alone=True) as step:
        with rec.span("train_step", on=True):
            with rec.span("forward"):
                pass
    by = {r.name: r for r in rec.records}
    assert set(by) == {"data", "step", "train_step", "forward"}
    # no span takes an alone span for its parent: the step's unit is its own
    assert by["train_step"].parent == 0 and by["forward"].parent == by["train_step"].id
    assert rec.take(step) is by["step"] and rec.take(data) is by["data"]
    # the owner takes its own records and leaves the others
    assert [r.name for r in rec.records] == ["forward", "train_step"]
    assert by["data"].start_ns <= by["data"].end_ns <= by["step"].start_ns


def test_unit_handed_to_another_thread():
    rec = trace.Recorder()
    assert rec.unit() == 0
    seen = {}

    def backward(unit):
        seen["own"] = rec.unit()
        with rec.span("conv_backward", unit=unit):
            with rec.span("kernel"):
                pass

    with rec.span("train_step", on=True):
        with rec.span("forward"):
            unit = rec.unit()
        t = threading.Thread(target=backward, args=(unit,))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        stray = threading.Thread(target=backward, args=(0,))
        stray.start()
        stray.join(timeout=10)
    step = next(r for r in rec.records if r.name == "train_step")
    handed, own = [r for r in rec.records if r.name == "conv_backward"]
    assert unit == step.id and seen["own"] == 0
    # handed the unit, the other thread's span is a child of the unit's root
    assert (handed.parent, handed.unit) == (step.id, step.id)
    kernels = [r for r in rec.records if r.name == "kernel"]
    assert (kernels[0].parent, kernels[0].unit) == (handed.id, step.id)
    # not handed one, it is a root of its own
    assert (own.parent, own.unit) == (0, own.id)


def test_phase_forwards_and_records_inside_the_hook():
    rec = trace.Recorder()
    order = []

    @contextlib.contextmanager
    def hook(name):
        order.append(("open", name))
        yield
        order.append(("close", name))

    with rec.phase(hook, "hierarchy"):
        order.append(("body", rec.innermost()))
    assert order == [("open", "hierarchy"), ("body", "hierarchy"), ("close", "hierarchy")]
    (r,) = rec.records
    # a hooked phase turns the recorder on by itself
    assert (r.name, r.parent, r.unit) == ("hierarchy", 0, r.id)


def test_host_read_counts_cpu_reads():
    rec = trace.Recorder()
    x = torch.arange(6)
    with rec.span("step", on=True):
        for _ in range(3):
            with rec.host_read("flag"):
                assert bool((x > 2).any())
        with rec.host_read("pull"):
            host = x.cpu().numpy()
        with rec.host_read("upload", 2):  # two tensors in one read
            x.clone(), x.clone()
    assert host.tolist() == list(range(6))
    syncs = [r for r in rec.records if r.name.startswith("sync::")]
    assert [r.name for r in syncs] == ["sync::flag"] * 3 + ["sync::pull", "sync::upload"]
    assert sum(r.counts["host_syncs"] for r in syncs) == 6
    root = next(r for r in rec.records if r.name == "step")
    assert {r.parent for r in syncs} == {root.id}


def _arrays(num_classes, stuff, tiles, seed):
    rng = np.random.default_rng(seed)
    vb = collate_tiles([synthetic_tile(rng, num_classes=num_classes, stuff_classes=stuff,
                                       n_instances=4, n_ground=1200, radius=5.0)
                        for _ in range(tiles)], capacity=CAPACITY, num_tiles=tiles)
    return batch_arrays(vb)


def _model(cfg, seed):
    torch.manual_seed(seed)
    return PointGroup3HeadsNet(cfg)


def test_eval_forward_phases(recorder):
    cfg = PanopticConfig(num_classes=9, stuff_classes=(0, 7, 8), num_samples=1, **CFG)
    hook = Hook()
    fwd = make_eval_forward(cfg, _model(cfg, 0), device="cpu", timer=hook)
    fwd(_arrays(9, (0, 7, 8), 1, 1))
    assert hook.names == FORWARD
    recs = trace.drain()
    phases = [r.name for r in sorted(recs, key=lambda r: r.start_ns)
              if not r.name.startswith("sync::") and r.name != "ms_dedup"]
    assert phases == FORWARD
    # with no unit open, each hooked phase is a root, and the host reads of
    # region growing's rounds, the dedup (inside mean shift's ms_dedup span)
    # and the constants land inside them
    assert {r.parent for r in recs if r.name in FORWARD} == {0}
    by = _by_id(recs)
    (dedup,) = [r for r in recs if r.name == "ms_dedup"]
    assert by[dedup.parent].name == "mean_shift"
    inner = [r for r in recs if r.name.startswith("sync::")]
    assert inner and all(by[r.parent].name in FORWARD for r in inner
                         if r.name != "sync::dedup")
    assert {r.parent for r in inner if r.name == "sync::dedup"} == {dedup.id}
    assert sum((r.counts or {}).get("grow_rounds", 0) for r in recs
               if r.name == "region_growing") >= 1


def test_train_step_phases(recorder):
    cfg = PanopticConfig(num_classes=9, stuff_classes=(0, 7, 8), num_samples=2, **CFG)
    model = _model(cfg, 1).to("cpu")
    opt = make_optimizer("Adam", model.parameters(), 0.0)
    hook = Hook()
    step = make_train_step(cfg, model, opt, make_lr_schedule("ExponentialLR", {}, 1e-3, 750),
                           with_clustering=True, device="cpu", timer=hook)
    metrics = step(_arrays(9, (0, 7, 8), 2, 2), 0.1)
    assert np.isfinite(float(metrics["loss"]))
    assert hook.names == TRAIN_STEP
    recs = trace.drain()
    (root,) = [r for r in recs if r.parent == 0]
    assert root.name == "train_step" and {r.unit for r in recs} == {root.id}
    assert _children(recs, root) == TRAIN_STEP
    by = _by_id(recs)
    conv_bw = [r for r in recs if r.name == "conv_backward"]
    # the CPU runs the backward on the calling thread: every conv's
    # backward nests in the backward phase
    assert conv_bw and {by[r.parent].name for r in conv_bw} == {"backward"}
    syncs = [r for r in recs if r.name.startswith("sync::")]
    assert {"sync::batch", "sync::grow", "sync::bn_momentum"} <= {r.name for r in syncs}
    assert sum(r.counts["host_syncs"] for r in syncs) == len(syncs)
    rounds = sum((r.counts or {}).get("grow_rounds", 0) for r in recs)
    assert rounds == sum(r.name == "sync::grow" for r in recs) >= 1


def test_train_step_uploads_the_bn_momentum_once(recorder):
    """One ``sync::bn_momentum`` a step, in its hierarchy phase with the
    batch's uploads, however many BNs the backbone, heads and ScoreNet
    run."""
    cfg = PanopticConfig(num_classes=9, stuff_classes=(0, 7, 8), num_samples=2, **CFG)
    model = _model(cfg, 1).to("cpu")
    opt = make_optimizer("Adam", model.parameters(), 0.0)
    step = make_train_step(cfg, model, opt, make_lr_schedule("ExponentialLR", {}, 1e-3, 750),
                           with_clustering=True, device="cpu", timer=Hook())
    arrays = _arrays(9, (0, 7, 8), 2, 2)
    for _ in range(2):
        step(arrays, 0.1)
    recs = trace.drain()
    roots = [r for r in recs if r.parent == 0]
    assert [r.name for r in roots] == ["train_step"] * 2
    by = _by_id(recs)
    for root in roots:
        reads = [r for r in recs if r.unit == root.id and r.name == "sync::bn_momentum"]
        assert len(reads) == 1 and reads[0].counts == {"host_syncs": 1}
        phase = by[reads[0].parent]
        assert phase.name == "hierarchy" and phase.parent == root.id


def test_embed_train_step_phases(recorder):
    cfg = PanopticConfig(num_classes=9, stuff_classes=(0, 7, 8), num_samples=2,
                         model_family="embed", cluster_type=7, use_score_net=False, **CFG)
    model = _model(cfg, 3).to("cpu")
    opt = make_optimizer("Adam", model.parameters(), 0.0)
    hook = Hook()
    step = make_train_step(cfg, model, opt, make_lr_schedule("ExponentialLR", {}, 1e-3, 750),
                           with_clustering=True, device="cpu", timer=hook)
    metrics = step(_arrays(9, (0, 7, 8), 2, 3), 0.1)
    assert np.isfinite(float(metrics["loss"])) and "score_loss" not in metrics
    assert hook.names == EMBED_STEP
    recs = trace.drain()
    (root,) = [r for r in recs if r.parent == 0]
    assert root.name == "train_step" and _children(recs, root) == EMBED_STEP
    by = _by_id(recs)
    # one mean-shift call, whose dedup is one ms_dedup span: each round of
    # its loop is one sync::dedup host read and one ms_dedup_rounds count
    (dedup,) = [r for r in recs if r.name == "ms_dedup"]
    assert by[dedup.parent].name == "mean_shift"
    reads = [r for r in recs if r.name == "sync::dedup"]
    assert 1 <= len(reads) <= cfg.ms_max_seeds and {r.parent for r in reads} == {dedup.id}
    assert dedup.counts == {"ms_dedup_rounds": len(reads)}
    assert sum((r.counts or {}).get("ms_dedup_rounds", 0) for r in recs) == len(reads)
    assert not any(r.name in ("region_growing", "scorenet", "sync::grow") for r in recs)


def _forest(path, seed):
    rng = np.random.default_rng(seed)
    pts, sem, tid = [], [], []
    for t in range(4):
        c = rng.uniform(2, 12, 2)
        pts.append(np.concatenate([c + rng.normal(scale=0.5, size=(200, 2)),
                                   rng.uniform(0, 10, (200, 1))], 1))
        sem.append(np.full(200, 2))
        tid.append(np.full(200, t))
    pts.append(np.stack([rng.uniform(0, 14, 2000), rng.uniform(0, 14, 2000),
                         rng.normal(scale=0.05, size=2000)], 1))
    sem.append(np.full(2000, 1))
    tid.append(np.full(2000, -1))
    write_ply(path, [np.concatenate(pts).astype(np.float32),
                     np.concatenate(sem).astype(np.int32), np.concatenate(tid).astype(np.int32)],
              ["x", "y", "z", "semantic_seg", "treeID"])


def test_served_scene_phases_and_units(recorder, tmp_path):
    run_cfg = load_config(cli_eval.CONF_DIR, [
        "models.PointGroup-PAPER.feat_size=8", "data.radius=7",
        f"data.voxel_capacity={CAPACITY}", f"data.eval_voxel_capacity={CAPACITY}"],
        root="eval.yaml")
    run_cfg["backbone"] = "tiny"
    run_cfg["budget_overrides"] = {k: v for k, v in CFG.items()
                                   if k not in ("backbone", "feat_dim", "in_feat")}
    cfg, _ = cli_eval.model_config(run_cfg)
    ckpt = ModelCheckpoint(str(tmp_path / "ckpt"), run_config=run_cfg)
    ckpt.save_best_models_under_current_metrics({"state_dict": _model(cfg, 2).state_dict()},
                                                None, {"train": {"loss": 1.0}})
    ply = str(tmp_path / "forest.ply")
    _forest(ply, 3)
    hook = Hook()
    evaluator, kwargs, out_dir, _ = cli_eval.build_evaluator(
        [f"checkpoint_dir={tmp_path / 'ckpt'}", f"data.files.test=[{ply}]",
         f"out_dir={tmp_path / 'out'}", "device=cpu", "tiles_per_dispatch=1"], timer=hook)
    assert hook.names == []
    evaluator.run(out_dir=out_dir, **kwargs)
    dispatches = hook.names.count("collate")
    assert dispatches >= 2
    assert hook.names == ["tiling"] + DISPATCH * dispatches + ["finalise", "report"]
    recs = trace.drain()
    roots = sorted((r for r in recs if r.parent == 0), key=lambda r: r.start_ns)
    assert [r.name for r in roots] == ["build_evaluator", "scene"]
    build, scene = roots
    assert _children(recs, build) == ["model", "model", "model"]
    by = _by_id(recs)
    (move,) = [r for r in recs if r.name == "sync::model_to"]
    # on the CPU the model moves nowhere: no upload
    assert by[move.parent].name == "model" and move.counts == {"host_syncs": 0}
    report = next(r for r in recs if r.name == "report")
    assert report.unit == scene.id and _children(recs, report) == ["ply_write"] * 3
    # the three files' bytes, and the positions formatted once for all three
    writes = sorted((r for r in recs if r.name == "ply_write"), key=lambda r: r.start_ns)
    names = ["Semantic_results_forEval_0.ply", "Instance_Results_forEval0.ply",
             "Instance_results_withColor_0.ply"]
    assert [r.counts["ply_bytes"] for r in writes] == [
        os.path.getsize(os.path.join(out_dir, f)) for f in names]
    assert sum(r.counts.get("ply_xyz_reused", 0) for r in writes) == 2
    pulls = [r for r in recs if r.name == "sync::pull"]
    assert len(pulls) == dispatches and {by[r.parent].name for r in pulls} == {"extract"}
    assert {r.unit for r in recs if r.name == "sync::grow"} == {scene.id}
    # with make_submission false no PLY is written, and neither counter is
    evaluator.run(out_dir=str(tmp_path / "noply"), **{**kwargs, "ply_output": False})
    recs = trace.drain()
    assert any(r.name == "report" for r in recs)
    assert not any({"ply_bytes", "ply_xyz_reused"} & set(r.counts or ()) for r in recs)
    assert not any(f.endswith(".ply") for f in os.listdir(tmp_path / "noply"))
