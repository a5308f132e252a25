"""The paper's Setting I (PointGroupEmbed, ``area4_ablation_19``: semantic and
embedding heads, strategy 7, mean shift on the embedding alone, no
ScoreNet) through the port against the benchmark's plain reference of the
embed family (``benchmark/reference/embed``), on the CPU at the tiny plan.

Configuration: the benchmark's ``setting1-npm3d`` with the tiny UNet, feat
8, small budgets and f32 (``benchmark/tests/tiny.py``); two synthetic
NPM3D tiles in 4,096 rows; seeded random weights with random BN statistics
(``benchmark/weights.py``, the ``serve`` scheme), loaded on both sides with
``strict=True``. Compared:

* the heads (semantic log-probabilities, embeddings) of an eval-mode
  forward: rtol 1e-5, atol 1e-6 (both sides run the same f32 operations;
  the scatter-based gathers and sums of the sparse convs may take their
  terms in another order);
* the reference's strategy-7 proposals on the port's heads: exactly;
* one full train step's loss terms (rtol 1e-4, atol 1e-5) and every
  parameter's gradient (within 1e-4 of the tensor's max |g| plus 1e-6), the
  tolerances of ``test_torch_train_step.py`` (f32 sums in another order
  through the UNet's depth);

and that each comparison fails under a planted fault: the port's heads
computed with bf16 conv operands, and a mean-shift loop that stops after
its first round."""

import numpy as np
import pytest
import torch

from benchmark import inputs
from benchmark.reference import embed
from benchmark.reference.plain.ops.hierarchy import build_hierarchy as ref_hierarchy
from benchmark.reference.plain.train.step import canonicalize as ref_canonicalize
from benchmark.reference.stages import PROPOSAL_FIELDS
from benchmark.tests.tiny import tiny_train
from benchmark.weights import draw_state, state_shapes
from panopticsegforlargescalepointcloud_tpu_torch.cluster import meanshift
from panopticsegforlargescalepointcloud_tpu_torch.config import panoptic_config_from_yaml
from panopticsegforlargescalepointcloud_tpu_torch.data import batch_arrays, collate_tiles
from panopticsegforlargescalepointcloud_tpu_torch.models import PointGroup3HeadsNet
from panopticsegforlargescalepointcloud_tpu_torch.models.pointgroup3heads import (
    build_proposals,
)
from panopticsegforlargescalepointcloud_tpu_torch.ops.hierarchy import build_hierarchy
from panopticsegforlargescalepointcloud_tpu_torch.train import (
    canonicalize,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
)

torch.set_num_threads(2)

WORKLOAD = "train-full.setting1-npm3d"
SEED = 2**31 + 1701
HEADS = dict(rtol=1e-5, atol=1e-6)


def _setup():
    _, config, traffic = tiny_train(WORKLOAD)
    rc = config["run_config"]
    tiles = inputs.tile_pool(SEED, traffic["batch_tiles"], **traffic["tile"])
    capacity = int(rc["data"]["voxel_capacity"])
    arrays = batch_arrays(collate_tiles(tiles, capacity=capacity, num_tiles=len(tiles)))
    return rc, tiles, capacity, arrays


def port_config(rc, dtype="float32"):
    return panoptic_config_from_yaml(rc, backbone="tiny", num_samples=2, compute_dtype=dtype,
                                     **rc["budget_overrides"])[0]


def port_model(cfg, weights):
    model = PointGroup3HeadsNet(cfg)
    model.load_state_dict(weights, strict=True)
    return model


@pytest.fixture(scope="module")
def setup():
    rc, tiles, capacity, arrays = _setup()
    cfg = port_config(rc)
    weights = draw_state(state_shapes(PointGroup3HeadsNet(cfg)), SEED, "serve", "cpu")
    rcfg = embed.embed_config_from_yaml(rc, num_samples=2, compute_dtype="float32")
    ref = embed.PointGroupEmbedNet(rcfg)
    ref.load_state_dict(weights, strict=True)
    return dict(rc=rc, tiles=tiles, capacity=capacity, arrays=arrays, cfg=cfg, rcfg=rcfg,
                weights=weights, ref=ref)


@torch.no_grad()
def port_heads(cfg, model, arrays):
    model.eval()
    db = canonicalize(*arrays, device="cpu")
    hier = build_hierarchy(db.grid, cfg.num_down, device="cpu")
    _, sem, off, emb, _ = model.backbone_heads(db.feats, hier, pos=db.pos)
    return db, sem, off, emb


@torch.no_grad()
def ref_heads(rcfg, ref, arrays):
    ref.eval()
    db = ref_canonicalize(*arrays, device="cpu")
    hier = ref_hierarchy(db.grid, rcfg.num_down, device="cpu")
    _, sem, _, emb, _ = ref.backbone_heads(db.feats, hier, pos=db.pos)
    return db, sem, emb


def heads_agree(prog, want):
    (db, sem, _, emb), (rdb, rsem, remb) = prog, want
    m = rdb.grid.mask
    assert torch.equal(db.grid.mask, m) and torch.equal(db.grid.coords, rdb.grid.coords)
    return all(np.allclose(a[m].numpy(), b[m].numpy(), **HEADS) for a, b in
               ((sem, rsem), (emb, remb)))


def proposals_agree(rcfg, cfg, prog):
    db, sem, off, emb = prog
    args = (db.pos, off, emb, sem, db.grid.batch, db.grid.mask)
    props, overflow, _ = build_proposals(cfg, *args)
    want, r_overflow, _ = embed.build_proposals(rcfg, *args)
    assert int(props.prop_valid.sum()) > 0
    return int(overflow) == int(r_overflow) and all(
        torch.equal(getattr(props, k), getattr(want, k)) for k in PROPOSAL_FIELDS)


def test_configs_agree(setup):
    cfg, rcfg = setup["cfg"], setup["rcfg"]
    assert (cfg.model_family, cfg.cluster_type, cfg.use_score_net) == ("embed", 7, False)
    assert not cfg.has_offset and not rcfg.has_offset
    for name in ("num_classes", "stuff_classes", "embed_dim", "bandwidth", "ms_point_cap",
                 "ms_max_seeds", "ms_max_clusters", "num_samples", "max_instances",
                 "w_semantic", "w_embed", "total_props", "num_sources", "in_feat"):
        assert getattr(cfg, name) == getattr(rcfg, name), name


def test_heads(setup):
    prog = port_heads(setup["cfg"], port_model(setup["cfg"], setup["weights"]), setup["arrays"])
    assert heads_agree(prog, ref_heads(setup["rcfg"], setup["ref"], setup["arrays"]))
    assert float(prog[2].abs().max()) == 0.0  # no offset head: zeros handed on


def test_proposals_exact(setup):
    prog = port_heads(setup["cfg"], port_model(setup["cfg"], setup["weights"]), setup["arrays"])
    assert proposals_agree(setup["rcfg"], setup["cfg"], prog)


@pytest.fixture(scope="module")
def steps(setup):
    """One full step of each side from the same weights and batch."""
    cfg, rc, arrays = setup["cfg"], setup["rc"], setup["arrays"]
    model = port_model(cfg, setup["weights"])
    opt = make_optimizer("Adam", model.parameters(), 0.0)
    sched = make_lr_schedule("ExponentialLR", {}, 1e-3, 750)
    metrics = make_train_step(cfg, model, opt, sched, with_clustering=True,
                              device="cpu")(arrays, 0.1)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    ref = embed.PointGroupEmbedNet(setup["rcfg"])
    ref.load_state_dict(setup["weights"], strict=True)
    ropt = make_optimizer("Adam", ref.parameters(), 0.0)
    rmetrics = embed.make_train_step(setup["rcfg"], ref, ropt, sched, device="cpu")(arrays, 0.1)
    rgrads = {n: p.grad.clone() for n, p in ref.named_parameters()}
    return metrics, grads, rmetrics, rgrads


def test_step_loss_terms(steps):
    metrics, _, rmetrics, _ = steps
    assert set(metrics) == set(rmetrics)
    assert "offset_norm_loss" not in metrics and "score_loss" not in metrics
    for k in rmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(rmetrics[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_step_gradients(steps):
    _, grads, _, rgrads = steps
    assert set(grads) == set(rgrads)
    moved = 0
    for k in sorted(rgrads):
        scale = float(rgrads[k].abs().max())
        np.testing.assert_allclose(grads[k].numpy(), rgrads[k].numpy(), rtol=0,
                                   atol=1e-4 * scale + 1e-6, err_msg=k)
        moved += scale > 0
    # the ScoreNet is off Setting I's path: its gradients are zero
    assert all(float(g.abs().max()) == 0 for k, g in rgrads.items() if k.startswith("scorer"))
    assert moved > len(rgrads) // 3


@pytest.mark.parametrize("fault", ["bf16_heads", "one_round_mean_shift"])
def test_planted_fault_fails(setup, fault, monkeypatch):
    cfg, rcfg, arrays = setup["cfg"], setup["rcfg"], setup["arrays"]
    if fault == "bf16_heads":
        bf = port_config(setup["rc"], "bfloat16")
        prog = port_heads(bf, port_model(bf, setup["weights"]), arrays)
        assert not heads_agree(prog, ref_heads(rcfg, setup["ref"], arrays))
    else:
        converge = meanshift.meanshift_converge
        monkeypatch.setattr(meanshift, "meanshift_converge",
                            lambda s, sv, x, pv, bw, max_iter: converge(s, sv, x, pv, bw, 1))
        prog = port_heads(cfg, port_model(cfg, setup["weights"]), arrays)
        assert not proposals_agree(rcfg, cfg, prog)
