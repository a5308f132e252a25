"""The mask head on the UNet ScoreNet (``mask_supervise``) with its epoch
gates (``use_mask_filter_score_feature``, ``cal_iou_based_on_mask``) against
the JAX package, on the tiny plan and two synthetic tiles in 4,096 rows.

Weights: the port's initializers carried to the JAX side as a flax tree
(random BN statistics), with the semantic head biased to one thing class
the offset head scaled to a few mm, so that region growing's proposals are the
planted instances (IoU > 0.5: the mask loss has members to supervise). The
JAX side runs as its own tests run it: f32, ``use_winconv="off"``;
``rg_dense="on"`` on both sides. Compared: ``instance_iou(member_pass=)``
and ``mask_loss`` on planted proposals (1e-6); ``score()`` with the
filter's gate closed and open (scores and logits within 1e-5 of their
scale); the eval forward (heads, scores and member mask logits within
1e-4, proposals exact); the first full step at ``epoch=None`` (losses
within 1e-4, gradients within 1e-3 of max |g|); ``panoptic_losses`` on one
output at a closed and an open ``cal_iou`` gate; the trainer's gate keys;
the member filter of ``get_instances`` and ``extract_clusters``."""

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticsegforlargescalepointcloud_tpu.cluster import nms as j_nms
from panopticsegforlargescalepointcloud_tpu.config import (
    load_config as j_load_config,
    panoptic_config_from_yaml as j_config_from_yaml,
)
from panopticsegforlargescalepointcloud_tpu.data import collate_tiles, synthetic_tile
from panopticsegforlargescalepointcloud_tpu.eval import extract as j_extract
from panopticsegforlargescalepointcloud_tpu.models import losses as j_losses
from panopticsegforlargescalepointcloud_tpu.models.pointgroup3heads import (
    PanopticConfig as JConfig,
    PointGroup3HeadsNet as JNet,
    panoptic_losses as j_panoptic_losses,
    scorer_inputs as j_scorer_inputs,
)
from panopticsegforlargescalepointcloud_tpu.ops.hierarchy import build_hierarchy as j_hier
from panopticsegforlargescalepointcloud_tpu.train.step import (
    batch_arrays,
    canonicalize as j_canon,
    make_eval_forward as j_make_eval_forward,
    panoptic_forward as j_panoptic_forward,
)
from panopticsegforlargescalepointcloud_tpu.train.trainer import Trainer as JTrainer
from panopticsegforlargescalepointcloud_tpu_torch.cluster import nms
from panopticsegforlargescalepointcloud_tpu_torch.config import load_config
from panopticsegforlargescalepointcloud_tpu_torch.eval.extract import extract_clusters
from panopticsegforlargescalepointcloud_tpu_torch.flagship import CONF_DIR
from panopticsegforlargescalepointcloud_tpu_torch.models import (
    PanopticConfig,
    PanopticOutput,
    PointGroup3HeadsNet,
    Proposals,
    panoptic_losses,
    scorer_inputs,
)
from panopticsegforlargescalepointcloud_tpu_torch.models import losses as t_losses
from panopticsegforlargescalepointcloud_tpu_torch.ops.hierarchy import build_hierarchy
from panopticsegforlargescalepointcloud_tpu_torch.train import (
    canonicalize,
    make_eval_forward,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
    panoptic_forward,
)
from panopticsegforlargescalepointcloud_tpu_torch.train.step import init_params
from panopticsegforlargescalepointcloud_tpu_torch.train.trainer import Trainer
from panopticsegforlargescalepointcloud_tpu_torch.weights import flax_paths, params_from_flax
from test_torch_eval_host import _port_props, _proposals
from test_torch_settings import _nest, _random_stats

torch.set_num_threads(2)

MASK = dict(mask_supervise=True, use_mask_filter_score_feature=True,
            use_mask_filter_score_feature_start_epoch=3, cal_iou_based_on_mask=True,
            cal_iou_based_on_mask_start_epoch=5)
BASE = dict(num_classes=9, stuff_classes=(0, 7, 8), backbone="tiny", in_feat=8, num_samples=2,
            max_props_rg=32, ms_max_seeds=16, ms_max_clusters=16, ms_point_cap=1024,
            cluster_radius=0.9, rg_point_cap=0.5, scorer_capacity_mult=0.375,
            compute_dtype="float32", rg_dense="on")
KW = dict(BASE, **MASK)
MOMENTUM = 0.1


def _port_output(jout) -> PanopticOutput:
    """A JAX forward's output as the port's, tensors on the CPU."""
    def conv(v):
        return None if v is None else torch.from_numpy(np.array(v))
    fields = {f: conv(getattr(jout, f)) for f in PanopticOutput._fields
              if f not in ("proposals", "internal_losses")}
    return PanopticOutput(proposals=Proposals(**{k: conv(v) for k, v in
                                                 jout.proposals._asdict().items()}), **fields)


@pytest.fixture(scope="module")
def setup():
    return _setup(KW, eval_forward=True)


def _setup(kw, eval_forward=False):
    """Both packages' configs and models for ``kw``, the crafted weights as
    a flax tree, the batch and, with ``eval_forward``, both eval forwards."""
    rng = np.random.default_rng(7)
    tiles = [synthetic_tile(rng, n_instances=4, pts_per_instance=80, n_ground=0)
             for _ in range(2)]
    arrays = batch_arrays(collate_tiles(tiles, capacity=4096, num_tiles=2))
    cfg, jcfg = PanopticConfig(**kw), JConfig(**kw, use_winconv="off")
    model = init_params(PointGroup3HeadsNet(cfg), torch.Generator().manual_seed(3))
    with torch.no_grad():
        model.semantic_out.bias[1] += 8.0  # every row one thing class
        # votes within a few mm of the positions (not at them: the offsets'
        # norm has no gradient at 0 in JAX)
        model.offset_out.weight.mul_(1e-3)
        model.offset_out.bias.fill_(1e-3)
    flat = flax_paths(model.state_dict())
    stat = lambda k: k.rsplit("/", 1)[1] in ("mean", "var")  # noqa: E731
    params = _nest({k: v for k, v in flat.items() if not stat(k)})
    stats = _random_stats(_nest({k: v for k, v in flat.items() if stat(k)}),
                          np.random.default_rng(3))
    model.load_state_dict(params_from_flax(params, stats), strict=True)
    jmodel = JNet(jcfg)
    np_arrays = tuple(np.asarray(a) for a in arrays)
    out = dict(cfg=cfg, jcfg=jcfg, model=model, jmodel=jmodel, params=params, stats=stats,
               arrays=arrays, np_arrays=np_arrays)
    if eval_forward:
        out["jdb"], out["jout"] = j_make_eval_forward(jcfg, jmodel)(params, stats, arrays)
        out["tdb"], out["tout"] = make_eval_forward(cfg, model, device="cpu")(np_arrays)
    return out


def full_steps(setup):
    """The first full train step at ``epoch=None`` in both packages from the
    setup's weights: (JAX metrics, port metrics, JAX gradients, port
    gradients, JAX train-mode scores and proposals, port train-mode scores
    and proposals); gradients by flax path."""
    cfg, jcfg, jmodel = setup["cfg"], setup["jcfg"], setup["jmodel"]

    def loss_fn(params, stats, arrays):
        db = j_canon(*arrays)
        hier = j_hier(db.grid, jcfg.num_down)
        out, _ = j_panoptic_forward(jcfg, jmodel, {"params": params, "batch_stats": stats},
                                    db, hier, train=True, with_clustering=True,
                                    momentum=MOMENTUM)
        total, losses = j_panoptic_losses(jcfg, out, db.y, db.vote_label, db.instance_labels,
                                          db.instance_mask, db.grid.batch, db.grid.mask)
        return total, (dict(losses, hier_overflow=jnp.sum(hier.overflow)),
                       out.cluster_scores, out.proposals)

    (_, (jm, jscores, jprops)), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        setup["params"], setup["stats"], setup["arrays"])
    model = PointGroup3HeadsNet(cfg)
    model.load_state_dict(params_from_flax(setup["params"], setup["stats"]), strict=True)
    twin = copy.deepcopy(model).train()
    db = canonicalize(*setup["np_arrays"], device="cpu")
    with torch.no_grad():
        tout = panoptic_forward(cfg, twin, db, build_hierarchy(db.grid, cfg.num_down,
                                                               device="cpu"), True, MOMENTUM)
    opt = make_optimizer("Adam", model.parameters())
    tm = make_train_step(cfg, model, opt, make_lr_schedule("ExponentialLR", {}, 1e-3, 750),
                         True, device="cpu", epoch=None)(setup["np_arrays"], MOMENTUM)
    grads = flax_paths({n: p.grad for n, p in model.named_parameters()})
    return dict(jm=jm, tm=tm, jgrads={k: np.asarray(v) for k, v in _flat(jg).items()},
                grads=grads, jscores=np.asarray(jscores), jprops=jprops,
                tscores=tout.cluster_scores, tprops=tout.proposals)


def check_full_steps(r):
    """Losses within 1e-4 by name, gradients within 1e-3 of max |g|, the
    train-mode forward's scores within 1e-4 and its proposals exact."""
    jm, tm = r["jm"], r["tm"]
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-5, err_msg=k)
    assert set(r["grads"]) == set(r["jgrads"])
    for k, want in r["jgrads"].items():
        np.testing.assert_allclose(r["grads"][k], want, rtol=0,
                                   atol=1e-3 * np.abs(want).max() + 1e-7, err_msg=k)
    np.testing.assert_allclose(r["tscores"].numpy(), r["jscores"], rtol=1e-4, atol=1e-4)
    for name in r["tprops"]._fields:
        np.testing.assert_array_equal(getattr(r["tprops"], name).numpy(),
                                      np.asarray(getattr(r["jprops"], name)), err_msg=name)


# --------------------------------------------------------------- losses alone


def _planted(seed, tie=False):
    """A membership table over 400 rows of 2 samples with 3 instances each:
    proposals that are an instance, most of one, background only, empty,
    or (``tie``) two halves of equal size of two instances (tied IoUs);
    random mask probabilities."""
    rng = np.random.default_rng(seed)
    n = 400
    batch = np.repeat([0, 1], n // 2).astype(np.int32)
    inst = np.zeros(n, np.int32)
    inst[:150] = np.repeat([1, 2, 3], 50)
    inst[200:310] = np.repeat([1, 2, 3], [50, 30, 30])
    pid = np.full(n, -1, np.int32)
    pid[:50] = 0  # instance 1 of sample 0
    pid[50:90] = 1  # most of its instance 2
    pid[100:150] = 2  # its instance 3
    pid[200:250] = 3  # instance 1 of sample 1
    if tie:  # 15 rows of instance 2 and 15 of 3: IoU 1/3 with both
        pid[250:265] = 4
        pid[280:295] = 4
    else:
        pid[250:280] = 4
    pid[320:380] = 5  # background rows only
    props = dict(point_idx=np.where(pid >= 0, np.arange(n), -1).astype(np.int32),
                 prop_id=pid, member_valid=pid >= 0,
                 prop_valid=np.array([True] * 6 + [False, True]),
                 prop_batch=np.array([0, 0, 0, 1, 1, 1, -1, 0], np.int32),
                 prop_type=np.zeros(8, np.int32))
    return props, inst, batch, rng.uniform(0.02, 0.98, n).astype(np.float32), rng


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("scored", [False, True])
def test_iou_and_mask_loss_match_jax(tie, scored):
    props, inst, batch, prob, rng = _planted(int(tie) + 2 * int(scored), tie)
    member_pass = rng.random(len(inst)) > 0.3
    member_scored = (rng.random(len(inst)) > 0.1) if scored else None
    jp = j_losses.Proposals(**{k: jnp.asarray(v) for k, v in props.items()})
    tp = Proposals(**{k: torch.from_numpy(v) for k, v in props.items()})
    for mp in (None, member_pass):
        jiou = np.asarray(j_losses.instance_iou(jp, jnp.asarray(inst), jnp.asarray(batch), 2, 4,
                                                member_pass=None if mp is None
                                                else jnp.asarray(mp)))
        tiou = t_losses.instance_iou(tp, torch.from_numpy(inst), torch.from_numpy(batch), 2, 4,
                                     member_pass=None if mp is None else torch.from_numpy(mp))
        np.testing.assert_allclose(tiou.numpy(), jiou, rtol=1e-6, atol=1e-6)
        want = float(j_losses.mask_loss(jnp.asarray(jiou), jp, jnp.asarray(prob),
                                        jnp.asarray(inst), 4,
                                        member_scored=None if member_scored is None
                                        else jnp.asarray(member_scored)))
        got = float(t_losses.mask_loss(tiou, tp, torch.from_numpy(prob), torch.from_numpy(inst),
                                       4, member_scored=None if member_scored is None
                                       else torch.from_numpy(member_scored)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-6) and want > 0
    if tie:  # proposal 4 ties instances 2 and 3 of sample 1 (all members)
        row = t_losses.instance_iou(tp, torch.from_numpy(inst), torch.from_numpy(batch), 2,
                                    4)[4].numpy()
        assert row.max() > 0 and (row == row.max()).sum() == 2


# ----------------------------------------------------------- the model's paths


@pytest.mark.parametrize("epoch", [2, None])
def test_score_with_mask_filter_gate(setup, epoch):
    """``score()`` on the forward's own proposals: at epoch 2 the filter's
    gate (start epoch 3) is closed, at None it is open."""
    cfg, jcfg = setup["cfg"], setup["jcfg"]
    jout, jdb = setup["jout"], setup["jdb"]
    sg, shier, sfeats, _, _ = jax.jit(lambda p, c, x: j_scorer_inputs(jcfg, p, c, x))(
        jout.proposals, jdb.grid.coords, jout.backbone_feats)
    jscores, jlogits = jax.jit(lambda v, f, h, b: setup["jmodel"].apply(
        v, f, h, b, jcfg.total_props, False, MOMENTUM, epoch,
        method=JNet.score))({"params": setup["params"], "batch_stats": setup["stats"]},
                            sfeats, shier, sg.batch)
    tout, tdb, model = setup["tout"], setup["tdb"], setup["model"].eval()
    with torch.no_grad():
        tsg, tshier, tsfeats, _, _ = scorer_inputs(cfg, tout.proposals, tdb.grid.coords,
                                                   tout.backbone_feats)
        scores, logits = model.score(tsfeats, tshier, tsg.batch, cfg.total_props, MOMENTUM,
                                     epoch)
    for got, want in ((scores, jscores), (logits, jlogits)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    keep = torch.sigmoid(logits) >= cfg.mask_filter_score_feature_thre
    assert 0 < int(keep[tsg.mask].sum()) < int(tsg.mask.sum())  # the filter has rows to drop
    if epoch is None:  # the open gate changes the scores
        with torch.no_grad():
            closed = model.score(tsfeats, tshier, tsg.batch, cfg.total_props, MOMENTUM, 2)[0]
        assert not torch.allclose(closed, scores)


def test_eval_forward_matches_jax(setup):
    jout, tout = setup["jout"], setup["tout"]
    for name in ("semantic_logits", "offset_logits", "embed_logits", "cluster_scores",
                 "mask_scores"):
        np.testing.assert_allclose(getattr(tout, name).numpy(),
                                   np.asarray(getattr(jout, name)), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    np.testing.assert_array_equal(tout.mask_row_valid.numpy(), np.asarray(jout.mask_row_valid))
    for name in tout.proposals._fields:
        np.testing.assert_array_equal(getattr(tout.proposals, name).numpy(),
                                      np.asarray(getattr(jout.proposals, name)), err_msg=name)
    assert int(tout.proposals.prop_valid.sum()) >= 4
    assert int(tout.rg_graph_trunc) == int(jout.rg_graph_trunc) == 0


def test_full_step_matches_jax(setup):
    """The first full train step with every mask flag at ``epoch=None``."""
    r = full_steps(setup)
    check_full_steps(r)
    assert float(r["tm"]["mask_loss"]) > 0 and float(r["tm"]["rg_graph_trunc"]) == 0
    assert np.abs(r["grads"]["mask_score_a/kernel"]).max() > 0  # the loss reaches the head


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        out.update(_flat(v, path) if hasattr(v, "items") else {path: v})
    return out


@pytest.mark.parametrize("epoch", [5, 6])
def test_losses_at_the_cal_iou_gate(setup, epoch):
    """``panoptic_losses`` on the JAX forward's output: at epoch 5 the
    mask-based IoU's gate (start epoch 5) is closed, at 6 open."""
    cfg, jcfg, jout, jdb = setup["cfg"], setup["jcfg"], setup["jout"], setup["jdb"]
    labels = (jdb.y, jdb.vote_label, jdb.instance_labels, jdb.instance_mask, jdb.grid.batch,
              jdb.grid.mask)
    _, want = jax.jit(lambda o, *a: j_panoptic_losses(jcfg, o, *a, epoch=epoch))(jout, *labels)
    tout = _port_output(jout)
    _, got = panoptic_losses(cfg, tout, *(torch.from_numpy(np.array(a)) for a in labels),
                             epoch=epoch)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    _, other = panoptic_losses(cfg, tout, *(torch.from_numpy(np.array(a)) for a in labels),
                               epoch=11 - epoch)
    assert float(other["score_loss"]) != float(got["score_loss"])  # the gate changes targets


def test_trainer_gate_keys_match_jax():
    """The full steps the trainers build over epochs 1-8, one per gate
    state (filter start 3, IoU start 5): the same keys, each first built
    at the same epoch."""
    over = ["models=panoptic/area4_ablation_3heads_5", "backbone=tiny"] + [
        f"models.PointGroup-PAPER.{k}={v}" for k, v in MASK.items()]
    jcfg = j_config_from_yaml(j_load_config(CONF_DIR, over))[0]
    fake = types.SimpleNamespace(pcfg=jcfg, _full_steps={}, _build_full=lambda e: e,
                                 _eval_fwds={}, model=None)
    trainer = Trainer(load_config(CONF_DIR, over + ["training.num_workers=0"]),
                      capacity=4096, backbone="tiny", device="cpu", num_samples=2)
    try:
        for epoch in range(1, 9):
            JTrainer._full_step_for(fake, epoch)
            trainer._full_step_for(epoch)
            trainer._eval_fwd_for(epoch)
        assert list(trainer._full_steps) == list(fake._full_steps) == list(trainer._eval_fwds)
        assert list(fake._full_steps.values()) == [1, 4, 6]
        assert list(trainer._full_steps) == [(False, False), (True, False), (True, True)]
    finally:
        trainer.close()


# ----------------------------------------------------- the member filter


def _mask_scores(seed, m):
    return np.random.default_rng(100 + seed).normal(scale=1.0, size=m).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_extract_clusters_with_mask_scores_matches_jax(seed):
    arrays, scores = _proposals(seed)
    ms = _mask_scores(seed, len(arrays["prop_id"]))
    kw = dict(nms_threshold=0.3, min_cluster_points=5, min_score=0.5)
    want_c, want_k = j_extract.extract_clusters(arrays, scores, 300, mask_scores=ms, **kw)
    got_c, got_k = extract_clusters(_port_props(arrays), torch.from_numpy(scores), 300,
                                    mask_scores=torch.from_numpy(ms), **kw)
    assert got_k == want_k and len(want_k) >= 2
    for a, b in zip(got_c, want_c):
        np.testing.assert_array_equal(a, b)
    plain = extract_clusters(_port_props(arrays), torch.from_numpy(scores), 300, **kw)[0]
    assert sum(map(len, got_c)) < sum(map(len, plain))  # the filter drops members


def test_get_instances_with_mask_scores_matches_jax():
    arrays, scores = _proposals(4)
    ms = _mask_scores(4, len(arrays["prop_id"]))
    jprops = j_losses.Proposals(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jkeep, jmasks = j_nms.get_instances(jprops, jnp.asarray(scores), 300,
                                        mask_scores=jnp.asarray(ms), min_cluster_points=5)
    keep, masks = nms.get_instances(_port_props(arrays), torch.from_numpy(scores), 300,
                                    mask_scores=torch.from_numpy(ms), min_cluster_points=5)
    np.testing.assert_array_equal(masks.numpy(), np.asarray(jmasks))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert keep.any()
