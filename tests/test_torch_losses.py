"""The port's losses against the JAX package's ``models/losses.py`` and
``panoptic_losses`` on the same numpy arrays: each value and its gradient
with respect to every float input (a random cotangent of 1 on the scalar).
The batch holds a sample with several instances, a sample with one instance
(``l_dist`` = 0) and a sample with none, padding rows, ignored labels, and
proposals that are invalid or padded. f32; atol = rtol = 1e-5 (reductions
over a few hundred rows in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticsegforlargescalepointcloud_tpu.models import losses as jl
from panopticsegforlargescalepointcloud_tpu.models.pointgroup3heads import (
    PanopticConfig as JConfig,
    PanopticOutput as JOut,
    panoptic_losses as j_panoptic_losses,
)
from panopticsegforlargescalepointcloud_tpu_torch.models import losses as tl
from panopticsegforlargescalepointcloud_tpu_torch.models.pointgroup3heads import (
    PanopticConfig,
    PanopticOutput,
    Proposals,
    panoptic_losses,
)

torch.set_num_threads(2)

N, B, K, C, E = 300, 3, 6, 5, 5
CFG = dict(num_classes=C, stuff_classes=(0,), num_samples=B, max_instances=K, max_props_rg=4,
           ms_max_clusters=2, w_offset_norm=0.3, w_embed=0.7)
P = JConfig(**CFG).total_props
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    batch = np.sort(rng.integers(0, B, N)).astype(np.int32)
    valid = rng.random(N) > 0.1
    inst = np.zeros(N, np.int32)
    s0 = batch == 0
    inst[s0] = rng.integers(0, 5, s0.sum())  # several instances (0 = none)
    inst[batch == 1] = np.where(rng.random((batch == 1).sum()) > 0.5, 1, 0)  # one instance
    inst[~valid] = 0
    y = rng.integers(-1, C, N).astype(np.int32)
    # block 1: one proposal per instance, most of its rows; block 2: random
    key = np.where(inst > 0, batch * 10 + inst, -1)
    uniq = np.unique(key[key >= 0])
    by_inst = np.where((key >= 0) & (rng.random(N) > 0.2), np.searchsorted(uniq, key), -1)
    rand = np.where(rng.random(N) > 0.3, rng.integers(0, P, N), -1)
    prop_id = np.concatenate([by_inst, rand]).astype(np.int32)
    point_idx = np.where(prop_id >= 0, np.tile(np.arange(N), 2), -1).astype(np.int32)
    prop_valid = rng.random(P) > 0.2
    return dict(
        logits=rng.normal(size=(N, C)).astype(np.float32),
        off=rng.normal(size=(N, 3)).astype(np.float32),
        gt_off=rng.normal(size=(N, 3)).astype(np.float32),
        emb=rng.normal(scale=1.5, size=(N, E)).astype(np.float32),
        scores_raw=rng.normal(size=P).astype(np.float32),
        batch=batch, valid=valid, inst=inst, imask=(inst > 0) & valid, y=y,
        class_weights=rng.uniform(0.2, 2.0, C).astype(np.float32),
        props=dict(point_idx=point_idx, prop_id=prop_id, member_valid=prop_id >= 0,
                   prop_valid=prop_valid,
                   prop_batch=np.where(prop_valid, rng.integers(0, B, P), -1).astype(np.int32),
                   prop_type=np.zeros(P, np.int32)),
    )


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_() if grad else t


def _check(jfn, tfn, args, grad_idx):
    """Value and gradients (w.r.t. args[i] for i in grad_idx) of the scalar
    ``fn(*args)`` in both packages."""
    jval, jgrads = jax.value_and_grad(jfn, argnums=tuple(grad_idx))(
        *[jnp.asarray(a) for a in args])
    targs = [_t(a, i in grad_idx) for i, a in enumerate(args)]
    tval = tfn(*targs)
    tgrads = torch.autograd.grad(tval, [targs[i] for i in grad_idx], allow_unused=True)
    np.testing.assert_allclose(tval.item(), float(jval), **TOL)
    for tg, jg in zip(tgrads, jgrads):
        tg = np.zeros(jg.shape, np.float32) if tg is None else tg.numpy()  # input unused
        np.testing.assert_allclose(tg, np.asarray(jg), **TOL)
    return tval.item()


@pytest.mark.parametrize("weighted", [False, True])
def test_semantic_nll(data, weighted):
    cw = data["class_weights"] if weighted else None

    def jfn(lg):
        return jl.semantic_nll_loss(jax.nn.log_softmax(lg), jnp.asarray(data["y"]),
                                    jnp.asarray(data["valid"]),
                                    None if cw is None else jnp.asarray(cw))

    def tfn(lg):
        return tl.semantic_nll_loss(torch.log_softmax(lg, -1), _t(data["y"]),
                                    _t(data["valid"]), None if cw is None else _t(cw))

    _check(jfn, tfn, [data["logits"]], [0])


@pytest.mark.parametrize("term", ["offset_norm_loss", "offset_dir_loss"])
def test_offset_loss(data, term):
    def jfn(off):
        return jl.offset_loss(off, jnp.asarray(data["gt_off"]), jnp.asarray(data["imask"]))[term]

    def tfn(off):
        return tl.offset_loss(off, _t(data["gt_off"]), _t(data["imask"]))[term]

    _check(jfn, tfn, [data["off"]], [0])


@pytest.mark.parametrize("term", ["ins_loss", "ins_var_loss", "ins_dist_loss", "ins_reg_loss"])
def test_discriminative_loss(data, term):
    args = (data["inst"], data["batch"], data["imask"])

    def jfn(e):
        return jl.discriminative_loss(e, *[jnp.asarray(a) for a in args], B, K)[term]

    def tfn(e):
        return tl.discriminative_loss(e, *[_t(a) for a in args], B, K)[term]

    _check(jfn, tfn, [data["emb"]], [0])


def test_discriminative_loss_edge_samples(data):
    """Per sample: the one-instance sample has no push term, and the sample
    without instances does not count in the mean."""
    args = [_t(a) for a in (data["emb"], data["inst"], data["batch"], data["imask"])]
    full = tl.discriminative_loss(*args, B, K)
    keep = data["batch"] != 2
    sub = [_t(a[keep]) for a in (data["emb"], data["inst"], data["batch"], data["imask"])]
    two = tl.discriminative_loss(*sub, B, K)
    for k in full:
        np.testing.assert_allclose(full[k].item(), two[k].item(), **TOL)
    only1 = [_t(a[data["batch"] == 1]) for a in (data["emb"], data["inst"], data["batch"],
                                                  data["imask"])]
    assert tl.discriminative_loss(*only1, B, K)["ins_dist_loss"].item() == 0.0


def test_instance_iou_and_score_loss(data):
    jp = jl.Proposals(**{k: jnp.asarray(v) for k, v in data["props"].items()})
    tp = Proposals(**{k: _t(v) for k, v in data["props"].items()})
    jiou = jl.instance_iou(jp, jnp.asarray(data["inst"]), jnp.asarray(data["batch"]), B, K)
    tiou = tl.instance_iou(tp, _t(data["inst"]), _t(data["batch"]), B, K)
    np.testing.assert_allclose(tiou.numpy(), np.asarray(jiou), **TOL)
    assert float(np.asarray(jiou).max()) > 0.2

    def jfn(raw):
        return jl.instance_iou_loss(jiou, jax.nn.sigmoid(raw), jp.prop_valid, 0.25, 0.75)

    def tfn(raw):
        return tl.instance_iou_loss(tiou, torch.sigmoid(raw), tp.prop_valid, 0.25, 0.75)

    _check(jfn, tfn, [data["scores_raw"]], [0])


@pytest.mark.parametrize("with_scores", [False, True], ids=["prepare", "full"])
@pytest.mark.parametrize("weighted", [False, True])
def test_panoptic_losses(data, with_scores, weighted):
    jcfg, cfg = JConfig(**CFG), PanopticConfig(**CFG)
    cw = data["class_weights"] if weighted else None
    labels = (data["y"], data["gt_off"], data["inst"], data["imask"], data["batch"],
              data["valid"])

    def jlosses(lg, off, emb, raw):
        props = (jl.Proposals(**{k: jnp.asarray(v) for k, v in data["props"].items()})
                 if with_scores else None)
        out = JOut(jax.nn.log_softmax(lg), off, emb, None, props,
                   jax.nn.sigmoid(raw) if with_scores else None, None,
                   scorer_overflow=jnp.int32(3) if with_scores else None,
                   cluster_overflow=jnp.int32(5) if with_scores else None)
        return j_panoptic_losses(jcfg, out, *[jnp.asarray(a) for a in labels],
                                 class_weights=None if cw is None else jnp.asarray(cw))[1]

    def tlosses(lg, off, emb, raw):
        out = PanopticOutput(torch.log_softmax(lg, -1), off, emb, None)
        if with_scores:
            out = out._replace(
                proposals=Proposals(**{k: _t(v) for k, v in data["props"].items()}),
                cluster_scores=torch.sigmoid(raw), scorer_overflow=torch.tensor(3),
                cluster_overflow=torch.tensor(5))
        total, losses = panoptic_losses(cfg, out, *[_t(a) for a in labels],
                                        class_weights=None if cw is None else _t(cw))
        assert losses["loss"] is total
        return losses

    args = [data["logits"], data["off"], data["emb"], data["scores_raw"]]
    jkeys = set(jlosses(*[jnp.asarray(a) for a in args]))
    tkeys = set(tlosses(*[_t(a) for a in args]))
    assert jkeys == tkeys
    assert ("score_loss" in tkeys) == with_scores
    for term in sorted(tkeys - {"scorer_overflow", "cluster_overflow"}):
        _check(lambda *a: jlosses(*a)[term], lambda *a: tlosses(*a)[term], args,
               [0, 1, 2, 3] if with_scores else [0, 1, 2])
