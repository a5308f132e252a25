"""The ScoreNet's other forms against the JAX package: the sparse-conv
encoder (``scorer_type: encoder``, ``models/unet.py:SparseEncoder``) and the
per-row MLP (``scorer_type: mlp``), each as a module in train mode (BN
running statistics included) and eval mode (within 1e-5 of max |value|),
then in the tiny model's first full train step (``test_torch_mask_head``'s
crafted weights and batch: the train-mode forward's scores within 1e-4 and
proposals exact, losses within 1e-4, gradients within 1e-3 of max |g|).
The weights of all three scorer forms (and the mask head) cross
``params_from_flax`` / ``flax_paths`` both ways with ``strict=True``
against the tree the JAX package's init makes (traced, not compiled).
Then the train and eval CLIs on the CPU at tiny width with the mask head
and with the encoder scorer."""

import json

import jax
import numpy as np
import optax
import pytest
import torch

from panopticsegforlargescalepointcloud_tpu.models.modules import PointMLP as JPointMLP
from panopticsegforlargescalepointcloud_tpu.models.pointgroup3heads import (
    PanopticConfig as JConfig,
    PointGroup3HeadsNet as JNet,
)
from panopticsegforlargescalepointcloud_tpu.models.unet import SparseEncoder as JEncoder
from panopticsegforlargescalepointcloud_tpu.ops import hashing as j_hashing
from panopticsegforlargescalepointcloud_tpu.ops.hierarchy import build_hierarchy as j_hier
from panopticsegforlargescalepointcloud_tpu.ops.sparse import make_grid as j_make_grid
from panopticsegforlargescalepointcloud_tpu.train.step import (
    canonicalize as j_canon,
    init_state as j_init_state,
)
from panopticsegforlargescalepointcloud_tpu_torch.cli import eval as cli_eval
from panopticsegforlargescalepointcloud_tpu_torch.cli import train as cli_train
from panopticsegforlargescalepointcloud_tpu_torch.models import PanopticConfig, PointGroup3HeadsNet
from panopticsegforlargescalepointcloud_tpu_torch.models.modules import PointMLP
from panopticsegforlargescalepointcloud_tpu_torch.models.plans import scorer_encoder_plan
from panopticsegforlargescalepointcloud_tpu_torch.models.unet import SparseEncoder
from panopticsegforlargescalepointcloud_tpu_torch.ops.hashing import BitLayout
from panopticsegforlargescalepointcloud_tpu_torch.ops.hierarchy import build_hierarchy
from panopticsegforlargescalepointcloud_tpu_torch.ops.sparse import make_grid
from panopticsegforlargescalepointcloud_tpu_torch.train.step import init_params
from panopticsegforlargescalepointcloud_tpu_torch.weights import flax_paths, params_from_flax
from test_data import make_forest_ply
from test_torch_mask_head import BASE, MASK, _flat, _setup, check_full_steps, full_steps
from test_torch_settings import _nest, _random_stats

torch.set_num_threads(2)

F = 8  # in_feat
SEGMENTS = 24
MOMENTUM = 0.1


def _split(module, seed):
    """The module's weights as flax (params, batch_stats), random stats."""
    flat = flax_paths(module.state_dict())
    stat = lambda k: k.rsplit("/", 1)[1] in ("mean", "var")  # noqa: E731
    return (_nest({k: v for k, v in flat.items() if not stat(k)}),
            _random_stats(_nest({k: v for k, v in flat.items() if stat(k)}),
                          np.random.default_rng(seed)))


@pytest.fixture(scope="module")
def scorer_grid():
    """A ScoreNet-like grid: SEGMENTS proposals of 20-100 voxels around
    their own origins (the proposal id in the batch field), 2,048 rows."""
    rng = np.random.default_rng(11)
    sizes = rng.integers(20, 100, SEGMENTS)
    seg = np.repeat(np.arange(SEGMENTS), sizes).astype(np.int32)
    coords = rng.integers(-6, 6, (len(seg), 3)).astype(np.int32)
    mask = np.ones(len(seg), bool)
    cap = 2048
    t = make_grid(torch.from_numpy(seg), torch.from_numpy(coords), torch.from_numpy(mask),
                  bits=BitLayout(7, 7, 9), capacity=cap)[0]
    j = j_make_grid(*(jax.numpy.asarray(a) for a in (seg, coords, mask)),
                    bits=j_hashing.BitLayout(7, 7, 9), capacity=cap)[0]
    np.testing.assert_array_equal(t.batch.numpy(), np.asarray(j.batch))
    feats = rng.normal(size=(cap, F)).astype(np.float32) * t.mask.numpy()[:, None]
    return dict(tgrid=t, jgrid=j, feats=feats,
                thier=build_hierarchy(t, 2, bits=BitLayout(7, 7, 9), device="cpu"),
                jhier=j_hier(j, 2, bits=j_hashing.BitLayout(7, 7, 9)))


def _compare(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("train", [True, False])
def test_sparse_encoder_matches_jax(scorer_grid, train):
    """The encoder pools one row per proposal: the coarsest grid's batch
    field, carried down the hierarchy, is the proposal id."""
    g = scorer_grid
    np.testing.assert_array_equal(g["thier"].grids[2].batch.numpy(),
                                  np.asarray(g["jhier"].grids[2].batch))
    enc = init_params(SparseEncoder(**scorer_encoder_plan(F), num_segments=SEGMENTS),
                      torch.Generator().manual_seed(1))
    params, stats = _split(enc, 1)
    enc.load_state_dict(params_from_flax(params, stats), strict=True)
    jenc = JEncoder(**scorer_encoder_plan(F), num_segments=SEGMENTS)
    variables = {"params": params, "batch_stats": stats}
    x = g["feats"]
    if train:
        want, upd = jax.jit(lambda v, f: jenc.apply(v, f, g["jhier"], True, MOMENTUM,
                                                    mutable=["batch_stats"]))(variables, x)
    else:
        want = jax.jit(lambda v, f: jenc.apply(v, f, g["jhier"], False, MOMENTUM))(variables, x)
    enc.train(train)
    got = enc(torch.from_numpy(x), g["thier"], MOMENTUM)
    assert got.shape == (SEGMENTS, F)
    _compare(got, want)
    assert (np.abs(np.asarray(want)).sum(1) > 0).all()  # every proposal has a row
    if train:
        new = {k: v for k, v in flax_paths(dict(enc.named_buffers())).items()}
        for k, v in _flat(jax.tree.map(np.asarray, upd["batch_stats"])).items():
            _compare(torch.from_numpy(new[k]), v)


@pytest.mark.parametrize("train", [True, False])
def test_mlp_scorer_matches_jax(scorer_grid, train):
    g = scorer_grid
    mlp = init_params(PointMLP(F, (F, F)), torch.Generator().manual_seed(2))
    params, stats = _split(mlp, 2)
    mlp.load_state_dict(params_from_flax(params, stats), strict=True)
    jmlp = JPointMLP((F, F))
    variables = {"params": params, "batch_stats": stats}
    x, mask = g["feats"], np.asarray(g["jgrid"].mask)
    if train:
        want, upd = jmlp.apply(variables, x, mask, True, MOMENTUM, mutable=["batch_stats"])
    else:
        want = jmlp.apply(variables, x, mask, False, MOMENTUM)
    mlp.train(train)
    _compare(mlp(torch.from_numpy(x), g["tgrid"].mask, MOMENTUM), want)
    if train:
        new = flax_paths(dict(mlp.named_buffers()))
        for k, v in _flat(jax.tree.map(np.asarray, upd["batch_stats"])).items():
            _compare(torch.from_numpy(new[k]), v)


@pytest.mark.parametrize("scorer", ["encoder", "mlp"])
def test_full_step_matches_jax(scorer):
    r = full_steps(_setup(dict(BASE, scorer_type=scorer)))
    check_full_steps(r)
    assert float(r["tm"]["score_loss"]) > 0 and "mask_loss" not in r["tm"]
    head = {"encoder": "scorer_encoder/PointMLP_0/Dense_0/kernel",
            "mlp": "scorer_mlp/Dense_1/kernel"}[scorer]
    assert np.abs(r["grads"][head]).max() > 0  # the score loss reaches the scorer


@pytest.mark.parametrize("variant", [dict(scorer_type="encoder"), dict(scorer_type="mlp"),
                                     MASK], ids=["encoder", "mlp", "mask"])
def test_weights_round_trip_as_jax_tree(variant):
    """The port's modules are those of the flax tree the JAX init makes:
    a tree of that structure loads with ``strict=True`` and comes back
    through ``flax_paths`` unchanged."""
    kw = dict(BASE, **variant)
    jcfg = JConfig(**kw, use_winconv="off")
    rng = np.random.default_rng(7)
    from panopticsegforlargescalepointcloud_tpu.data import collate_tiles, synthetic_tile
    from panopticsegforlargescalepointcloud_tpu.train.step import batch_arrays

    arrays = batch_arrays(collate_tiles([synthetic_tile(rng) for _ in range(2)],
                                        capacity=4096, num_tiles=2))

    def init(arrays):
        db = j_canon(*arrays)
        state = j_init_state(jcfg, JNet(jcfg), optax.adam(1e-3), db,
                             j_hier(db.grid, jcfg.num_down), jax.random.PRNGKey(0))
        return state.params, state.batch_stats

    shapes = jax.eval_shape(init, arrays)
    vals = np.random.default_rng(5)
    params, stats = (jax.tree.map(lambda s: vals.normal(size=s.shape).astype(np.float32), t)
                     for t in shapes)
    model = PointGroup3HeadsNet(PanopticConfig(**kw))
    model.load_state_dict(params_from_flax(params, stats), strict=True)
    back = flax_paths(model.state_dict())
    flat = {**_flat(params), **_flat(stats)}
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    names = {k.split("/")[0] for k in _flat(params)}
    assert ("mask_score_a" in names) == ("mask_supervise" in variant)
    assert {"scorer", "scorer_encoder", "scorer_mlp"} & names == {
        {"encoder": "scorer_encoder", "mlp": "scorer_mlp"}.get(variant.get("scorer_type"),
                                                                 "scorer")}


@pytest.fixture(scope="module")
def forest(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("forest") / "forest.ply")
    make_forest_ply(path, np.random.default_rng(2022), n_trees=4, extent=14.0)
    return path


@pytest.mark.parametrize("over", [
    [f"models.PointGroup-PAPER.{k}={v}" for k, v in MASK.items()]
    + ["models.PointGroup-PAPER.use_mask_filter_score_feature_start_epoch=1",
       "models.PointGroup-PAPER.cal_iou_based_on_mask_start_epoch=1"],
    ["models.PointGroup-PAPER.scorer_type=encoder"],
], ids=["mask", "encoder"])
def test_cli_train_then_eval(forest, tmp_path, over):
    """Two epochs of the tiny model (the second with clustering, past the
    gates' start epoch 1) on the forest, then the eval CLI with that
    checkpoint, which rebuilds the same model from the run config."""
    run_dir = tmp_path / "run"
    model = "models.PointGroup-PAPER"
    trainer = cli_train.main([
        "data=panoptic/treeins_rad8", "backbone=tiny", "device=cpu", "pretty_print=False",
        "training.epochs=2", "training.batch_size=2", "training.samples_per_epoch=4",
        "training.num_workers=0", "data.voxel_capacity=4096", "data.eval_voxel_capacity=4096",
        "data.radius=6", f"checkpoint_dir={run_dir}", f"{model}.feat_size=8",
        f"{model}.prepare_epoch=1", f"data.files.train=[{forest}]",
        f"data.files.val=[{forest}]"] + over)
    pcfg = trainer.pcfg
    assert pcfg.mask_supervise == ("mask" in over[0]) and pcfg.scorer_type in ("unet",
                                                                               "encoder")
    assert list(trainer._full_steps) == [pcfg.gates(2)]
    lines = [json.loads(x) for x in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert len(lines) == 2
    for line in lines:
        assert all(np.isfinite(v) for k, v in line.items() if k.startswith("train_"))
    assert ("train_mask_loss" in lines[1]) == pcfg.mask_supervise
    assert "train_score_loss" in lines[1] and "train_rg_graph_trunc" in lines[1]
    reports = cli_eval.main([f"checkpoint_dir={run_dir}", "device=cpu",
                             f"data.files.test=[{forest}]", f"out_dir={tmp_path / 'eval'}"])
    assert len(reports) == 1
    assert all(np.isfinite(reports[0][k]) for k in ("mIoU", "meanPQ", "F1"))
    assert (tmp_path / "eval" / "Evaluation_0.txt").exists()
