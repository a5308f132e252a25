"""The whole slice: the port's eval forward (grid, maps, backbone, heads,
region growing + mean shift, ScoreNet) against the JAX package's
``make_eval_forward`` on the tiny plan, same numpy inputs, weights carried
over with ``params_from_flax``.

The JAX side runs as its own tests run it: f32, ``use_winconv="off"``, and
``rg_dense="on"`` so region growing takes the dense pull (Pallas interpret
mode). Tolerances: exact for integer outputs (grid, maps, overflow,
proposal membership, scorer grid); atol = rtol = 1e-4 for the heads and
scores (f32 reassociation over the UNet's depth)."""

import jax
import numpy as np
import optax
import pytest
import torch

from panopticsegforlargescalepointcloud_tpu.data import collate_tiles, synthetic_tile
from panopticsegforlargescalepointcloud_tpu.models.pointgroup3heads import (
    PanopticConfig as JConfig,
    PointGroup3HeadsNet as JNet,
    scorer_inputs as j_scorer_inputs,
)
from panopticsegforlargescalepointcloud_tpu.ops.hierarchy import build_hierarchy as j_hier
from panopticsegforlargescalepointcloud_tpu.train.step import (
    batch_arrays,
    canonicalize as j_canon,
    init_state,
    make_eval_forward as j_make_eval_forward,
)
from panopticsegforlargescalepointcloud_tpu_torch.models import (
    PanopticConfig,
    PointGroup3HeadsNet,
    scorer_inputs,
)
from panopticsegforlargescalepointcloud_tpu_torch.ops.hierarchy import build_hierarchy
from panopticsegforlargescalepointcloud_tpu_torch.train import make_eval_forward
from panopticsegforlargescalepointcloud_tpu_torch.weights import params_from_flax
from torch_jax_cache import jax_compilation_cache  # noqa: F401 (autouse)

torch.set_num_threads(2)

CFG = dict(
    num_classes=9, stuff_classes=(0, 7, 8), backbone="tiny", in_feat=8, num_samples=2,
    max_props_rg=32, ms_max_seeds=16, ms_max_clusters=16, ms_point_cap=1024,
    cluster_radius=0.9, rg_point_cap=0.5, scorer_capacity_mult=0.375,
    compute_dtype="float32",
)


def _random_stats(tree, rng):
    return {k: (_random_stats(v, rng) if hasattr(v, "items") else
                (np.abs(rng.normal(scale=0.3, size=v.shape)) + 0.5 if k == "var"
                 else rng.normal(scale=0.1, size=v.shape)).astype(np.float32))
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def run():
    rng = np.random.default_rng(7)
    tiles = [synthetic_tile(rng, n_instances=4, pts_per_instance=80) for _ in range(2)]
    vb = collate_tiles(tiles, capacity=4096, num_tiles=2)
    jcfg = JConfig(**CFG, use_winconv="off", rg_dense="on")
    jmodel = JNet(jcfg)
    arrays = batch_arrays(vb)
    db = j_canon(*arrays)
    state = init_state(jcfg, jmodel, optax.adam(1e-3), db, j_hier(db.grid, jcfg.num_down),
                       jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, state.params)
    stats = _random_stats(jax.tree.map(np.asarray, state.batch_stats),
                          np.random.default_rng(1))
    jdb, jout = j_make_eval_forward(jcfg, jmodel)(params, stats, arrays)

    cfg = PanopticConfig(**CFG)
    model = PointGroup3HeadsNet(cfg)
    model.load_state_dict(params_from_flax(params, stats), strict=True)
    np_arrays = tuple(np.asarray(a) for a in arrays)
    tdb, tout = make_eval_forward(cfg, model, device="cpu")(np_arrays)
    thier = build_hierarchy(tdb.grid, cfg.num_down, device="cpu")
    return dict(jcfg=jcfg, cfg=cfg, jdb=jdb, jout=jout, tdb=tdb, tout=tout, thier=thier)


def _eq(j, t):
    a = np.asarray(j)
    a = a.astype(np.int64) if a.dtype == np.uint32 else a
    np.testing.assert_array_equal(t.numpy(), a)


def test_canonical_grid_and_hierarchy(run):
    jdb, tdb = run["jdb"], run["tdb"]
    for x, y in zip(jdb.grid, tdb.grid):
        _eq(x, y)
    for name in ("feats", "pos", "y", "instance_labels", "instance_mask", "vote_label",
                 "origin_id"):
        _eq(getattr(jdb, name), getattr(tdb, name))
    jh = j_hier(jdb.grid, run["jcfg"].num_down)
    th = run["thier"]
    for a, b in zip(jh.bricks + jh.down_maps + jh.up_maps + jh.parents,
                    th.same_maps + th.down_maps + th.up_maps + th.parents):
        _eq(a, b)
    _eq(jh.overflow, th.overflow)


@pytest.mark.parametrize(
    "name", ["semantic_logits", "offset_logits", "embed_logits", "backbone_feats"])
def test_heads(run, name):
    got = getattr(run["tout"], name).numpy()
    want = np.asarray(getattr(run["jout"], name))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize(
    "name", ["point_idx", "prop_id", "member_valid", "prop_valid", "prop_batch", "prop_type"])
def test_proposal_membership(run, name):
    _eq(getattr(run["jout"].proposals, name), getattr(run["tout"].proposals, name))


def test_proposals_are_nontrivial(run):
    props = run["tout"].proposals
    assert int(props.prop_valid.sum()) >= 3
    assert int(props.member_valid.sum()) > 0


def test_scorer_grid(run):
    """The ScoreNet grid built from the same proposals and features."""
    jgrid, _, jfeats, jinv, jov = jax.jit(lambda p, c, x: j_scorer_inputs(run["jcfg"], p, c, x))(
        run["jout"].proposals, run["jdb"].grid.coords, run["jout"].backbone_feats)
    tgrid, _, tfeats, tinv, tov = scorer_inputs(
        run["cfg"], run["tout"].proposals, run["tdb"].grid.coords, run["tout"].backbone_feats)
    for x, y in zip(jgrid, tgrid):
        _eq(x, y)
    _eq(jinv, tinv)
    _eq(jov, tov)
    np.testing.assert_allclose(tfeats.numpy(), np.asarray(jfeats), rtol=1e-4, atol=1e-4)


def test_scores_and_overflow(run):
    jout, tout = run["jout"], run["tout"]
    np.testing.assert_allclose(tout.cluster_scores.numpy(), np.asarray(jout.cluster_scores),
                               rtol=1e-4, atol=1e-4)
    assert int(tout.cluster_overflow) == int(jout.cluster_overflow)
    assert int(tout.scorer_overflow) == int(jout.scorer_overflow)
