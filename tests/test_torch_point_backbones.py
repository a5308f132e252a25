"""The point backbones' modules against the JAX package's, on the same
numpy inputs and the same flax weights (``params_from_flax``):

* ``kernel_dispositions``: bit for bit;
* ``level_positions`` on a real hierarchy: within 1e-6;
* ``KPConvLayer`` and ``KPConvDeformableLayer`` (modulated or not,
  ``fitting`` or ``permissive``): outputs within 1e-5 · max|value|, the
  regularizers within 1e-5 relative, and the deformable layer's gradients
  (the offsets' included, which must be non-zero) within 1e-4 · max|g|;
* the PointNet++ SA and FP modules in training mode: outputs and the new
  BN running statistics;
* each whole backbone (KPConv rigid and deformable, PointNet++) on two
  synthetic tiles, in training mode (with the new BN statistics and the
  summed regularizers) and in eval mode (random statistics): within
  1e-4 · max|value|.

The JAX side runs in f32 on the CPU, as its own tests run it; the
hierarchy comes from each package's own ``build_hierarchy`` on the same batch."""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticsegforlargescalepointcloud_tpu.data import collate_tiles, synthetic_tile
from panopticsegforlargescalepointcloud_tpu.models import point_backbones as jpb
from panopticsegforlargescalepointcloud_tpu.train.step import batch_arrays, prepare_example
from panopticsegforlargescalepointcloud_tpu_torch.cluster.neighbors import radius_query
from panopticsegforlargescalepointcloud_tpu_torch.models import point_backbones as tpb
from panopticsegforlargescalepointcloud_tpu_torch.ops.hierarchy import build_hierarchy
from panopticsegforlargescalepointcloud_tpu_torch.train import canonicalize
from panopticsegforlargescalepointcloud_tpu_torch.weights import flax_paths, params_from_flax
from test_torch_settings import _random_stats
from test_torch_train_step import _flat
from torch_jax_cache import jax_compilation_cache  # noqa: F401 (autouse)

torch.set_num_threads(2)

LEVELS = 2
MOMENTUM = 0.1


def _sown(tree):
    """Each sown regularizer summed over the layers that sowed it."""
    sums = {}
    for path, v in _flat(tree).items():
        name = path.split("/")[-1]
        sums[name] = sums.get(name, 0.0) + float(np.sum(v))
    return sums


def _close(got, want, frac):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * scale + 1e-7)
    assert scale > 0


def _port(module, params, stats=None):
    module.load_state_dict(params_from_flax(params, stats or {}), strict=True)
    return module


# ------------------------------------------------------------- kernel points


@pytest.mark.parametrize("num_points", [15, 9, 21])
def test_kernel_dispositions_bit_identical(num_points):
    got = tpb.kernel_dispositions(num_points)
    want = jpb.kernel_dispositions(num_points)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got.tobytes() == want.tobytes()


# ------------------------------------------------------------------ batches


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(11)
    tiles = [synthetic_tile(rng, n_instances=3, pts_per_instance=60, n_ground=500)
             for _ in range(2)]
    arrays = batch_arrays(collate_tiles(tiles, capacity=2048, num_tiles=2))
    jdb, jhier = prepare_example(arrays, LEVELS)
    db = canonicalize(*(np.asarray(a) for a in arrays), device="cpu")
    hier = build_hierarchy(db.grid, LEVELS, device="cpu")
    np.testing.assert_array_equal(db.grid.keys.numpy(), np.asarray(jdb.grid.keys))
    return dict(jdb=jdb, jhier=jhier, db=db, hier=hier)


def test_level_positions(batch):
    ps, masks = tpb.level_positions(batch["db"].pos, batch["hier"])
    jps, jmasks = jpb.level_positions(batch["jdb"].pos, batch["jhier"])
    assert len(ps) == len(jps) == LEVELS + 1
    for p, jp_, m, jm in zip(ps, jps, masks, jmasks):
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
        np.testing.assert_allclose(p.numpy(), np.asarray(jp_), rtol=1e-6, atol=1e-6)
    assert int(masks[LEVELS].sum()) > 10


# ------------------------------------------------------------- KPConv layers


def _layer_inputs(seed, q=300, s=500, cin=6):
    rng = np.random.default_rng(seed)
    q_pos = rng.uniform(0, 2.0, size=(q, 3)).astype(np.float32)
    s_pos = rng.uniform(0, 2.0, size=(s, 3)).astype(np.float32)
    s_feats = rng.normal(size=(s, cin)).astype(np.float32)
    q_mask = rng.random(q) > 0.1
    s_mask = rng.random(s) > 0.1
    idx, _ = radius_query(torch.from_numpy(q_pos), torch.zeros(q, dtype=torch.int32),
                          torch.from_numpy(q_mask), torch.from_numpy(s_pos),
                          torch.zeros(s, dtype=torch.int32), torch.from_numpy(s_mask),
                          radius=0.75, k=16, cell_cap=64)
    assert (idx >= 0).any(dim=1).float().mean() > 0.8 and (idx < 0).any()
    return q_pos, s_pos, s_feats, idx.numpy(), q_mask


LAYERS = {
    "rigid": None,
    "deform_fitting": dict(modulated=False, loss_mode="fitting"),
    "deform_modulated_fitting": dict(modulated=True, loss_mode="fitting"),
    "deform_permissive": dict(modulated=False, loss_mode="permissive"),
    "deform_modulated_permissive": dict(modulated=True, loss_mode="permissive"),
}
EXTENT, COUT = 0.3, 7


def _layers(name, cin):
    kw = LAYERS[name]
    if kw is None:
        return (jpb.KPConvLayer(COUT, EXTENT, 15, compute_dtype="float32"),
                tpb.KPConvLayer(cin, COUT, EXTENT, 15))
    return (jpb.KPConvDeformableLayer(COUT, EXTENT, 15, compute_dtype="float32", **kw),
            tpb.KPConvDeformableLayer(cin, COUT, EXTENT, 15, **kw))


@pytest.fixture(scope="module", params=list(LAYERS))
def layer(request):
    name = request.param
    q_pos, s_pos, s_feats, idx, q_mask = _layer_inputs(sorted(LAYERS).index(name))
    jmod, tmod = _layers(name, s_feats.shape[1])
    deform = LAYERS[name] is not None
    args = (q_pos, s_pos, s_feats, idx) + ((q_mask,) if deform else ())
    jargs = tuple(jnp.asarray(a) for a in args)
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(3), *jargs)["params"])
    if deform:  # offsets of a fraction of the extent, as after some training
        rng = np.random.default_rng(5)
        params["offset_bias"] = rng.normal(scale=0.3, size=params["offset_bias"].shape
                                           ).astype(np.float32)
    w_out = np.random.default_rng(6).normal(size=(len(q_pos), COUT)).astype(np.float32)

    def j_loss(p):
        out, sown = jmod.apply({"params": p}, *jargs, mutable=["kp_losses"])
        regs = {k: v[0] for k, v in sown["kp_losses"].items()}
        return jnp.sum(out * w_out) + sum(regs.values()), (out, regs)

    if deform:
        (_, (jout, jregs)), jgrads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(params)
    else:
        jout, jregs, jgrads = jax.jit(lambda p: jmod.apply({"params": p}, *jargs))(params), {}, {}
    tmod = _port(tmod, params).train()
    targs = tuple(torch.from_numpy(np.asarray(a)) for a in args)
    if deform:
        tout, tregs = tmod(*targs)
        (torch.sum(tout * torch.from_numpy(w_out)) + sum(tregs.values())).backward()
    else:
        with torch.no_grad():
            tout, tregs = tmod(*targs), {}
    return dict(name=name, jout=np.asarray(jout), tout=tout.detach().numpy(),
                jregs={k: float(v) for k, v in jregs.items()},
                tregs={k: float(v.detach()) for k, v in tregs.items()},
                jgrads=_flat(jax.tree.map(np.asarray, jgrads)),
                tgrads=flax_paths({n: p.grad for n, p in tmod.named_parameters()})
                if deform else {}, module=tmod, args=targs)


def test_kpconv_layer_output(layer):
    _close(layer["tout"], layer["jout"], 1e-5)


def test_kpconv_layer_regularizers(layer):
    assert set(layer["tregs"]) == set(layer["jregs"])
    want = {None: set(), "fitting": {"fitting", "repulsion"}, "permissive": {"permissive"}}
    assert set(layer["tregs"]) == want[(LAYERS[layer["name"]] or {}).get("loss_mode")]
    for k, v in layer["jregs"].items():
        assert v > 0 and np.isfinite(v), k
        np.testing.assert_allclose(layer["tregs"][k], v, rtol=1e-5, err_msg=k)


def test_deformable_offsets_get_gradients(layer):
    if LAYERS[layer["name"]] is None:
        assert not layer["tgrads"]
        return
    assert set(layer["tgrads"]) == set(layer["jgrads"]) == {"kernel", "offset_kernel",
                                                            "offset_bias"}
    for k, g in layer["tgrads"].items():
        assert np.isfinite(g).all() and np.abs(g).max() > 0, k
        _close(g, layer["jgrads"][k], 1e-4)


def test_kpconv_layer_eval_mode_has_no_regularizers(layer):
    if LAYERS[layer["name"]] is None:
        return
    mod = layer["module"].eval()
    with torch.no_grad():
        out, regs = mod(*layer["args"])
    assert regs == {}
    _close(out.numpy(), layer["jout"], 1e-5)


# ------------------------------------------------------------ PointNet++ modules


def _two_sets(seed):
    rng = np.random.default_rng(seed)
    f_pos = rng.uniform(0, 3.0, size=(600, 3)).astype(np.float32)
    f_batch = rng.integers(0, 2, 600).astype(np.int32)
    f_mask = rng.random(600) > 0.1
    parent = rng.integers(0, 150, 600).astype(np.int32)
    c_pos = f_pos[:150] + rng.normal(scale=0.05, size=(150, 3)).astype(np.float32)
    c_batch = f_batch[:150]
    c_mask = f_mask[:150]
    parent = np.where(f_mask, parent, -1).astype(np.int32)
    return f_pos, f_batch, f_mask, parent, c_pos, c_batch, c_mask


def _train_apply(jmod, variables, jargs):
    fn = jax.jit(lambda v, *a: jmod.apply(v, *a, True, MOMENTUM, mutable=["batch_stats"]))
    out, upd = fn(variables, *jargs)
    return np.asarray(out), _flat(jax.tree.map(np.asarray, upd["batch_stats"]))


def _check_train_module(tmod, jmod, jargs, targs):
    variables = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(4), *jargs, True))
    stats = _random_stats(variables["batch_stats"], np.random.default_rng(8))
    jout, jstats = _train_apply(jmod, {"params": variables["params"], "batch_stats": stats},
                                jargs)
    tmod = _port(tmod, variables["params"], stats).train()
    with torch.no_grad():
        tout = tmod(*targs, MOMENTUM)
    _close(tout.numpy(), jout, 1e-5)
    got = flax_paths(dict(tmod.named_buffers()))
    assert set(got) == set(jstats)
    for k in jstats:
        np.testing.assert_allclose(got[k], jstats[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_pointnet2_sa_module():
    f_pos, f_batch, f_mask, _, c_pos, c_batch, c_mask = _two_sets(21)
    feats = np.random.default_rng(22).normal(size=(600, 5)).astype(np.float32)
    kw = dict(radii=(0.4, 0.8), nsamples=(8, 16), mlps=((8, 8), (6, 10)), cell_cap=32)
    jmod = jpb.PointNet2SAModule(compute_dtype="float32", **kw)
    args = (c_pos, c_batch, c_mask, f_pos, f_batch, f_mask, feats)
    _check_train_module(tpb.PointNet2SAModule(5, **kw), jmod,
                        tuple(jnp.asarray(a) for a in args),
                        tuple(torch.from_numpy(a) for a in args))


def test_pointnet2_fp_module():
    f_pos, f_batch, f_mask, parent, c_pos, c_batch, c_mask = _two_sets(23)
    rng = np.random.default_rng(24)
    skip = rng.normal(size=(600, 4)).astype(np.float32)
    c_feats = rng.normal(size=(150, 6)).astype(np.float32)
    args = (f_pos, f_batch, f_mask, skip, c_pos, c_batch, c_mask, c_feats, parent)
    # a radius small enough that some fine rows fall back on their parent
    idx, _ = radius_query(*(torch.from_numpy(a) for a in (f_pos, f_batch, f_mask, c_pos,
                                                           c_batch, c_mask)),
                          radius=0.25, k=3, cell_cap=16)
    assert ((idx < 0).all(dim=1) & torch.from_numpy(f_mask)).sum() > 10
    _check_train_module(tpb.PointNet2FPModule(10, (8, 8), radius=0.25, cell_cap=16),
                        jpb.PointNet2FPModule(mlp=(8, 8), radius=0.25, cell_cap=16),
                        tuple(jnp.asarray(a) for a in args),
                        tuple(torch.from_numpy(a) for a in args))


# ------------------------------------------------------------ whole backbones

BACKBONES = {
    "kpconv": dict(kind="kpconv"),
    "kpconv_deform": dict(kind="kpconv", deformable=True),
    "pointnet2": dict(kind="pointnet2"),
}


def _backbones(name):
    kw = dict(BACKBONES[name])
    if kw.pop("kind") == "kpconv":
        common = dict(num_levels=LEVELS, base_channels=8, out_nc=8, grid_size=0.2,
                      cell_cap=64, **kw)
        return (jpb.KPConvBackbone(compute_dtype="float32", **common),
                tpb.KPConvBackbone(4, **common))
    common = dict(num_levels=LEVELS, base_channels=8, out_nc=8, grid_size=0.2, cell_cap=64)
    return (jpb.PointNet2Backbone(compute_dtype="float32", **common),
            tpb.PointNet2Backbone(4, **common))


def _jax_backbone(jmod, batch):
    """The JAX backbone's init, random BN statistics, and its eval-mode and
    train-mode applies."""
    jdb, jhier = batch["jdb"], batch["jhier"]
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda f, p, h: jmod.init(jax.random.PRNGKey(1), f, p, h, False))(
            jdb.feats, jdb.pos, jhier))
    stats = _random_stats(variables["batch_stats"], np.random.default_rng(2))
    v = {"params": variables["params"], "batch_stats": stats}
    jeval = np.asarray(jax.jit(lambda v, f, p, h: jmod.apply(v, f, p, h, False))(
        v, jdb.feats, jdb.pos, jhier))
    jtrain, upd = jax.jit(lambda v, f, p, h: jmod.apply(
        v, f, p, h, True, MOMENTUM, mutable=["batch_stats", "kp_losses"]))(
            v, jdb.feats, jdb.pos, jhier)
    return variables["params"], stats, jeval, jtrain, upd


@pytest.fixture(scope="module")
def jax_backbones(batch):
    """Every backbone's :func:`_jax_backbone`, started at once in two
    threads of their own: XLA leaves the interpreter lock while it
    compiles, so the JAX programs compile beside each other and beside the
    port's runs."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        yield {name: pool.submit(_jax_backbone, _backbones(name)[0], batch)
               for name in BACKBONES}


@pytest.fixture(scope="module", params=list(BACKBONES))
def backbone(request, batch, jax_backbones):
    name = request.param
    params, stats, jeval, jtrain, upd = jax_backbones[name].result()
    db, hier = batch["db"], batch["hier"]
    tmod = _port(_backbones(name)[1], params, stats)
    with torch.no_grad():
        teval, eval_regs = tmod.eval()(db.feats, db.pos, hier)
        ttrain, regs = tmod.train()(db.feats, db.pos, hier, MOMENTUM)
    return dict(name=name, jeval=jeval, teval=teval.numpy(), eval_regs=eval_regs,
                jtrain=np.asarray(jtrain), ttrain=ttrain.numpy(),
                jstats=_flat(jax.tree.map(np.asarray, upd["batch_stats"])),
                tstats=flax_paths(dict(tmod.named_buffers())),
                jregs=_sown(jax.tree.map(np.asarray, upd.get("kp_losses", {}))),
                tregs={k: float(v) for k, v in regs.items()}, mask=db.grid.mask.numpy())


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_backbone_features(backbone, mode):
    got, want = backbone[f"t{mode}"], backbone[f"j{mode}"]
    assert got.shape == want.shape == (len(backbone["mask"]), 8)
    _close(got, want, 1e-4)
    assert not got[~backbone["mask"]].any()


def test_backbone_bn_running_stats(backbone):
    js, ts = backbone["jstats"], backbone["tstats"]
    assert set(ts) == set(js) and js
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-4, atol=1e-4, err_msg=k)


def test_backbone_regularizers(backbone):
    assert backbone["eval_regs"] == {}
    want = {"fitting", "repulsion"} if backbone["name"] == "kpconv_deform" else set()
    assert set(backbone["tregs"]) == set(backbone["jregs"]) == want
    for k, v in backbone["jregs"].items():
        np.testing.assert_allclose(backbone["tregs"][k], v, rtol=1e-4, err_msg=k)
