"""Weight carry-over: flax params + batch_stats of the JAX package's blocks go
through ``params_from_flax`` into the port's modules, which then compute the
same function (eval mode, f32, atol = rtol = 1e-5). The port's modules
start in torch's training mode, so each is put in eval mode first."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticsegforlargescalepointcloud_tpu.models import modules as jmod
from panopticsegforlargescalepointcloud_tpu.models.norm import MaskedBatchNorm as JBN
from panopticsegforlargescalepointcloud_tpu_torch.data import collate_tiles, synthetic_tile
from panopticsegforlargescalepointcloud_tpu_torch.models import modules as tmod
from panopticsegforlargescalepointcloud_tpu_torch.models.norm import MaskedBatchNorm as TBN
from panopticsegforlargescalepointcloud_tpu_torch.ops.hierarchy import build_hierarchy
from panopticsegforlargescalepointcloud_tpu_torch.ops.sparse import make_grid
from panopticsegforlargescalepointcloud_tpu_torch.weights import params_from_flax
from torch_jax_cache import jax_compilation_cache  # noqa: F401 (autouse)

torch.set_num_threads(2)


def randomize(tree, rng, var_keys=("var",)):
    """Random values of the same structure (positive where a variance)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = randomize(v, rng, var_keys)
        else:
            a = rng.normal(scale=0.3, size=np.shape(v)).astype(np.float32)
            out[k] = np.abs(a) + 0.5 if k in var_keys else a
    return out


def carry(variables, rng):
    params = randomize(variables["params"], rng)
    stats = randomize(variables.get("batch_stats", {}), rng)
    return params, stats


@pytest.fixture(scope="module")
def level():
    rng = np.random.default_rng(5)
    vb = collate_tiles([synthetic_tile(rng, n_instances=3, pts_per_instance=60)],
                       capacity=2048, num_tiles=1)
    grid, _ = make_grid(torch.from_numpy(vb.batch), torch.from_numpy(vb.coords),
                        torch.from_numpy(vb.mask))
    hier = build_hierarchy(grid, 1, device="cpu")
    return hier.same_maps[0], hier.grids[0].mask


def test_masked_batchnorm(rng):
    x = rng.normal(size=(300, 6)).astype(np.float32)
    mask = rng.random(300) > 0.2
    variables = JBN().init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask), False)
    params, stats = carry(variables, rng)
    want = JBN().apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                       jnp.asarray(mask), False)
    bn = TBN(6).eval()
    bn.load_state_dict(params_from_flax(params, stats), strict=True)
    got = bn(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert np.all(got.detach().numpy()[~mask] == 0)


def test_point_mlp_transposes_dense(rng):
    x = rng.normal(size=(200, 8)).astype(np.float32)
    mask = rng.random(200) > 0.2
    jm = jmod.PointMLP((8,), use_bias=False)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask), False)
    params, stats = carry(variables, rng)
    sd = params_from_flax(params, stats)
    assert sd["Dense_0.weight"].shape == (8, 8)
    np.testing.assert_array_equal(sd["Dense_0.weight"].numpy(), params["Dense_0"]["kernel"].T)
    want = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                    jnp.asarray(mask), False)
    tm = tmod.PointMLP(8, (8,), use_bias=False).eval()
    tm.load_state_dict(sd, strict=True)
    got = tm(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cin,cout", [(8, 8), (8, 12)])
def test_resblock(level, cin, cout):
    nbr, mask = level
    rng = np.random.default_rng(cin + cout)
    x = rng.normal(size=(nbr.shape[0], cin)).astype(np.float32) * mask.numpy()[:, None]
    jm = jmod.ResBlock(cout, gemm_mode="fused", compute_dtype="float32", packed_io=False)
    args = (jnp.asarray(x), jnp.asarray(nbr.numpy()), jnp.asarray(mask.numpy()), False)
    variables = jm.init(jax.random.PRNGKey(0), *args)
    params, stats = carry(variables, rng)
    want = jm.apply({"params": params, "batch_stats": stats}, *args)
    tm = tmod.ResBlock(cin, cout).eval()
    tm.load_state_dict(params_from_flax(params, stats), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), nbr, mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert hasattr(tm, "Dense_0") == (cin != cout)


def test_unexpected_leaf_raises():
    with pytest.raises(KeyError):
        params_from_flax({"a": {"weird": np.zeros(3)}}, {})
    with pytest.raises(KeyError):
        params_from_flax({}, {"a": {"count": np.zeros(3)}})
