"""MaskedBatchNorm in training mode against the JAX package's flax module
applied with ``train=True, mutable=["batch_stats"]``: the output, the new
running ``mean``/``var`` (torch-convention momentum, unbiased variance) and
the gradients of a random cotangent with respect to the input, ``scale`` and
``bias``. Masks cover mixed rows, padding rows that are all invalid at the
end, and a mask with no valid row at all. f32; atol = rtol = 1e-5 (sums
over a few hundred rows in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticsegforlargescalepointcloud_tpu.models.norm import MaskedBatchNorm as JBN
from panopticsegforlargescalepointcloud_tpu_torch.models.norm import MaskedBatchNorm as TBN
from panopticsegforlargescalepointcloud_tpu_torch.weights import params_from_flax
from torch_jax_cache import jax_compilation_cache  # noqa: F401 (autouse)

torch.set_num_threads(2)


def _mask(kind, n, rng):
    if kind == "mixed":
        return rng.random(n) > 0.3
    if kind == "padded":
        m = np.zeros(n, bool)
        m[: n // 3] = True
        return m
    return np.zeros(n, bool)


@pytest.mark.parametrize("kind", ["mixed", "padded", "none_valid"])
@pytest.mark.parametrize("momentum", [0.1, 0.02])
def test_train_mode_matches_flax(kind, momentum):
    rng = np.random.default_rng(11)
    n, c = 240, 6
    x = (rng.normal(size=(n, c)) * 2.0 + 0.5).astype(np.float32)
    mask = _mask(kind, n, rng)
    x[~mask] = 0.0  # padding rows are zero in the model, as here
    cot = rng.normal(size=(n, c)).astype(np.float32)
    params = {"scale": rng.normal(1.0, 0.2, size=c).astype(np.float32),
              "bias": rng.normal(0.0, 0.2, size=c).astype(np.float32)}
    stats = {"mean": rng.normal(0.0, 0.3, size=c).astype(np.float32),
             "var": (np.abs(rng.normal(size=c)) + 0.5).astype(np.float32)}

    def f(p, xx):
        y, upd = JBN().apply({"params": p, "batch_stats": stats}, xx, jnp.asarray(mask), True,
                             momentum, mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, upd["batch_stats"])

    (_, (jy, jstats)), (jgp, jgx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))

    bn = TBN(c).train()
    bn.load_state_dict(params_from_flax(params, stats), strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    y = bn(xt, torch.from_numpy(mask), momentum)
    (y * torch.from_numpy(cot)).sum().backward()

    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **tol)
    assert np.all(y.detach().numpy()[~mask] == 0)
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(jstats["mean"]), **tol)
    np.testing.assert_allclose(bn.var.numpy(), np.asarray(jstats["var"]), **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **tol)
    np.testing.assert_allclose(bn.scale.grad.numpy(), np.asarray(jgp["scale"]), **tol)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(jgp["bias"]), **tol)


def test_eval_mode_leaves_statistics_alone():
    bn = TBN(3).eval()
    x = torch.randn(50, 3, generator=torch.Generator().manual_seed(0))
    bn(x, torch.ones(50, dtype=torch.bool), 0.5)
    assert torch.equal(bn.mean, torch.zeros(3)) and torch.equal(bn.var, torch.ones(3))
