"""The embed family's random dimension subsets: the port draws them on the
host with numpy (``utils/prng.py``), the JAX package with ``jax.random``
(threefry2x32, ``jax_threefry_partitionable``). Every primitive and the
masks of ``_subset_masks`` must be equal bit for bit, over 64 counters x
the 25 runs of 3 ops x 2 tags x 2 base seeds (6,400 mask rows)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from panopticsegforlargescalepointcloud_tpu.models import pointgroup3heads as jpg
from panopticsegforlargescalepointcloud_tpu_torch.models import pointgroup3heads as tpg
from panopticsegforlargescalepointcloud_tpu_torch.utils import prng
from torch_jax_cache import jax_compilation_cache  # noqa: F401 (autouse)

KEYS = [0, 1, 7, 2022, 2**31 - 1]


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def test_partitionable_threefry_is_the_default():
    """The draws follow JAX's defaults; a change there must show here."""
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", KEYS)
def test_key_fold_in_split(seed):
    np.testing.assert_array_equal(prng.prng_key(seed), np.asarray(_jkey(seed)))
    for data in (0, 1, 131, 2**31 - 1, 2**32 - 1):
        np.testing.assert_array_equal(prng.fold_in(prng.prng_key(seed), data),
                                      np.asarray(jax.random.fold_in(_jkey(seed),
                                                                    jnp.uint32(data))))
    for num in (2, 3, 5):
        np.testing.assert_array_equal(prng.split(prng.prng_key(seed), num),
                                      np.asarray(jax.random.split(_jkey(seed), num)))


@pytest.mark.parametrize("seed", KEYS)
def test_bits_uniform_randint(seed):
    key, jkey = prng.prng_key(seed), _jkey(seed)
    for shape in ((), (8,), (3, 5)):
        np.testing.assert_array_equal(prng.random_bits(key, shape),
                                      np.asarray(jax.random.bits(jkey, shape, jnp.uint32)))
        np.testing.assert_array_equal(prng.uniform(key, shape),
                                      np.asarray(jax.random.uniform(jkey, shape)))
    for low, high in ((3, 6), (2, 6), (0, 1), (0, 9), (5, 1000003)):
        assert prng.randint(key, low, high) == int(jax.random.randint(jkey, (), low, high))


@pytest.mark.parametrize("base", [0, 11])
@pytest.mark.parametrize("op", [("both", 9, 3, 5), ("embed", 6, 2, 5), ("embed", 10, 3, 5)])
@pytest.mark.parametrize("tag", [0, 2])
def test_subset_masks_equal_jax(op, tag, base):
    """``_subset_masks`` with per-sample keys, as ``_embed_proposals`` of the
    JAX package builds them from the counters."""
    space, loops, low, high = op
    counters = np.arange(64, dtype=np.int64) * 977 + 5
    jcfg = jpg.PanopticConfig(num_classes=9, stuff_classes=(0,), model_family="embed",
                              cluster_type=7, embed_subset_seed=base)
    cfg = tpg.PanopticConfig(num_classes=9, stuff_classes=(0,), model_family="embed",
                             cluster_type=7, num_samples=64, ms_max_clusters=1,
                             embed_subset_seed=base)
    keys = jax.vmap(lambda s: jax.random.fold_in(jax.random.PRNGKey(base), s))(
        jnp.asarray(counters, jnp.uint32))
    want = np.asarray(jpg._subset_masks(jcfg, space, loops, low, high, subset_key=keys,
                                        tag=tag))
    got = tpg._subset_masks(cfg, space, loops, low, high, tpg._subset_seeds(cfg, counters),
                            tag)
    assert got.shape == want.shape == (64, loops, 8)
    np.testing.assert_array_equal(got, want)
    sizes = got.sum(-1)
    assert sizes.min() >= low and sizes.max() <= high and len(np.unique(sizes)) > 1


@pytest.mark.parametrize("op", [("xyz", 0, 0, 0), ("both", 9, 3, 5), ("embed", 6, 2, 5)])
def test_fixed_masks_equal_jax(op):
    """Without a counter: the fixed numpy masks of ``embed_subset_seed``."""
    jcfg = jpg.PanopticConfig(num_classes=9, stuff_classes=(0,), model_family="embed",
                              cluster_type=7, embed_subset_seed=3)
    cfg = tpg.PanopticConfig(num_classes=9, stuff_classes=(0,), model_family="embed",
                             cluster_type=7, embed_subset_seed=3)
    np.testing.assert_array_equal(tpg._subset_masks(cfg, *op),
                                  np.asarray(jpg._subset_masks(jcfg, *op)))


def test_subset_seeds_broadcast_and_check():
    cfg = tpg.PanopticConfig(num_classes=9, stuff_classes=(0,), model_family="embed",
                             cluster_type=7, num_samples=3)
    np.testing.assert_array_equal(tpg._subset_seeds(cfg, 4), [4, 4, 4])
    np.testing.assert_array_equal(tpg._subset_seeds(cfg, np.arange(3) + 9), [9, 10, 11])
    assert tpg._subset_seeds(cfg, None) is None
    with pytest.raises(ValueError):
        tpg._subset_seeds(cfg, [1, 2])


def test_mask_columns():
    masks = np.zeros((2, 1, 8), np.float32)
    masks[0, 0, [3, 5]] = 1
    masks[1, 0, [4, 6, 7]] = 1
    np.testing.assert_array_equal(tpg._mask_columns(masks, 4), [[3, 5, 8, 8], [4, 6, 7, 8]])
