"""The port's Threefry and key recipes, bit for bit against jax.random and
the JAX package's `core.prng` on numpy-made keys."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minigrid_tpu.core import prng as jprng
from minigrid_tpu_torch.core import prng

N_KEYS = 10_000


def _keys(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=(N_KEYS, 2), dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("n", [2, 5])
def test_split_matches_jax_random_split(n):
    keys = _keys(n)
    want = np.asarray(jax.vmap(lambda k: jax.random.split(k, n))(jnp.asarray(keys)))
    got = prng.split(_t(keys), n).numpy()
    assert got.dtype == np.int64 and got.min() >= 0 and got.max() < 2**32
    np.testing.assert_array_equal(got.astype(np.uint32), want)


def test_threefry_matches_core_prng():
    rng = np.random.default_rng(7)
    k0, k1, x0, x1 = rng.integers(-(2**31), 2**31, size=(4, N_KEYS)).astype(np.int32)
    want = jax.jit(jprng.threefry2x32)(k0, k1, x0, x1)
    got = prng.threefry2x32(*(_t(v.view(np.uint32)) for v in (k0, k1, x0, x1)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.uint32), np.asarray(w).view(np.uint32))


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1])
def test_key_matches_prng_key(seed):
    want = np.asarray(jax.random.PRNGKey(seed))
    np.testing.assert_array_equal(prng.key(seed, device="cpu").numpy().astype(np.uint32), want)


def test_key_rejects_negative_seed():
    with pytest.raises(ValueError):
        prng.key(-1, device="cpu")
