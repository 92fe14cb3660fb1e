"""The port's Threefry and key recipes, bit for bit against jax.random and
the JAX package's `core.prng` on numpy-made keys: split, bits, randint
(static and per-lane bounds), categorical over 0/-inf masks,
permutation (with its stable sort held to `lax.sort_key_val` on tied sort
keys), the permutation of per-lane values, `fold_in`, and the random
policy's `(T, B)` stream from one key."""

import functools

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


# randint spans (lo, hi): the generators draw 0..cols, 0..rows, 0..4, 0..6
# and door rows ty+1..ty+rs-1; hi <= lo gives lo.
SPANS = [(0, 1), (0, 3), (0, 4), (0, 6), (0, 30), (1, 5), (7, 12), (11, 41), (3, 3)]


def _draw_inputs():
    """Keys, per-lane bounds (spans 1-30, some hi <= lo) and 0/-inf masks
    (all-False rows get the JAX package's fallback: zero logits)."""
    rng = np.random.default_rng(12)
    lo = rng.integers(0, 20, N_KEYS).astype(np.int32)
    hi = lo + rng.integers(-2, 31, N_KEYS).astype(np.int32)
    valid = rng.random((N_KEYS, 96)) < rng.random((N_KEYS, 1))  # 0 to 96 valid cells a row
    valid[:64] = False
    logits = np.where(valid, 0.0, -np.inf).astype(np.float32)
    logits[~valid.any(axis=1)] = 0.0
    return _keys(11), lo, hi, logits


@functools.lru_cache(maxsize=None)
def _jax_draws():
    """jax.random's draws on `_draw_inputs()`, in one compile: randint over
    every static span, randint with the per-lane bounds, categorical."""
    keys, lo, hi, logits = _draw_inputs()

    def draw(k, a, b, lg):
        static = jnp.stack([jax.random.randint(k, (), l_, h_) for l_, h_ in SPANS])
        return static, jax.random.randint(k, (), a, b), jax.random.categorical(k, lg)

    return tuple(np.asarray(x) for x in jax.jit(jax.vmap(draw))(jnp.asarray(keys), lo, hi, logits))


@pytest.mark.parametrize("i", range(len(SPANS)), ids=[f"{lo}-{hi}" for lo, hi in SPANS])
def test_randint_matches_jax_random_randint(i):
    keys = _draw_inputs()[0]
    lo, hi = SPANS[i]
    got = prng.randint(_t(keys), lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _jax_draws()[0][:, i])


def test_randint_per_lane_bounds_match_jax():
    keys, lo, hi, _ = _draw_inputs()
    got = prng.randint(_t(keys), torch.from_numpy(lo), torch.from_numpy(hi))
    np.testing.assert_array_equal(got.numpy(), _jax_draws()[1])


def test_categorical_matches_jax_random_categorical_on_masks():
    keys, _, _, logits = _draw_inputs()
    got = prng.categorical(_t(keys), torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), _jax_draws()[2])


def test_jax_gumbel_rises_strictly_with_the_uniform_bits():
    """Road (b) of the port's categorical: jax 0.9's gumbel `-log(-log(u))`
    in f32 (`_gumbel`, mode "low", `u = uniform(tiny, 1)`), evaluated by
    XLA over every one of the 2^23 values `m = bits >> 9` that `u` can
    take, is strictly increasing in `m`. So `argmax(logits + gumbel)` over
    0/-inf logits is the first index of the largest `m` among the valid
    cells, which `prng.categorical` takes with an integer argmax."""

    def gumbel_of_m(m):
        floats = jax.lax.bitcast_convert_type(m | jnp.uint32(0x3F800000), jnp.float32) - 1.0
        tiny = jnp.float32(np.finfo(np.float32).tiny)
        u = jnp.maximum(tiny, floats * (jnp.float32(1.0) - tiny) + tiny)
        return -jnp.log(-jnp.log(u))

    g = np.asarray(jax.jit(gumbel_of_m)(jnp.arange(2**23, dtype=jnp.uint32)))
    assert np.isfinite(g).all()
    assert (np.diff(g) > 0).all()


PERMUTATION_SIZES = (1, 2, 6, 18, 40)


@functools.lru_cache(maxsize=None)
def _jax_permutations():
    """`jax.random.permutation` at every size of `PERMUTATION_SIZES`, in one
    compile: `{n: (B, n)}` on `_keys(100)[:2000]`."""
    perms = jax.jit(lambda ks: tuple(jax.vmap(lambda k, n=n: jax.random.permutation(k, n))(ks)
                                     for n in PERMUTATION_SIZES))(jnp.asarray(_keys(100)[:2000]))
    return {n: np.asarray(p) for n, p in zip(PERMUTATION_SIZES, perms)}


@pytest.mark.parametrize("n", PERMUTATION_SIZES)
def test_permutation_matches_jax_random_permutation(n):
    got = prng.permutation(_t(_keys(100)[:2000]), n).numpy()
    np.testing.assert_array_equal(got, _jax_permutations()[n])


def test_permutation_sort_keeps_ties_in_order_as_lax_sort_key_val():
    """32-bit sort keys tie about once in 2^33 draws of a pair, so the tie
    is forced: three keys of each of a few values, in random order."""
    rng = np.random.default_rng(5)
    sort_keys = rng.choice(np.array([0, 7, 2**31, 2**32 - 1], np.uint32), size=(64, 18))
    values = np.tile(np.arange(18, dtype=np.int32), (64, 1))
    want = np.asarray(jax.jit(jax.vmap(lambda k, v: jax.lax.sort_key_val(k, v)[1]))(sort_keys, values))
    got = prng.sort_key_val(_t(sort_keys), _t(values)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (np.diff(np.sort(sort_keys, axis=1), axis=1) == 0).any()


@pytest.mark.parametrize("n", [2, 8])
def test_hash_u31_matches_jax_at_the_walk_counters(n):
    """The DynamicObstacles walk's draws: `hash_u31(rng rows, step_count·n
    + i)` with the counter an int32 that wraps, at step counts from 0 to
    just past 2**31 / n."""
    rng = np.random.default_rng(n)
    k = rng.integers(-(2**31), 2**31, (2, 64), dtype=np.int64).astype(np.int32)
    sc = np.concatenate([np.arange(8), 2**31 // n - 4 + np.arange(8), rng.integers(0, 2**31 // n, 48)]).astype(np.int32)
    counters = (sc[None, :].astype(np.int64) * n + np.arange(n)[:, None]).astype(np.uint32).view(np.int32)
    want = jax.jit(lambda k0, k1, c: jprng.hash_u31(k0, k1, c))(jnp.asarray(k[0]), jnp.asarray(k[1]),
                                                                 jnp.asarray(counters))
    got = prng.hash_u31(torch.from_numpy(k[0]), torch.from_numpy(k[1]),
                        torch.from_numpy(sc).to(torch.int64)[None, :] * n + torch.arange(n)[:, None])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (counters < 0).any()  # the counter wrapped


@pytest.mark.parametrize("data", [0, 1, 2, 7, 2**31, 2**32 - 1])
def test_fold_in_matches_jax_random_fold_in(data):
    keys = _keys(200 + data % 97)[:2000]
    want = np.asarray(jax.jit(jax.vmap(lambda k: jax.random.fold_in(k, data)))(jnp.asarray(keys)))
    got = prng.fold_in(_t(keys), data).numpy()
    assert got.dtype == np.int64 and got.min() >= 0 and got.max() < 2**32
    np.testing.assert_array_equal(got.astype(np.uint32), want)


def test_fold_in_rejects_data_outside_uint32():
    for data in (-1, 2**32):
        with pytest.raises(ValueError, match="uint32"):
            prng.fold_in(_t(_keys(1)[:4]), data)


@pytest.mark.parametrize("n,values", [(2, "mask"), (3, "mask"), (5, "mask"), (6, "positions"), (8, "positions"),
                                      (40, "positions")])
def test_permute_matches_jax_random_permutation_of_an_array(n, values):
    """Crossing's draws: the path's move kinds `arange(n) < nv` (many ties
    among the values), and arbitrary per-lane values; jax takes its round
    count from the array's length."""
    rng = np.random.default_rng(n)
    keys = _keys(300 + n)[:2000]
    if values == "mask":
        x = (np.arange(n)[None, :] < rng.integers(0, n + 1, (2000, 1))).astype(np.int32)
    else:
        x = rng.integers(-50, 50, (2000, n)).astype(np.int32)
    want = np.asarray(jax.jit(jax.vmap(lambda k, v: jax.random.permutation(k, v)))(jnp.asarray(keys),
                                                                                    jnp.asarray(x)))
    got = prng.permute(_t(keys), torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("num_actions,b", [(7, 37), (3, 256)])
def test_randint_stream_is_the_jax_packages_random_policy(num_actions, b):
    """`split(key, T)`, then `randint(key_t, (B,), 0, A)` per step, as the
    JAX package's packed rollouts draw the random policy."""
    from minigrid_tpu.core.rollout import random_policy

    t = 9
    policy = random_policy(num_actions)
    k = jax.random.PRNGKey(num_actions * 1000 + b)
    want = np.asarray(jax.jit(lambda k: jax.vmap(lambda kt: policy(kt, jnp.zeros((b, 1), jnp.int32)))(
        jax.random.split(k, t)))(k))
    got = prng.randint_stream(_t(k), t, b, 0, num_actions)
    assert got.dtype == torch.int32 and tuple(got.shape) == (t, b)
    np.testing.assert_array_equal(got.numpy(), want)
