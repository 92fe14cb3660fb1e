"""The port's packed layout against `minigrid_tpu/ops/packing.py`, on
JAX-made DoorKey-8x8 states and on random `testing.py` states."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minigrid_tpu
from minigrid_tpu.core.state import EnvConfig as JaxEnvConfig
from minigrid_tpu.ops import packing as jpk
from minigrid_tpu_torch.core.state import EnvConfig
from minigrid_tpu_torch.ops import packing as tpk
from minigrid_tpu_torch.testing import random_packed_case
from minigrid_tpu_torch.utils.convert import STATE_FIELDS, state_from_numpy, state_to_numpy

B = 64


@functools.lru_cache(maxsize=None)
def _doorkey_states():
    env = minigrid_tpu.make("MiniGrid-DoorKey-8x8-v0")
    states, _ = jax.jit(env.reset_batch, static_argnums=1)(jax.random.PRNGKey(3), B)
    leaves = {f: np.asarray(getattr(states, f)) for f in STATE_FIELDS}
    return env, states, leaves


def test_pack_states_matches_jax_on_doorkey():
    _, states, leaves = _doorkey_states()
    jw, jr = jax.jit(jpk.pack_states)(states)
    tw, tr = tpk.pack_states(state_from_numpy(leaves, device="cpu"))
    assert tw.dtype == torch.int32 and tr.dtype == torch.int32
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_unpack_inverts_pack_on_doorkey():
    env, _, leaves = _doorkey_states()
    cfg = EnvConfig(**dataclasses.asdict(env.config))
    back = state_to_numpy(tpk.unpack_states(*tpk.pack_states(state_from_numpy(leaves, device="cpu")), cfg))
    for name, want in leaves.items():
        assert back[name].dtype == want.dtype, name
        np.testing.assert_array_equal(back[name], want, err_msg=name)


@pytest.mark.parametrize("size", [(5, 5), (9, 7)])
def test_unpack_matches_jax_on_random_states(size):
    w, h = size
    case = random_packed_case(11, w, h, B, 4 * w * h)
    cfg = EnvConfig(family="empty", width=w, height=h, max_steps=4 * w * h)
    jcfg = JaxEnvConfig(**dataclasses.asdict(cfg))
    want = jax.jit(jpk.unpack_states, static_argnums=2)(jnp.asarray(case["words"]), jnp.asarray(case["regs"]), jcfg)
    got = state_to_numpy(
        tpk.unpack_states(torch.from_numpy(case["words"]), torch.from_numpy(case["regs"]), cfg)
    )
    for name, g in got.items():
        w_ = np.asarray(getattr(want, name))
        assert g.dtype == w_.dtype, name
        np.testing.assert_array_equal(g, w_, err_msg=name)


def test_key_rows_round_trip_matches_jax():
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 2**32, size=(1000, 2), dtype=np.uint64).astype(np.uint32)
    rows = tpk.key_rows(torch.from_numpy(keys.astype(np.int64)))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jax.jit(jpk.key_rows)(jnp.asarray(keys))))
    np.testing.assert_array_equal(tpk.rows_key(rows).numpy().astype(np.uint32), keys)


@pytest.mark.parametrize("hw", [25, 63, 64])
def test_roll_to_base_matches_jax(hw):
    rng = np.random.default_rng(hw)
    words = rng.integers(0, 2**20, size=(hw, 200)).astype(np.int32)
    base = rng.integers(0, hw, size=(1, 200)).astype(np.int32)
    want = jax.jit(jpk._roll_to_base)(jnp.asarray(words), jnp.asarray(base))
    got = tpk._roll_to_base(torch.from_numpy(words), torch.from_numpy(base))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dims", [(5, 5, 7), (8, 8, 7), (9, 7, 7), (8, 8, 5), (25, 25, 7)])
def test_dir_tables_match_jax(dims):
    for got, want in zip(tpk._dir_tables(*dims), jpk._dir_tables(*dims)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("view", [3, 5, 7])
def test_visibility_bitmask_matches_jax(view):
    rng = np.random.default_rng(view)
    trans = rng.integers(0, 1 << view, size=(view, 500)).astype(np.int32)
    want = jax.jit(jpk.visibility_bitmask, static_argnums=1)(jnp.asarray(trans), view)
    got = tpk.visibility_bitmask(torch.from_numpy(trans), view)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
