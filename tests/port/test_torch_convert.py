"""Round trips across the framework boundary: a JAX state or packed carry
-> numpy -> the port -> numpy comes back byte for byte."""

import functools

import jax
import numpy as np
import pytest
import torch

import minigrid_tpu
from minigrid_tpu.ops import fused_rollout as jfr
from minigrid_tpu_torch.ops.fused_rollout import PackedCarry
from minigrid_tpu_torch.utils.convert import (
    CARRY_FIELDS,
    STATE_FIELDS,
    carry_from_numpy,
    carry_to_numpy,
    state_from_numpy,
    state_to_numpy,
)

B = 32


@functools.lru_cache(maxsize=None)
def _jax_state_and_carry(env_id):
    env = minigrid_tpu.make(env_id)
    states, _ = jax.jit(env.reset_batch, static_argnums=1)(jax.random.PRNGKey(4), B)
    carry = jax.jit(lambda s: jfr.packed_init(env, s, "cached"))(states)
    return (
        {f: np.asarray(getattr(states, f)) for f in STATE_FIELDS},
        {k: np.asarray(v) for k, v in carry._asdict().items()},
    )


@pytest.mark.parametrize("env_id", ["MiniGrid-DoorKey-8x8-v0", "MiniGrid-Empty-5x5-v0"])
def test_state_round_trip(env_id):
    want, _ = _jax_state_and_carry(env_id)
    state = state_from_numpy(want, device="cpu")
    assert state.rng.dtype == torch.int64 and state.grid.dtype == torch.uint8
    got = state_to_numpy(state)
    for name in STATE_FIELDS:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("env_id", ["MiniGrid-DoorKey-8x8-v0", "MiniGrid-Empty-5x5-v0"])
def test_carry_round_trip(env_id):
    _, want = _jax_state_and_carry(env_id)
    assert tuple(want) == CARRY_FIELDS == PackedCarry._fields
    carry = carry_from_numpy(want, device="cpu")
    assert all(getattr(carry, k).dtype == torch.int32 for k in ("words", "regs", "tmpl_words", "tmpl_regs"))
    got = carry_to_numpy(carry)
    for name in CARRY_FIELDS:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_rng_leaf_must_be_uint32():
    want, carry = _jax_state_and_carry("MiniGrid-Empty-5x5-v0")
    with pytest.raises(TypeError, match="uint32"):
        state_from_numpy({**want, "rng": want["rng"].astype(np.int32)}, device="cpu")
    with pytest.raises(TypeError, match="uint32"):
        carry_from_numpy({**carry, "rng": carry["rng"].astype(np.int64)}, device="cpu")
