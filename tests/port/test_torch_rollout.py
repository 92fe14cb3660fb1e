"""The slice end to end: `reset_batch`, `packed_init`, two `step` calls and
`packed_finish` of the port against the JAX package's packed XLA twin and
its Pallas kernel in interpret mode, on the same numpy actions.

Every integer of the carries, states and metrics is byte-exact;
`total_reward` gets rtol=1e-6 because the JAX package and the port sum
rewards in different orders (and XLA rounds the reward formula
differently, see test_torch_step.py).
"""

import dataclasses
import functools
import os
import subprocess
import sys

import jax
import make_family_reference as fref
import numpy as np
import pytest
import torch

import minigrid_tpu
from minigrid_tpu.ops import fused_rollout as jfr
from minigrid_tpu_torch import env_list, make
from minigrid_tpu_torch.core.prng import key
from minigrid_tpu_torch.core.state import EnvConfig
from minigrid_tpu_torch.envs.base import Env
from minigrid_tpu_torch.ops import fused_rollout as tfr
from minigrid_tpu_torch.utils.convert import (
    STATE_FIELDS,
    carry_from_numpy,
    carry_to_numpy,
    state_to_numpy,
)

B = 128
T = 64
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _np_state(s):
    return {f: np.asarray(getattr(s, f)) for f in STATE_FIELDS}


def _np_carry(c):
    return {k: np.asarray(v) for k, v in c._asdict().items()}


def _actions(seed):
    return np.random.default_rng(seed).integers(0, 7, size=(T, B)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_states(env_id, seed):
    env = minigrid_tpu.make(env_id)
    states, _ = jax.jit(env.reset_batch, static_argnums=1)(jax.random.PRNGKey(seed), B)
    return env, states


@functools.lru_cache(maxsize=None)
def _jax_two_calls(env_id, mode, seed, backend):
    """(carry0, [(carry, metrics)] * 2, final states) of the JAX package."""
    env, states = _jax_states(env_id, seed)
    carry0 = jax.jit(lambda s: jfr.packed_init(env, s, mode))(states)
    return _jax_steps(env, mode, backend, carry0, seed)


@functools.lru_cache(maxsize=None)
def _jax_finish(env):
    return jax.jit(lambda c: jfr.packed_finish(env, c))


def _jax_steps(env, mode, backend, carry0, seed):
    kw = dict(mode=mode, as_carry=True, actions_override=_actions(seed))
    if backend == "xla":
        step = jax.jit(jfr.build_packed_xla_rollout(env, T, **kw))
    else:
        step = jax.jit(jfr.build_fused_rollout(env, T, interpret=True, **kw))
    k = jax.random.PRNGKey(0)  # unused: the actions are given
    out, carry = [], carry0
    for _ in range(2):
        carry, metrics = step(k, carry)
        out.append((_np_carry(carry), metrics))
    final = _jax_finish(env)(carry)
    return _np_carry(carry0), out, _np_state(final)


def _assert_metrics(got, want):
    for name in ("episodes", "total_steps", "obs_checksum", "reset_overlaps"):
        g = getattr(got, name)
        assert g.dtype == torch.int32, name
        assert int(g) == int(getattr(want, name)), name
    assert got.total_reward.dtype == torch.float32
    np.testing.assert_allclose(float(got.total_reward), float(want.total_reward), rtol=1e-6)


def _assert_same(got, want, what):
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, (what, name)
        np.testing.assert_array_equal(got[name], want[name], err_msg=f"{what}: {name}")


def _port_two_calls(env, carry, seed, build=tfr.build_fused_rollout, mode="regen"):
    step = build(env, T, mode=mode, as_carry=True, actions_override=_actions(seed))
    out = []
    for _ in range(2):
        carry, metrics = step(None, carry)
        out.append((carry_to_numpy(carry), metrics))
    return out, state_to_numpy(tfr.packed_finish(env, carry))


ENV_IDS = ["MiniGrid-Empty-5x5-v0", "MiniGrid-Empty-8x8-v0", "MiniGrid-DistShift1-v0"]


# The ids whose generators this file compiles live: KeyCorridor's and
# MultiRoom's reset_batch are held against JAX in test_torch_keycorridor.py
# and test_torch_multiroom.py, where their compiles are shared, and the
# families ported with DynamicObstacles, Memory and Unlock hold their
# generators against `data/family_generators_b32.npz`
# (test_torch_dynamicobstacles.py, test_torch_memory_unlock.py), so that
# the tier-1 run compiles none of their JAX generators; so do
# ObstructedMaze's (test_torch_obstructedmaze.py), the deepest of all.
@pytest.mark.parametrize("env_id", [e for e in env_list if "KeyCorridor" not in e and "MultiRoom" not in e
                                    and e not in fref.DYNOBST_IDS + fref.MEMORY_UNLOCK_IDS + fref.OBSTRUCTED_IDS])
def test_reset_batch_matches_jax(env_id):
    _, jstates = _jax_states(env_id, 5)
    got = state_to_numpy(make(env_id).reset_batch(key(5, device="cpu"), B)[0])
    _assert_same(got, _np_state(jstates), env_id)


@pytest.mark.parametrize("mode", ["regen", "cached"])
@pytest.mark.parametrize("env_id", ENV_IDS)
def test_two_call_rollout_matches_jax(env_id, mode):
    seed = len(env_id) + len(mode)
    env = make(env_id)
    carry = tfr.packed_init(env, env.reset_batch(key(seed, device="cpu"), B)[0], mode)
    out, final = _port_two_calls(env, carry, seed, mode=mode)
    for backend in ("xla", "pallas"):
        jcarry0, jout, jfinal = _jax_two_calls(env_id, mode, seed, backend)
        _assert_same(carry_to_numpy(carry), jcarry0, "packed_init")
        for i, ((c, m), (jc, jm)) in enumerate(zip(out, jout)):
            _assert_same(c, jc, f"{backend} call {i}")
            _assert_metrics(m, jm)
        _assert_same(final, jfinal, f"{backend} packed_finish")
    if env_id == "MiniGrid-Empty-5x5-v0":
        # 128 steps > max_steps: every lane reset, so the regen chain ran.
        assert int(out[0][1].episodes) + int(out[1][1].episodes) >= B


def test_doorkey_cached_from_converted_jax_carry():
    """A family the port cannot generate yet runs cached from a JAX carry:
    doors, keys and the occlusion flood (see_through_walls=False)."""
    env_id, seed = "MiniGrid-DoorKey-5x5-v0", 9
    jenv, jstates = _jax_states(env_id, seed)
    jcarry0 = jax.jit(lambda s: jfr.packed_init(jenv, s, "cached"))(jstates)
    env = Env(env_id, EnvConfig(**dataclasses.asdict(jenv.config)), generate=None)
    assert not env.config.see_through_walls
    out, final = _port_two_calls(env, carry_from_numpy(_np_carry(jcarry0), device="cpu"), seed, mode="cached")
    for backend in ("xla", "pallas"):
        _, jout, jfinal = _jax_steps(jenv, "cached", backend, jcarry0, seed)
        for i, ((c, m), (jc, jm)) in enumerate(zip(out, jout)):
            _assert_same(c, jc, f"{backend} call {i}")
            _assert_metrics(m, jm)
        _assert_same(final, jfinal, f"{backend} packed_finish")


def test_plain_twin_and_legacy_surface_agree_with_carry_surface():
    env = make("MiniGrid-DistShift1-v0")
    states, _ = env.reset_batch(key(2, device="cpu"), B)
    actions = _actions(2)
    fused = tfr.build_fused_rollout(env, T, actions_override=actions)
    plain = tfr.build_packed_plain_rollout(env, T, actions_override=actions)
    (s1, m1), (s2, m2) = fused(None, states), plain(None, states)
    step = tfr.build_fused_rollout(env, T, as_carry=True, actions_override=actions)
    c3, m3 = step(None, tfr.packed_init(env, states, "regen"))
    s3 = tfr.packed_finish(env, c3)
    for s in (s2, s3):
        _assert_same(state_to_numpy(s), state_to_numpy(s1), "state")
    for m in (m2, m3):
        for a, b in zip(m, m1):
            assert torch.equal(a, b)


def test_random_policy_draws_from_the_generator():
    env = make("MiniGrid-Empty-8x8-v0")
    carry = tfr.packed_init(env, env.reset_batch(key(0, device="cpu"), B)[0], "regen")
    step = tfr.build_fused_rollout(env, 16, as_carry=True)
    runs = [step(torch.Generator().manual_seed(s), carry) for s in (1, 1, 2)]
    assert torch.equal(runs[0][0].words, runs[1][0].words)
    assert not torch.equal(runs[0][0].regs, runs[2][0].regs)
    with pytest.raises(ValueError):
        step(None, carry)


def test_unported_paths_raise():
    """An id that no registry holds, regen mode on an env without a
    generator, and a transition whose hook is not ported, on an id that
    exists."""
    with pytest.raises(KeyError, match="unknown env id"):
        make("MiniGrid-NoSuchEnv-v0")
    maze = dataclasses.replace(make("MiniGrid-ObstructedMaze-1Dl-v0"), generate=None)
    with pytest.raises(NotImplementedError, match="no generator"):
        tfr.build_fused_rollout(maze, 8, mode="regen")
    with pytest.raises(NotImplementedError, match="no generator"):
        maze.reset_batch(key(0, device="cpu"), 4)
    with pytest.raises(NotImplementedError, match="hooks"):
        tfr.build_fused_rollout(dataclasses.replace(maze, transition="lavagap"), 8, mode="cached")


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys, minigrid_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "assert len(mods) >= 15, mods\n"
        "new = ('core.obs', 'core.view', 'core.vision', 'core.step', 'core.autoreset', 'envs.obstructedmaze')\n"
        "assert all(p.__name__ + '.' + m in mods for m in new), mods\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'minigrid_tpu.')))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr


def test_row_reader_values_match_the_jax_packages():
    """`build_fused_rollout` takes the JAX package's `row_reader` values
    and raises on any other; the readers are a layout choice of the TPU
    kernel, so all three give the same carries, which match
    `build_packed_xla_rollout` (whose forward and view rows are read
    through `_matmul_rows`)."""
    env_id = "MiniGrid-Dynamic-Obstacles-5x5-v0"
    env = make(env_id)
    acts = _actions(2)
    carry0 = tfr.packed_init(env, env.reset_batch(key(2, device="cpu"), B)[0], "cached")
    with pytest.raises(ValueError, match="unknown row_reader"):
        tfr.build_fused_rollout(env, T, mode="cached", row_reader="gather")
    runs = {}
    for reader in ("auto", "slices", "matmul"):
        step = tfr.build_fused_rollout(env, T, mode="cached", as_carry=True, actions_override=acts, row_reader=reader)
        runs[reader] = carry_to_numpy(step(None, carry0)[0])
    jstep = jax.jit(jfr.build_packed_xla_rollout(minigrid_tpu.make(env_id), T, mode="cached", as_carry=True,
                                                 actions_override=acts))
    jc, _ = jstep(jax.random.PRNGKey(0), jfr.PackedCarry(**carry_to_numpy(carry0)))
    for reader, got in runs.items():
        for name, arr in got.items():
            np.testing.assert_array_equal(arr, np.asarray(getattr(jc, name)), err_msg=f"{reader} {name}")
