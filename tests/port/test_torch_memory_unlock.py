"""Memory, Unlock, UnlockPickup and BlockedUnlockPickup in the port against
the JAX package on the CPU:

  * each generator byte for byte per registered id (the RoomGrid helpers
    `init`, `add_door`, `add_object`, `place_agent` batched over lanes),
    against `jax.vmap(generate)` (B = 32) as `make_family_reference.py`
    stored it in `data/family_generators_b32.npz` (the `slow` test
    recomputes it live), with its configuration and transition;
  * the Memory and Unlock hooks through `step_core`: `plain_rollout`
    against `build_packed_xla_rollout(mode="cached")` under forced actions
    0-6, two calls of T = 12, on `testing.hooked_packed_case` states (the
    success or failure cell ahead of each Memory agent; Unlock's door in
    the forward cell of half the lanes, elsewhere on the others) and on
    the family's own `reset_batch` states: carries, `episodes` and
    `obs_checksum` byte-exact, `total_reward` to rtol 1e-6 (ROADMAP.md
    §C); the hook must change the outcome against the base step;
  * Memory's remap (pickup acts as toggle) and Unlock's door, each in one
    step against the JAX package's `_step_core`;
  * regen mode at MemoryS7, Unlock and BlockedUnlockPickup from
    `data/regen_train_reference.npz` (`make_regen_train_reference.py`).

Kernel against plain version: test_torch_hook_kernels.py (on a card).
"""

import dataclasses
import functools

import make_family_reference as fref
import make_regen_train_reference as rref
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import minigrid_tpu  # noqa: E402
from minigrid_tpu.ops import fused_rollout as jfr  # noqa: E402
from minigrid_tpu_torch import env_list, make  # noqa: E402
from minigrid_tpu_torch.core import constants as C  # noqa: E402
from minigrid_tpu_torch.core.prng import key, split  # noqa: E402
from minigrid_tpu_torch.ops import fused_rollout as tfr  # noqa: E402
from minigrid_tpu_torch.ops.packing import R_AUX, R_DIR, R_X, R_Y  # noqa: E402
from minigrid_tpu_torch.testing import hooked_packed_case  # noqa: E402
from test_torch_hooks import assert_step_outputs as _assert_step_outputs  # noqa: E402
from minigrid_tpu_torch.utils.convert import carry_to_numpy  # noqa: E402

IDS = fref.MEMORY_UNLOCK_IDS
TRANSITIONS = {"memory": "memory", "unlock": "unlock", "unlockpickup": "pickup_target",
               "blockedunlockpickup": "pickup_target"}
SMALL = {"memory": "MiniGrid-MemoryS7-v0", "unlock": "MiniGrid-Unlock-v0"}
B = 64
T = 12


def test_ids_and_missions_are_the_jax_packages():
    assert IDS == [e for e in env_list if e.startswith(("MiniGrid-Memory", "MiniGrid-Unlock", "MiniGrid-BlockedUnlock"))]
    from minigrid_tpu_torch.envs import memory, unlock, unlockpickup

    for mod, name in ((memory, "memory"), (unlock, "unlock"), (unlockpickup, "unlockpickup")):
        assert mod.MISSION == getattr(__import__(f"minigrid_tpu.envs.{name}", fromlist=["MISSION"]), "MISSION")


@pytest.mark.parametrize("env_id", IDS)
def test_generator_and_registration_match_jax(env_id):
    env, jenv = make(env_id), minigrid_tpu.make(env_id)
    assert dataclasses.asdict(env.config) == dataclasses.asdict(jenv.config)
    assert env.transition == TRANSITIONS[env.config.family]
    fref.assert_port_matches(env_id, fref.states(env_id))


@pytest.mark.slow
@pytest.mark.parametrize("env_id", IDS)
def test_generator_reference_file_matches_jax(env_id):
    fref.assert_port_matches(env_id, fref.jax_states(env_id))


def _actions(seed, t=T, b=B):
    return np.random.default_rng(seed).integers(0, 7, (t, b)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_cached(env_id, seed):
    env = minigrid_tpu.make(env_id)
    return jax.jit(jfr.build_packed_xla_rollout(env, T, mode="cached", as_carry=True, actions_override=_actions(seed)))


def _two_calls(env, carry, seed, transition=None):
    """Two cached-mode calls of the plain path (under `transition` if
    given) from one carry; without `transition` each is held against the
    JAX package's. Returns the port's metrics."""
    compare = transition is None
    if not compare:
        env = dataclasses.replace(env, transition=transition)
    step = tfr.build_packed_plain_rollout(env, T, mode="cached", as_carry=True, actions_override=_actions(seed))
    jc = jfr.PackedCarry(**{k: jnp.asarray(v) for k, v in carry_to_numpy(carry).items()})
    out = []
    for i in range(2):
        carry, m = step(None, carry)
        if compare:
            jc, jm = _jax_cached(env.env_id, seed)(jax.random.PRNGKey(0), jc)
            for name, got in carry_to_numpy(carry).items():
                np.testing.assert_array_equal(got, np.asarray(getattr(jc, name)), err_msg=f"call {i} {name}")
            for name in ("episodes", "obs_checksum", "reset_overlaps"):
                assert int(getattr(m, name)) == int(getattr(jm, name)), (i, name)
            np.testing.assert_allclose(float(m.total_reward), float(jm.total_reward), rtol=1e-6)
        out.append((int(m.episodes), round(float(m.total_reward), 4)))
    return out


@pytest.mark.parametrize("family", sorted(SMALL))
def test_hook_matches_jax_packed_xla_rollout(family):
    env = make(SMALL[family])
    cfg = env.config
    case = hooked_packed_case(3, env.transition, cfg.width, cfg.height, B, cfg.max_steps)
    carry = tfr.PackedCarry(*(torch.from_numpy(case[k]) for k in ("words", "regs", "tmpl_words", "tmpl_regs")),
                            rng=split(key(1, device="cpu"), B))
    got = _two_calls(env, carry, 0)
    assert got != _two_calls(env, carry, 0, transition="base")  # the hook fired
    assert sum(r for _, r in got) > 0
    _two_calls(env, tfr.packed_init(env, env.reset_batch(key(9, device="cpu"), B)[0], "cached"), 0)


@functools.lru_cache(maxsize=None)
def _jax_step(env_id):
    jenv = minigrid_tpu.make(env_id)
    cfg = jenv.config
    hook, remap, pre = jfr._packed_hook(jenv)
    return jax.jit(functools.partial(jfr._step_core, width=cfg.width, height=cfg.height, view=cfg.agent_view_size,
                                     max_steps=cfg.max_steps, see_through_walls=cfg.see_through_walls, hook=hook,
                                     remap_action=remap, pre_hook=pre))


def _one_step(env_id, case, action, transition):
    """One step of `step_core` under `transition`; under the family's own,
    held against the JAX package's `_step_core`."""
    cfg = make(env_id).config
    args = [case["words"], case["regs"], np.full((1, B), action, np.int32), case["tmpl_words"], case["tmpl_regs"]]
    got = tfr.step_core(*(torch.from_numpy(x) for x in args), width=cfg.width, height=cfg.height,
                        view=cfg.agent_view_size, max_steps=cfg.max_steps, see_through_walls=cfg.see_through_walls,
                        **tfr.hook_kwargs(transition, cfg))
    if transition != "base":
        _assert_step_outputs(got, _jax_step(env_id)(*args))
    return got


def _fwd_rows(case, width, height):
    hw = width * height
    d = case["regs"][R_DIR]
    dx, dy = np.array([1, 0, -1, 0])[d], np.array([0, 1, 0, -1])[d]
    return (dy * width + dx) % hw


def test_memory_pickup_acts_as_toggle():
    """Every agent faces a closed door: pickup (3) opens it, as toggle
    (5) does, where the base step's pickup leaves it shut."""
    env_id = SMALL["memory"]
    cfg = make(env_id).config
    case = hooked_packed_case(4, "memory", cfg.width, cfg.height, B, cfg.max_steps)
    rows = _fwd_rows(case, cfg.width, cfg.height)
    lanes = np.arange(B)
    case["words"][rows, lanes] = C.DOOR | (C.RED << 4) | (C.STATE_CLOSED << 8)
    case["regs"][R_AUX : R_AUX + 4] = -5  # no success or failure cell in reach
    picked = _one_step(env_id, case, 3, "memory")
    toggled = _one_step(env_id, case, 5, "memory")
    base = _one_step(env_id, case, 3, "base")
    live = ~picked[3][0]  # lanes not reset by truncation
    assert int(live.sum()) > 0
    state = (picked[0][rows, lanes] >> 8) & 15
    assert bool((state[live] == C.STATE_OPEN).all())
    assert torch.equal(picked[0], toggled[0]) and torch.equal(picked[1], toggled[1])
    assert bool((((base[0][rows, lanes] >> 8) & 15)[live] == C.STATE_CLOSED).all())


def test_unlock_door_in_front_and_elsewhere():
    """A toggle rewards where it leaves the door open: the door ahead that
    it opens (closed, or locked with the key of its colour in hand), or a
    door elsewhere that already stood open; locked without the key, or
    closed elsewhere, it does not."""
    env_id = SMALL["unlock"]
    cfg = make(env_id).config
    case = hooked_packed_case(5, "unlock", cfg.width, cfg.height, B, cfg.max_steps)
    regs = case["regs"]
    x, y = regs[R_X], regs[R_Y]
    d = regs[R_DIR]
    front = (regs[R_AUX] == x + np.array([1, 0, -1, 0])[d]) & (regs[R_AUX + 1] == y + np.array([0, 1, 0, -1])[d])
    assert 0 < front.sum() < B
    reward, done = _one_step(env_id, case, 5, "unlock")[2:4]
    base_reward = _one_step(env_id, case, 5, "base")[2]
    fired = (reward != base_reward)[0].numpy()
    assert fired[front].any() and fired[~front].any() and not fired.all()
    assert bool(done[0, torch.from_numpy(fired)].all())


@pytest.mark.parametrize("name", ["mem_random_regen", "unlock_random_regen", "bup_random_regen"])
def test_regen_matches_jax_from_file(name):
    rref.assert_port_random_case(name)
