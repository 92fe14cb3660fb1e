"""The five family hooks ported with their families (Fetch, GoToDoor,
GoToObject, PutNear, RedBlueDoors), in the port against the JAX package on
the CPU:

  * each family's generator, byte for byte per registered id, against
    `jax.vmap(generate)` (B = 32) as `make_family_reference.py` stored it
    in `data/family_generators_b32.npz` (the `slow` test recomputes it
    live), and its registration (configuration, transition, mission
    template ids);
  * each hook through `step_core`: the plain rollout against
    `build_packed_xla_rollout(mode="cached")`, two calls of T = 12 from the
    same carry and actions, at the family's smallest grid, on
    `testing.hooked_packed_case` states (aux rows as the family lays them
    out, the hook's events planted in front of each agent) and on the
    family's own `reset_batch` states: carries, `episodes` and
    `obs_checksum` byte-exact, `total_reward` to rtol 1e-6 (the batch-sum
    order, ROADMAP.md §C); the hook must change the outcome against the
    base step;
  * Fetch-5x5-N2 in regen mode (chunked regen on the batched `generate`)
    at chunks 4 and 8 with `max_steps` cut to 5, so that resets are
    deferred.

The hooks ported with Memory, Unlock and DynamicObstacles:
test_torch_memory_unlock.py and test_torch_dynamicobstacles.py; here,
each of the nine hooks against the JAX package's on the same `HookVals`.

Kernel against plain version: test_torch_hook_kernels.py (on a card).
"""

import dataclasses
import functools

import make_family_reference as fref
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import minigrid_tpu  # noqa: E402
from minigrid_tpu.envs import missions as jmissions  # noqa: E402
from minigrid_tpu.ops import fused_rollout as jfr  # noqa: E402
from minigrid_tpu_torch import env_list, make  # noqa: E402
from minigrid_tpu_torch.core import constants as C  # noqa: E402
from minigrid_tpu_torch.core.prng import key, split  # noqa: E402
from minigrid_tpu_torch.envs import fetch  # noqa: E402
from minigrid_tpu_torch.ops import fused_rollout as tfr  # noqa: E402
from minigrid_tpu_torch.ops import packed_hooks as tph  # noqa: E402
from minigrid_tpu_torch.testing import hooked_packed_case  # noqa: E402
from minigrid_tpu_torch.utils.convert import carry_to_numpy  # noqa: E402

FAMILIES = {"fetch": "Fetch", "gotodoor": "GoToDoor", "gotoobject": "GoToObject", "putnear": "PutNear",
            "redbluedoors": "RedBlueDoors"}
HOOKED_IDS = fref.HOOKED_IDS
# Each family's smallest grid.
SMALL = {"fetch": "MiniGrid-Fetch-5x5-N2-v0", "gotodoor": "MiniGrid-GoToDoor-5x5-v0",
         "gotoobject": "MiniGrid-GoToObject-6x6-N2-v0", "putnear": "MiniGrid-PutNear-6x6-N2-v0",
         "redbluedoors": "MiniGrid-RedBlueDoors-6x6-v0"}
B = 64
T = 12


def test_the_twelve_hooked_ids_are_registered():
    assert HOOKED_IDS == [e for e in env_list if any(e.startswith(f"MiniGrid-{n}-") for n in FAMILIES.values())]
    assert len(HOOKED_IDS) == 12
    assert sorted(tph.HOOKS) == sorted(["pickup_target", *FAMILIES, "memory", "unlock", "dynamicobstacles"])
    assert sorted(tph.KERNEL_HOOK_IDS.values()) == list(range(10))
    assert sorted(tph.PRE_HOOK_FACTORIES) == ["dynamicobstacles"]
    assert sorted(tph.ACTION_REMAPS) == ["dynamicobstacles", "memory"]


@pytest.mark.parametrize("env_id", HOOKED_IDS)
def test_generator_and_registration_match_jax(env_id):
    env, jenv = make(env_id), minigrid_tpu.make(env_id)
    assert dataclasses.asdict(env.config) == dataclasses.asdict(jenv.config)
    assert env.transition == env.config.family
    fref.assert_port_matches(env_id, fref.states(env_id))


@pytest.mark.slow
@pytest.mark.parametrize("env_id", HOOKED_IDS)
def test_generator_reference_file_matches_jax(env_id):
    fref.assert_port_matches(env_id, fref.jax_states(env_id))


def test_mission_templates_keep_the_jax_ids():
    assert fetch.MISSIONS == [jmissions._TEMPLATES.index(t) for t in (
        "get a {c0} {t1}", "go get a {c0} {t1}", "fetch a {c0} {t1}", "go fetch a {c0} {t1}",
        "you must fetch a {c0} {t1}")]
    from minigrid_tpu_torch.envs import gotodoor, gotoobject, putnear, redbluedoors

    for mod, jmod in ((gotodoor, "gotodoor"), (gotoobject, "gotoobject"), (putnear, "putnear"),
                      (redbluedoors, "redbluedoors")):
        assert mod.MISSION == getattr(__import__(f"minigrid_tpu.envs.{jmod}", fromlist=["MISSION"]), "MISSION")


def _actions(seed, t=T, b=B):
    return np.random.default_rng(seed).integers(0, 7, (t, b)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_step(env_id, t, mode, chunk, max_steps, seed):
    env = minigrid_tpu.make(env_id)
    if max_steps is not None:
        env = dataclasses.replace(env, config=dataclasses.replace(env.config, max_steps=max_steps))
    return jax.jit(jfr.build_packed_xla_rollout(env, t, mode=mode, regen_chunk=chunk, as_carry=True,
                                                actions_override=_actions(seed, t)))


def _two_calls(env, carry, t, mode, chunk, seed, max_steps=None, transition=None):
    """The port's plain path and the JAX package's from one carry: two calls
    each, compared; returns the port's metrics."""
    jstep = _jax_step(env.env_id, t, mode, chunk, max_steps, seed)
    if transition is not None:
        env = dataclasses.replace(env, transition=transition)
    step = tfr.build_packed_plain_rollout(env, t, mode=mode, regen_chunk=chunk, as_carry=True,
                                          actions_override=_actions(seed, t))
    jc = jfr.PackedCarry(**{k: jnp.asarray(v) for k, v in carry_to_numpy(carry).items()})
    out = []
    for i in range(2):
        carry, m = step(None, carry)
        if transition is None:
            jc, jm = jstep(jax.random.PRNGKey(0), jc)
            for name, got in carry_to_numpy(carry).items():
                np.testing.assert_array_equal(got, np.asarray(getattr(jc, name)), err_msg=f"call {i} {name}")
            for name in ("episodes", "obs_checksum", "reset_overlaps"):
                assert getattr(m, name).dtype == torch.int32, name
                assert int(getattr(m, name)) == int(getattr(jm, name)), (i, name)
            np.testing.assert_allclose(float(m.total_reward), float(jm.total_reward), rtol=1e-6)
        out.append(m)
    return out


def assert_step_outputs(got, want):
    """`step_core`'s outputs against `_step_core`'s: every integer byte for
    byte, the per-step reward to rtol 1e-6 (XLA:CPU folds `0.9 /
    max_steps` into one constant, so a success can differ in its last
    bit; ROADMAP.md §C)."""
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype == torch.float32:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0, err_msg=f"output {i}")
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"output {i}")


def _outcome(metrics):
    return [(int(m.episodes), round(float(m.total_reward), 4)) for m in metrics]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_hook_matches_jax_packed_xla_rollout(family):
    env = make(SMALL[family])
    cfg = env.config
    case = hooked_packed_case(3, family, cfg.width, cfg.height, B, cfg.max_steps)
    carry = tfr.PackedCarry(*(torch.from_numpy(case[k]) for k in ("words", "regs", "tmpl_words", "tmpl_regs")),
                            rng=split(key(1, device="cpu"), B))
    got = _two_calls(env, carry, T, "cached", 4, 0)
    base = _two_calls(env, carry, T, "cached", 4, 0, transition="base")
    assert _outcome(got) != _outcome(base)  # the hook fired
    assert sum(float(m.total_reward) for m in got) > 0
    states, _ = env.reset_batch(key(9, device="cpu"), B)
    _two_calls(env, tfr.packed_init(env, states, "cached"), T, "cached", 4, 0)


@pytest.mark.parametrize("chunk", [4, 8])
def test_fetch_regen_matches_jax_at_two_chunks(chunk):
    env = make(SMALL["fetch"])
    env = dataclasses.replace(env, config=dataclasses.replace(env.config, max_steps=5))
    carry = tfr.packed_init(env, env.reset_batch(key(5, device="cpu"), B)[0], "regen")
    got = _two_calls(env, carry, 16, "regen", chunk, 1, max_steps=5)
    assert sum(int(m.episodes) for m in got) > 0
    assert sum(int(m.reset_overlaps) for m in got) > 0


@pytest.mark.parametrize("transition", sorted(tph.HOOKS))
def test_each_hook_matches_jax_on_the_same_values(transition):
    """A post-hook of the port and its JAX counterpart on the same random
    lane vectors (the action from -1 to 7, positions near the aux cells,
    door words read back): `(reward, terminated)` equal."""
    from minigrid_tpu.ops import packed_hooks as jph

    jhook = {"pickup_target": jph._hook_pickup_target, "fetch": jph._hook_fetch, "gotodoor": jph._hook_gotodoor,
             "gotoobject": jph._hook_gotoobject, "putnear": jph._hook_putnear, "memory": jph._hook_memory,
             "unlock": jph._hook_unlock, "redbluedoors": jph._hook_redbluedoors,
             "dynamicobstacles": jph._hook_dynamicobstacles}[transition]
    rng = np.random.default_rng(len(transition))
    b = 512
    ints = {k: rng.integers(0, 4, (1, b)).astype(np.int32) for k in ("x", "y", "x1", "y1", "fwd_x", "fwd_y")}
    ints.update(ct=rng.integers(0, 8, (1, b)).astype(np.int32), cc=rng.integers(0, 3, (1, b)).astype(np.int32),
                ct1=rng.integers(0, 8, (1, b)).astype(np.int32), cc1=rng.integers(0, 3, (1, b)).astype(np.int32),
                a=rng.integers(-1, 8, (1, b)).astype(np.int32))
    aux = np.concatenate([rng.integers(0, 4, (4, b)), rng.integers(0, 8, (20, b))]).astype(np.int32)
    door = (C.DOOR | (rng.integers(0, 3, (16, b)) << 8)).astype(np.int32)  # a door word per cell of a 4x4 grid
    door_post = np.where(rng.random((16, b)) < 0.5, door ^ (1 << 8), door).astype(np.int32)
    reward = np.where(rng.random((1, b)) < 0.2, 0.5, 0.0).astype(np.float32)
    terminated = rng.random((1, b)) < 0.1
    success = np.full((1, b), 0.75, np.float32)
    stash = rng.random((1, b)) < 0.5

    def torch_reader(grid):
        return lambda ax, ay: torch.take_along_dim(torch.from_numpy(grid), ((ay * 4 + ax) % 16).long(), dim=0)

    def jax_reader(grid):
        return lambda ax, ay: jnp.take_along_axis(jnp.asarray(grid), (ay * 4 + ax) % 16, axis=0)

    got = tph.HOOKS[transition](tph.HookVals(
        **{k: torch.from_numpy(v) for k, v in ints.items()}, reward=torch.from_numpy(reward),
        terminated=torch.from_numpy(terminated), success=torch.from_numpy(success), aux=torch.from_numpy(aux),
        read_pre=torch_reader(door), read_post=torch_reader(door_post), stash=torch.from_numpy(stash)))
    want = jax.jit(lambda: jhook(jph.HookVals(
        **{k: jnp.asarray(v) for k, v in ints.items()}, reward=jnp.asarray(reward), terminated=jnp.asarray(terminated),
        success=jnp.asarray(success), aux=jnp.asarray(aux), read_pre=jax_reader(door), read_post=jax_reader(door_post),
        stash=jnp.asarray(stash))))()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0].numpy() != reward).any() or (got[1].numpy() != terminated).any()
