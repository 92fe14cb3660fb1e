"""The per-env engine against the JAX package's, on the CPU.

  * `gen_obs` on `testing.py`'s random states (every object, door state and
    carried object; occlusion on and off) and on each family's generated
    states (`data/family_generators_b32.npz`): image, direction, mission;
    the JAX side on states padded to one canvas, so that its two compiles
    serve every size. `core/view.py`, `core/grid.py` and `process_vis`.
  * `base_step` and the nine family transitions (`envs/base.py::STEP_FNS`),
    16 steps of random actions on `testing.py`'s states with each hook's
    events planted: every state field byte for byte, the reward to rtol 1e-6 (XLA folds `0.9 / max_steps` into one
    constant; the port evaluates the reward one f32 operation at a time).
    Step counts start at least 16 below `max_steps`, so every step stays
    inside its episode (the last one truncates): a reward past
    `max_steps` falls below 0.1, where that one rounding step of the
    subtraction's operand exceeds rtol 1e-6.
  * `make_autoreset_step` in both modes, and `build_rollout` (regen and
    cached) on a static and a random-layout family, against the JAX
    package's under the same key: metrics, final states and, collected,
    the trajectory.
  * `MixedEnv` and `build_mixed_rollout` on BASELINE.md's config-5 pair
    against `data/mixed_reference.npz` (`make_mixed_reference.py`).
"""

import dataclasses
import functools

import make_family_reference as fref
import make_mixed_reference as mx
import numpy as np
import pytest
import torch

from minigrid_tpu_torch import make
from minigrid_tpu_torch.core import prng
from minigrid_tpu_torch.core.autoreset import make_autoreset_step
from minigrid_tpu_torch.core.obs import gen_obs
from minigrid_tpu_torch.core.rollout import build_rollout
from minigrid_tpu_torch.core.state import EnvConfig
from minigrid_tpu_torch.envs.base import step_fn
from minigrid_tpu_torch.ops import fused_rollout as tfr
from minigrid_tpu_torch.parallel import mixed
from minigrid_tpu_torch.testing import hooked_packed_case, random_packed_case
from minigrid_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

CPU = torch.device("cpu")
FIELDS = fref.STATE_FIELDS


def _jax_config(cfg: EnvConfig):
    from minigrid_tpu.core.state import EnvConfig as JConfig

    return JConfig(**dataclasses.asdict(cfg))


def _jax_state(s: dict):
    import jax.numpy as jnp

    from minigrid_tpu.core.state import EnvState as JState

    return JState(**{k: jnp.asarray(s[k]) for k in FIELDS})


def _numpy(jstate) -> dict:
    return {k: np.asarray(getattr(jstate, k)) for k in FIELDS}


def _assert_states(got, want: dict, msg=""):
    got = state_to_numpy(got)
    for name in FIELDS:
        assert got[name].dtype == want[name].dtype, (msg, name)
        np.testing.assert_array_equal(got[name], want[name], err_msg=f"{msg} {name}")


def _assert_obs(got: dict, want: dict, msg=""):
    for name in ("image", "direction", "mission"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=f"{msg} {name}")


@functools.lru_cache(maxsize=None)
def _jax_gen_obs(cfg: EnvConfig):
    import jax

    from minigrid_tpu.core.obs import gen_obs as jgen_obs

    jcfg = _jax_config(cfg)
    return jax.jit(jax.vmap(lambda s: jgen_obs(s, jcfg)))


def _random_states(seed: int, cfg: EnvConfig, b: int, transition=None) -> dict:
    """`testing.py`'s random packed states (with `transition`'s events
    planted), unpacked."""
    if transition is None:
        case = random_packed_case(seed, cfg.width, cfg.height, b, cfg.max_steps)
    else:
        case = hooked_packed_case(seed, transition, cfg.width, cfg.height, b, cfg.max_steps, cfg.n_obstacles or 0)
    words, regs = (torch.from_numpy(case[k]) for k in ("words", "regs"))
    return state_to_numpy(tfr._unpack_rolled(cfg, words, regs))


def _padded(s: dict, cfg: EnvConfig):
    """`s` on a `CANVAS`-square grid of walls (the JAX package's
    out-of-bounds fill, as its `MixedEnv` relies on), and the canvas's
    configuration: one JAX compile for each `see_through_walls` serves
    every size."""
    grid = np.zeros((len(s["grid"]), CANVAS, CANVAS, 5), np.uint8)
    grid[...] = (2, 5, 0, 0, 0)
    grid[:, : cfg.height, : cfg.width] = s["grid"]
    jcfg = EnvConfig(family="empty", width=CANVAS, height=CANVAS, max_steps=1,
                     see_through_walls=cfg.see_through_walls)
    return dict(s, grid=grid), jcfg


# The canvas (the largest grid, MultiRoom's) that `_padded` puts states on.
CANVAS = 25


@pytest.mark.parametrize("see_through_walls", [False, True])
@pytest.mark.parametrize("size", [(5, 5), (8, 8), (9, 7)])
def test_gen_obs_matches_jax_on_random_states(size, see_through_walls):
    """At each size against the JAX package on the padded canvas, and at
    9×7 with occlusion at the size itself (the canvas's premise)."""
    w, h = size
    cfg = EnvConfig(family="empty", width=w, height=h, max_steps=4 * w * h, see_through_walls=see_through_walls)
    s = _random_states(w * h + see_through_walls, cfg, 128)
    got = gen_obs(state_from_numpy(s, device=CPU), cfg)
    padded, jcfg = _padded(s, cfg)
    _assert_obs(got, _jax_gen_obs(jcfg)(_jax_state(padded)))
    if size == (9, 7) and not see_through_walls:
        _assert_obs(got, _jax_gen_obs(cfg)(_jax_state(s)))


def _family_ids():
    """The first id of each family in the generator reference file, and
    one id of each family it lacks (whose states the port's generators
    give: `test_torch_rollout.py`, `test_torch_keycorridor.py` and
    `test_torch_multiroom.py` hold those against the JAX package's)."""
    seen = {}
    for env_id in fref.ALL_IDS:
        seen.setdefault(make(env_id).config.family, env_id)
    return sorted(seen.values()) + list(OTHER_FAMILY_IDS)


OTHER_FAMILY_IDS = ("MiniGrid-Empty-8x8-v0", "MiniGrid-DistShift1-v0", "MiniGrid-KeyCorridorS3R1-v0",
                    "MiniGrid-MultiRoom-N2-S4-v0")


@pytest.mark.parametrize("env_id", _family_ids())
def test_gen_obs_matches_jax_on_generated_states(env_id):
    """The observation of each family's generated states, the agents'
    carried objects drawn at random so that the overlay shows: the port at
    the family's own size, the JAX package on the padded canvas."""
    env = make(env_id)
    cfg = env.config
    if env_id in OTHER_FAMILY_IDS:
        s = state_to_numpy(env.reset_batch(prng.key(21, device=CPU), fref.B)[0])
    else:
        s = dict(fref.states(env_id))
    rng = np.random.default_rng(len(env_id))
    s["carrying"] = np.stack([rng.choice([0, 5, 6, 7], fref.B), rng.integers(0, 6, fref.B),
                              rng.choice([0, 5], fref.B), rng.integers(0, 6, fref.B)], 1).astype(np.uint8)
    padded, jcfg = _padded(s, cfg)
    _assert_obs(gen_obs(state_from_numpy(s, device=CPU), cfg), _jax_gen_obs(jcfg)(_jax_state(padded)))
    assert len(_family_ids()) == 22


@functools.lru_cache(maxsize=None)
def _jax_view_fns(cfg: EnvConfig):
    import jax
    import jax.numpy as jnp

    from minigrid_tpu.core import grid as jg
    from minigrid_tpu.core import view as jv
    from minigrid_tpu.core.vision import process_vis as jvis

    view = cfg.agent_view_size

    def poses(pos, d, x, y):
        return (jv.dir_vec(d), jv.right_vec(d), jv.front_pos(pos, d), jnp.stack(jv.get_view_exts(pos, d, view)),
                jnp.stack(jv.relative_coords(pos, d, view, x, y)[:2]), jv.in_view(pos, d, view, x, y))

    def cells(grid, view_grid):
        return (jg.see_behind_mask(grid), jg.can_overlap_mask(grid), jg.encode(grid), jvis(view_grid))

    def sees(state, x, y):
        return jv.agent_sees(state, _jax_config(cfg), x, y)

    return tuple(jax.jit(jax.vmap(f)) for f in (poses, cells, jg.decode, sees))


def test_view_grid_and_vision_helpers_match_jax():
    """`core/view.py` (headings, the front cell, the view's extents and
    coordinates, `in_view`, `agent_sees`), `core/grid.py` (`get_cell`,
    `is_empty`, `encode`/`decode`, `see_behind_mask`, `can_overlap_mask`)
    and `core/vision.py::process_vis` against the JAX package's, on
    `testing.py`'s random states and random cells."""
    from minigrid_tpu_torch.core import grid as G
    from minigrid_tpu_torch.core import view as V
    from minigrid_tpu_torch.core.obs import gen_obs_grid
    from minigrid_tpu_torch.core.vision import process_vis

    cfg = EnvConfig(family="empty", width=9, height=7, max_steps=252)
    s = _random_states(5, cfg, 128)
    state = state_from_numpy(s, device=CPU)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(-2, 11, 128).astype(np.int32))
    y = torch.from_numpy(rng.integers(-2, 9, 128).astype(np.int32))
    poses, cells, decode, sees = _jax_view_fns(cfg)
    want = poses(s["agent_pos"], s["agent_dir"], x.numpy(), y.numpy())
    got = (V.dir_vec(state.agent_dir), V.right_vec(state.agent_dir), V.front_pos(state.agent_pos, state.agent_dir),
           torch.stack(V.get_view_exts(state.agent_pos, state.agent_dir, 7), 1),
           torch.stack(V.relative_coords(state.agent_pos, state.agent_dir, 7, x, y)[:2], 1),
           V.in_view(state.agent_pos, state.agent_dir, 7, x, y))
    for name, g, w in zip(("dir_vec", "right_vec", "front_pos", "exts", "coords", "in_view"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert bool(got[5].any()) and not bool(got[5].all())

    view_grid, _ = gen_obs_grid(state, cfg)
    want = cells(s["grid"], view_grid.numpy())
    got = (G.see_behind_mask(state.grid), G.can_overlap_mask(state.grid), G.encode(state.grid),
           process_vis(view_grid))
    for name, g, w in zip(("see_behind", "can_overlap", "encode", "process_vis"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    for g, w in zip(G.decode(got[2]), decode(np.asarray(want[2]))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    inside = (x.clamp(0, 8), y.clamp(0, 6))
    cell = G.get_cell(state.grid, *inside)
    np.testing.assert_array_equal(cell.numpy(), s["grid"][np.arange(128), inside[1].numpy(), inside[0].numpy()])
    assert torch.equal(G.is_empty(cell), cell[:, 0] == 1)
    want = sees(_jax_state(s), *(v.numpy() for v in inside))
    np.testing.assert_array_equal(V.agent_sees(state, cfg, *inside).numpy(), np.asarray(want))


# One id per transition, its states `testing.py`'s with the hook's events.
TRANSITION_IDS = {
    "base": "MiniGrid-DoorKey-8x8-v0",
    "pickup_target": "MiniGrid-UnlockPickup-v0",
    "fetch": "MiniGrid-Fetch-8x8-N3-v0",
    "gotodoor": "MiniGrid-GoToDoor-8x8-v0",
    "gotoobject": "MiniGrid-GoToObject-8x8-N2-v0",
    "putnear": "MiniGrid-PutNear-8x8-N3-v0",
    "redbluedoors": "MiniGrid-RedBlueDoors-8x8-v0",
    "memory": "MiniGrid-MemoryS7-v0",
    "unlock": "MiniGrid-Unlock-v0",
    "dynamicobstacles": "MiniGrid-Dynamic-Obstacles-8x8-v0",
}


@functools.lru_cache(maxsize=None)
def _jax_step(env_id):
    """The JAX package's per-env transition of `env_id` (its observation is
    held against `gen_obs` above, and `Env.step`'s by the golden replay)."""
    import jax

    import minigrid_tpu

    jenv = minigrid_tpu.make(env_id)
    return jax.jit(jax.vmap(lambda s, a: tuple(jenv.transition(s, a, jenv.config))))


@pytest.mark.parametrize("transition", sorted(TRANSITION_IDS))
def test_transition_matches_jax_per_env_step(transition):
    env_id = TRANSITION_IDS[transition]
    env = make(env_id)
    assert env.transition == transition
    s = _random_states(len(transition), env.config, 128, None if transition == "base" else transition)
    s["step_count"] = np.minimum(s["step_count"], env.config.max_steps - 16)
    actions = np.random.default_rng(7).integers(0, 7, (16, 128)).astype(np.int32)
    state, jstate = state_from_numpy(s, device=CPU), _jax_state(s)
    jstep, step = _jax_step(env_id), step_fn(transition)
    rewarded = ended = 0
    for t, a in enumerate(actions):
        state, r, te, tr = step(state, torch.from_numpy(a), env.config)
        jstate, jr, jte, jtr = jstep(jstate, a)
        _assert_states(state, _numpy(jstate), f"step {t}")
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-6, atol=0, err_msg=f"step {t}")
        assert te.tolist() == np.asarray(jte).tolist() and tr.tolist() == np.asarray(jtr).tolist(), t
        rewarded += int((r != 0).sum())
        ended += int(te.sum())
    assert ended > 0 and (rewarded > 0 or transition == "base") and bool(tr.any())


def _spread_step_counts(s: dict, cfg: EnvConfig, steps: int, seed: int) -> dict:
    """`s` with step counts within `steps` of `max_steps`, so that lanes
    truncate (and reset) inside a short run."""
    s = dict(s)
    lo = max(0, cfg.max_steps - steps)
    s["step_count"] = np.random.default_rng(seed).integers(lo, cfg.max_steps, len(s["step_count"])).astype(np.int32)
    return s


def _reset_states(env_id: str, seed: int, b: int, steps: int) -> dict:
    env = make(env_id)
    states, obs = env.reset_batch(prng.key(seed, device=CPU), b)
    return _spread_step_counts(state_to_numpy(states), env.config, steps, seed), obs


def test_select_state_matches_jax():
    from minigrid_tpu.core.autoreset import select_state as jselect
    from minigrid_tpu_torch.core.autoreset import select_state

    cfg = EnvConfig(family="empty", width=6, height=5, max_steps=120)
    fresh, old = _random_states(1, cfg, 64), _random_states(2, cfg, 64)
    done = np.random.default_rng(3).random(64) < 0.5
    got = select_state(torch.from_numpy(done), state_from_numpy(fresh, device=CPU), state_from_numpy(old, device=CPU))
    _assert_states(got, _numpy(jselect(done, _jax_state(fresh), _jax_state(old))))


@functools.lru_cache(maxsize=None)
def _jax_autoreset(env_id, mode):
    import jax

    import minigrid_tpu
    from minigrid_tpu.core.autoreset import make_autoreset_step as jmake

    return jax.jit(jax.vmap(jmake(minigrid_tpu.make(env_id), mode=mode)))


@pytest.mark.parametrize("mode", ["regen", "cached"])
def test_make_autoreset_step_matches_jax(mode):
    """Four steps on Empty-Random-5x5 (a random start) whose lanes truncate
    within them: the reset lanes' fresh states (a new layout, or the
    pinned one) and their observations byte for byte."""
    env_id = "MiniGrid-Empty-Random-5x5-v0"
    env = make(env_id)
    s, _ = _reset_states(env_id, 11, 64, 4)
    step, jstep = make_autoreset_step(env, mode), _jax_autoreset(env_id, mode)
    state, jstate = state_from_numpy(s, device=CPU), _jax_state(s)
    actions = np.random.default_rng(3).integers(0, 7, (4, 64)).astype(np.int32)
    for t, a in enumerate(actions):
        state, obs, r, te, tr = step(state, torch.from_numpy(a))
        jstate, jobs, jr, jte, jtr = jstep(jstate, a)
        _assert_states(state, _numpy(jstate), f"step {t}")
        _assert_obs(obs, jobs, f"step {t}")
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-6, atol=0)
        assert te.tolist() == np.asarray(jte).tolist() and tr.tolist() == np.asarray(jtr).tolist()
    assert not np.array_equal(state_to_numpy(state)["step_count"], s["step_count"] + 4)
    with pytest.raises(ValueError, match="autoreset mode"):
        make_autoreset_step(env, "both")


@functools.lru_cache(maxsize=None)
def _jax_rollout(env_id, steps, mode, collect):
    import jax

    import minigrid_tpu
    from minigrid_tpu.core.rollout import build_rollout as jbuild

    return jax.jit(jbuild(minigrid_tpu.make(env_id), steps, collect=collect, autoreset_mode=mode))


@pytest.mark.parametrize("mode", ["regen", "cached"])
@pytest.mark.parametrize("env_id", ["MiniGrid-Empty-5x5-v0", "MiniGrid-Empty-Random-5x5-v0"])
def test_build_rollout_matches_jax(env_id, mode):
    """64 lanes, 40 steps under the same key, through every lane's reset,
    on a static layout and a random start: the metrics (integers equal,
    the reward sum to rtol 1e-5), the final states and, for Empty-5x5 in
    regen mode, the collected trajectory."""
    import jax

    steps, collect = 40, env_id == "MiniGrid-Empty-5x5-v0" and mode == "regen"
    s, obs = _reset_states(env_id, 12, 64, steps)
    out = build_rollout(make(env_id), steps, collect=collect, autoreset_mode=mode)(
        prng.key(13, device=CPU), state_from_numpy(s, device=CPU))
    want = _jax_rollout(env_id, steps, mode, collect)(jax.random.PRNGKey(13), _jax_state(s))
    _assert_states(out[0], _numpy(want[0]))
    m, jm = out[1], want[1]
    for name in ("episodes", "total_steps", "obs_checksum", "reset_overlaps"):
        got = getattr(m, name)
        assert got.dtype == torch.int32 and int(got) == int(getattr(jm, name)), name
    np.testing.assert_allclose(float(m.total_reward), float(jm.total_reward), rtol=1e-5, atol=1e-5)
    assert int(m.episodes) >= 64
    if collect:
        for name in ("obs_image", "action", "done"):
            np.testing.assert_array_equal(getattr(out[2], name).numpy(), np.asarray(getattr(want[2], name)), name)
        np.testing.assert_allclose(out[2].reward.numpy(), np.asarray(want[2].reward), rtol=1e-6, atol=0)


def test_mixed_env_matches_jax():
    """`MixedEnv.reset_batch` (states and observations) and one
    `build_mixed_rollout` call from doctored step counts, against the JAX
    package's, as `make_mixed_reference.py` stored them: integers byte
    for byte, the reward sum to rtol 1e-5."""
    want = mx.case_arrays(mx.MIXED_ENV_CASE)
    menv = mixed.MixedEnv.create(mx.IDS)
    assert (menv.height, menv.width, menv.num_actions) == (19, 19, 7)
    states, obs = menv.reset_batch(prng.key(mx.MIXED_ENV_SEEDS[0], device=CPU), torch.from_numpy(mx.member_ids()))
    _assert_states(states, {k: want[f"{mx.MIXED_ENV_CASE}/reset/{k}"] for k in FIELDS})
    np.testing.assert_array_equal(obs["image"].numpy(), want[f"{mx.MIXED_ENV_CASE}/reset/image"])
    start = mx.doctor_mixed(state_to_numpy(states))
    final, m = mixed.build_mixed_rollout(menv, mx.T)(prng.key(mx.MIXED_ENV_SEEDS[1], device=CPU),
                                                     state_from_numpy(start, device=CPU))
    _assert_states(final, {k: want[f"{mx.MIXED_ENV_CASE}/final/{k}"] for k in FIELDS})
    for name in ("episodes", "total_steps", "obs_checksum"):
        assert int(getattr(m, name)) == int(want[f"{mx.MIXED_ENV_CASE}/metrics/{name}"]), name
    np.testing.assert_allclose(float(m.total_reward), float(want[f"{mx.MIXED_ENV_CASE}/metrics/total_reward"]),
                               rtol=1e-5)
    assert int(m.episodes) > mx.B


@pytest.mark.slow
def test_mixed_env_reference_matches_jax_live():
    pytest.importorskip("jax")
    mref_arrays = mx.jax_mixed_env_case()
    stored = mx.case_arrays(mx.MIXED_ENV_CASE)
    assert sorted(mref_arrays) == sorted(stored)
    for k, v in mref_arrays.items():
        np.testing.assert_array_equal(v, stored[k], err_msg=k)
