"""The port's compat layer (`compat/`), its name tables and missions
against the JAX package's, on the CPU.

  * `seeding.np_random`: the same MT19937 stream for the same seed.
  * `CompatEnv.reset()` on all 70 ids at two seeds, twice each (the
    stream continues across resets): every leaf and the mission string
    equal to the JAX package's (NumPy on both sides).
  * The gymnasium adapter on the same seeds and scripted actions: the
    reset and step 5-tuples, `OldGymShim`'s 4-tuple, `hash`, `str`, the
    pose and view-compat members; spaces, `reward_range` and spec fields
    on all 70 ids.
  * The ten host wrappers over both adapters.
  * `gymnasium.make` under the port's namespace in a process that also
    imported the JAX package (which registers the bare ids).
  * The constants, `detokenize` and the top-level exports.
"""

import functools

import gymnasium
import numpy as np
import pytest
import torch

import minigrid_tpu_torch
from minigrid_tpu_torch.compat import exact, seeding
from minigrid_tpu_torch.compat.gym_env import MiniGridGymEnv, gym_id, gym_make, register_all_gymnasium
from minigrid_tpu_torch.core.prng import key
from minigrid_tpu_torch.envs import missions

CPU = torch.device("cpu")
SCRIPT = (2, 1, 2, 2, 0, 3, 5, 2, 2, 1, 2, 4, 2)


@pytest.mark.parametrize("seed", [0, 1, 1337, 2**40 + 3])
def test_np_random_draws_match_jax(seed):
    from minigrid_tpu.compat import seeding as jseeding

    (rng, s), (jrng, js) = seeding.np_random(seed), jseeding.np_random(seed)
    assert s == js and seeding.hash_seed(seed) == jseeding.hash_seed(seed)
    np.testing.assert_array_equal(rng.randint(0, 1000, 64), jrng.randint(0, 1000, 64))
    np.testing.assert_array_equal(rng.uniform(size=8), jrng.uniform(size=8))


@pytest.mark.parametrize("env_id", list(minigrid_tpu_torch.env_list))
def test_compat_reset_matches_jax(env_id):
    from minigrid_tpu.compat.exact import CompatEnv as JCompatEnv

    for seed in (7, 1337):
        ce, jce = exact.CompatEnv(env_id, seed=seed), JCompatEnv(env_id, seed=seed)
        for _ in range(2):
            got, want = ce.reset(), jce.reset()
            assert got.keys() == want.keys()
            for k in got:
                if k == "mission":
                    assert got[k] == want[k], (env_id, seed)
                else:
                    np.testing.assert_array_equal(got[k], want[k], err_msg=f"{env_id} {seed} {k}")
                    assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


def test_state_to_device_matches_jax():
    from minigrid_tpu.compat.exact import state_to_device as jstate_to_device

    env = minigrid_tpu_torch.make("MiniGrid-KeyCorridorS3R1-v0")
    layout = exact.CompatEnv(env.env_id, seed=3).reset()
    got = exact.state_to_device(layout, env.config, device=CPU)
    want = jstate_to_device(layout, None)
    for name in ("grid", "agent_pos", "agent_dir", "carrying", "step_count", "rng", "mission", "aux"):
        np.testing.assert_array_equal(getattr(got, name)[0].numpy(), np.asarray(getattr(want, name)), err_msg=name)
    keyed = exact.state_to_device(layout, env.config, key=key(9, device=CPU))
    assert keyed.rng.device == CPU and keyed.rng[0].tolist() == [0, 9]
    # The JAX package ignores `config`; the port holds the layout to it.
    with pytest.raises(ValueError, match="layout is not"):
        exact.state_to_device(layout, minigrid_tpu_torch.make("MiniGrid-Empty-5x5-v0").config, device=CPU)


def _pose(env):
    """Every pose and view-compat member of an adapter, as plain values."""
    w, h = env.width, env.height
    cells = [(x, y) for x in range(-1, w + 1, 2) for y in range(-1, h + 1, 2)]
    return dict(
        agent_pos=tuple(int(v) for v in env.agent_pos), agent_dir=env.agent_dir,
        dir_vec=tuple(int(v) for v in env.dir_vec), right_vec=tuple(int(v) for v in env.right_vec),
        front_pos=tuple(int(v) for v in env.front_pos), carrying=env.carrying, mission=env.mission,
        step_count=env.step_count, steps_remaining=env.steps_remaining, max_steps=env.max_steps,
        size=(w, h, env.agent_view_size, env.see_through_walls), exts=env.get_view_exts(),
        coords=[env.get_view_coords(x, y) for x, y in cells], rel=[env.relative_coords(x, y) for x, y in cells],
        in_view=[env.in_view(x, y) for x, y in cells],
    )


def _same_obs(got, want):
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["image"], want["image"])
    assert got["image"].dtype == want["image"].dtype
    assert got["direction"] == want["direction"] and got["mission"] == want["mission"]


@functools.lru_cache(maxsize=None)
def _bases():
    """One port and one JAX adapter of `ADAPTER_ID`, which every adapter
    and wrapper test here drives (each from a seeded reset): the JAX
    adapter's reset and step then compile once."""
    from minigrid_tpu.compat import gym_make as jgym_make

    return gym_make(ADAPTER_ID, device=CPU), jgym_make(ADAPTER_ID)


ADAPTER_ID = "MiniGrid-DoorKey-5x5-v0"


def test_adapter_matches_jax():
    """reset/step 5-tuples, hash and str after every step, and the pose and
    view members at the start and the end, on a scripted path."""
    env, jenv = _bases()
    env.render_mode = jenv.render_mode = None
    (obs, info), (jobs, jinfo) = env.reset(seed=7), jenv.reset(seed=7)
    _same_obs(obs, jobs)
    assert info == jinfo == {} and env.hash() == jenv.hash() and str(env) == str(jenv)
    assert _pose(env) == _pose(jenv)
    for a in SCRIPT:
        out, jout = env.step(a), jenv.step(a)
        _same_obs(out[0], jout[0])
        assert out[1:] == jout[1:] and all(type(x) is type(y) for x, y in zip(out[1:], jout[1:])), a
        assert env.hash() == jenv.hash() and env.hash(8) == jenv.hash(8) and str(env) == str(jenv)
    assert _pose(env) == _pose(jenv)
    # `agent_sees` is `core/view.py::agent_sees` on the lane, held against
    # the JAX package's in `test_torch_engine.py`.
    fx, fy = env.front_pos
    assert isinstance(env.agent_sees(int(fx), int(fy)), bool)
    frame = env.render(tile_size=8)
    assert frame.shape == (5 * 8, 5 * 8, 3) and frame.dtype == np.uint8
    np.testing.assert_array_equal(env.get_obs_render(obs["image"], 8).shape, (56, 56, 3))
    env.render_mode = jenv.render_mode = "ansi"
    assert env.render() == jenv.render()
    env.render_mode = jenv.render_mode = None
    # A reset without a seed takes the next one.
    np.testing.assert_array_equal(env.reset()[0]["image"], jenv.reset()[0]["image"])


def test_old_gym_shim_matches_jax():
    from minigrid_tpu.compat.gym_env import OldGymShim as JOldGymShim

    from minigrid_tpu_torch.compat.gym_env import OldGymShim

    base, jbase = _bases()
    env, jenv = OldGymShim(base), JOldGymShim(jbase)
    assert env.seed(11) == jenv.seed(11) == [11]
    _same_obs(env.reset(), jenv.reset())
    for a in SCRIPT:
        out, jout = env.step(a), jenv.step(a)
        assert len(out) == 4 and out[1:] == jout[1:]
        _same_obs(out[0], jout[0])
    assert env.agent_pos == jenv.agent_pos and env.width == 5  # attributes pass through


def test_spaces_reward_range_and_spec_match_jax():
    import minigrid_tpu
    from minigrid_tpu.compat.gym_env import MiniGridGymEnv as JGymEnv

    for env_id in minigrid_tpu_torch.env_list:
        env, jenv = MiniGridGymEnv(minigrid_tpu_torch.make(env_id), device=CPU), JGymEnv(minigrid_tpu.make(env_id))
        assert env.action_space == jenv.action_space and env.reward_range == jenv.reward_range, env_id
        assert env.observation_space["image"] == jenv.observation_space["image"]
        assert env.observation_space == jenv.observation_space and env.metadata == jenv.metadata
        assert env.spec.id == gym_id(jenv.spec.id) and env.spec.kwargs == jenv.spec.kwargs
        for field in ("max_episode_steps", "reward_threshold", "disable_env_checker"):
            assert getattr(env.spec, field) == getattr(jenv.spec, field), (env_id, field)
    assert MiniGridGymEnv(minigrid_tpu_torch.make("MiniGrid-Empty-5x5-v0"), device=CPU).spec.max_episode_steps == 100


@functools.lru_cache(maxsize=None)
def _wrapper_pairs():
    from minigrid_tpu import compat as jc

    from minigrid_tpu_torch import compat as tc

    base, jbase = _bases()

    def pair(name, **kw):
        return getattr(tc, name)(base, **kw), getattr(jc, name)(jbase, **kw)

    return [pair("ReseedWrapper", seeds=(3, 5)), pair("ActionBonus"), pair("StateBonus"), pair("ImgObsWrapper"),
            pair("OneHotPartialObsWrapper"), pair("RGBImgObsWrapper", tile_size=8),
            pair("RGBImgPartialObsWrapper", tile_size=8), pair("FullyObsWrapper"), pair("FlatObsWrapper"),
            pair("ViewSizeWrapper", agent_view_size=5)]


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.asarray(b).dtype
    else:
        assert a == b


@pytest.mark.parametrize("index", range(10))
def test_host_wrapper_matches_jax(index):
    """Each wrapper over the two adapters: spaces, then resets and a
    scripted path, every observation and reward equal."""
    env, jenv = _wrapper_pairs()[index]
    env.unwrapped.render_mode = jenv.unwrapped.render_mode = None
    assert type(env).__name__ == type(jenv).__name__
    assert env.observation_space == jenv.observation_space
    for seed in (1, 2):
        (obs, _), (jobs, _) = env.reset(seed=seed), jenv.reset(seed=seed)
        _same(obs, jobs)
        for a in SCRIPT[:6]:
            out, jout = env.step(a), jenv.step(a)
            _same(out[0], jout[0])
            assert out[1:4] == jout[1:4], (type(env).__name__, a)


def test_gymnasium_make_under_the_namespace_beside_the_jax_package():
    """`import minigrid_tpu` registers the bare ids; the port's go under
    `minigrid_tpu_torch/`, and both resolve in one process."""
    import minigrid_tpu  # noqa: F401
    from minigrid_tpu.compat.gym_env import MiniGridGymEnv as JGymEnv

    register_all_gymnasium()
    register_all_gymnasium()  # idempotent
    ids = [gym_id(e) for e in minigrid_tpu_torch.env_list]
    assert len(ids) == 70 and all(i in gymnasium.registry for i in ids)
    assert all(e in gymnasium.registry for e in minigrid_tpu_torch.env_list)
    env = gymnasium.make(gym_id("MiniGrid-Empty-5x5-v0"), device="cpu")
    assert isinstance(env.unwrapped, MiniGridGymEnv) and env.unwrapped.spec.id == gym_id("MiniGrid-Empty-5x5-v0")
    obs, _ = env.reset(seed=7)
    assert obs["image"].shape == (7, 7, 3) and obs["mission"] == "get to the green goal square"
    assert env.step(2)[1] <= 1.0
    assert isinstance(gymnasium.make("MiniGrid-Empty-5x5-v0").unwrapped, JGymEnv)


def test_constants_missions_and_exports_match_jax():
    import minigrid_tpu
    from minigrid_tpu.core import constants as JC
    from minigrid_tpu.envs import missions as jmissions

    from minigrid_tpu_torch.core import constants as C

    for name in ("TILE_PIXELS", "OBJECT_TO_IDX", "IDX_TO_OBJECT", "IDX_TO_COLOR", "STATE_TO_IDX", "IDX_TO_STATE",
                 "COLOR_TO_IDX", "COLOR_NAMES"):
        assert getattr(C, name) == getattr(JC, name), name
    assert C.COLORS.keys() == JC.COLORS.keys()
    for k in C.COLORS:
        np.testing.assert_array_equal(C.COLORS[k], JC.COLORS[k])
        assert C.COLORS[k].dtype == JC.COLORS[k].dtype
    np.testing.assert_array_equal(C.COLOR_PALETTE, JC.COLOR_PALETTE)
    assert C.COLOR_PALETTE.dtype == JC.COLOR_PALETTE.dtype
    assert list(missions.TEMPLATES) == jmissions._TEMPLATES
    rng = np.random.default_rng(3)
    for tid in range(len(missions.TEMPLATES)):
        for _ in range(4):
            vec = missions.encode(tid, *rng.integers(0, 12, size=7))
            assert missions.detokenize(vec) == jmissions.detokenize(vec)
            assert missions.detokenize(torch.from_numpy(vec)) == jmissions.detokenize(vec)
    assert minigrid_tpu_torch.__all__ == minigrid_tpu.__all__
    for name in minigrid_tpu.__all__:
        assert hasattr(minigrid_tpu_torch, name), name
    assert minigrid_tpu_torch.env_list == minigrid_tpu.env_list
    assert minigrid_tpu_torch.registry.keys() == minigrid_tpu.registry.keys()
    assert minigrid_tpu_torch.EnvState.__name__ == "EnvState" and callable(minigrid_tpu_torch.register)
