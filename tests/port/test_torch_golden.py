"""The golden trajectories (`tests/golden/*.npz`, written by
`tests/make_golden.py`) replayed through the port's `Env.step` and
`observe`, and the wrapper fixtures through the port's wrappers, render
and `FlatObsWrapper`. This file imports no JAX.

The start state is the port's exact replayer of the reference's layout
(`compat/exact.py::CompatEnv`, checked against the fixture's grid and
pose) and `state_to_device`. DynamicObstacles steps through
`compat/exact.py::dynobst_step`: the reference's MT19937 obstacle walk on
the host, continuing the layout's stream, then the port's deterministic
tail. Every observation image and flag must match byte for byte, every
reward to rtol 1e-6.
"""

import glob
import os

import numpy as np
import pytest
import torch

from minigrid_tpu_torch import make
from minigrid_tpu_torch.compat.exact import CompatEnv, dynobst_step, state_to_device

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "golden")
FIXTURES = sorted(
    f for f in glob.glob(os.path.join(GOLDEN_DIR, "*.npz")) if not os.path.basename(f).startswith("wrappers_")
)
WRAPPER_FIXTURES = sorted(glob.glob(os.path.join(GOLDEN_DIR, "wrappers_*.npz")))
CPU = torch.device("cpu")


def _parse(path):
    env_id, seed = os.path.basename(path)[: -len(".npz")].rsplit("_s", 1)
    return env_id, int(seed)


def test_every_family_but_dynamic_obstacles_has_fixtures():
    """Every family has fixtures, DynamicObstacles included: 21 families."""
    families = {make(_parse(f)[0]).config.family for f in FIXTURES}
    assert len(FIXTURES) >= 63 and len(families) == 21, sorted(families)
    assert len(WRAPPER_FIXTURES) == 3


@pytest.mark.parametrize("fixture", FIXTURES, ids=[os.path.basename(f) for f in FIXTURES])
def test_golden_trajectory_replays_through_the_port(fixture):
    env_id, seed = _parse(fixture)
    data = np.load(fixture)
    env = make(env_id)
    ce = CompatEnv(env_id, seed=seed)
    layout = ce.reset()
    np.testing.assert_array_equal(layout["grid"], data["grid"])
    np.testing.assert_array_equal(layout["agent_pos"], data["agent_pos"])
    assert int(layout["agent_dir"]) == int(data["agent_dir"])
    state = state_to_device(layout, env.config, device=CPU)
    np.testing.assert_array_equal(env.observe(state, env.config)["image"][0].numpy(), data["images"][0])
    is_dynobst = env.config.family == "dynamicobstacles"
    for t, a in enumerate(data["actions"]):
        if is_dynobst:
            state, obs, r, te, tr = dynobst_step(ce, env, state, int(a))
        else:
            state, obs, r, te, tr = env.step(state, torch.tensor([int(a)], dtype=torch.int32))
        np.testing.assert_array_equal(obs["image"][0].numpy(), data["images"][t + 1], err_msg=f"{env_id} step {t}")
        np.testing.assert_allclose(float(r[0]), float(data["rewards"][t]), rtol=1e-6, atol=0, err_msg=f"step {t}")
        assert bool(te[0]) == bool(data["terminated"][t]) and bool(tr[0]) == bool(data["truncated"][t]), t


@pytest.mark.parametrize("fixture", WRAPPER_FIXTURES, ids=[os.path.basename(f) for f in WRAPPER_FIXTURES])
def test_wrapper_golden_through_the_port(fixture):
    """Full obs, one-hot, `render_state` at tile 8 without highlight and
    `render_obs_image` of the last observation, byte for byte; the flat
    vector through `FlatObsWrapper` over the adapter, seeded through its
    own reset."""
    from minigrid_tpu_torch.compat.gym_env import gym_make
    from minigrid_tpu_torch.compat.host_wrappers import FlatObsWrapper
    from minigrid_tpu_torch.render.render import render_obs_image, render_state
    from minigrid_tpu_torch.wrappers import full_obs, one_hot_partial_obs

    env_id, seed = _parse(fixture)
    env_id = env_id[len("wrappers_"):]
    data = np.load(fixture)
    env = make(env_id)
    state = state_to_device(CompatEnv(env_id, seed=seed).reset(), env.config, device=CPU)
    for a in data["actions"]:
        state, obs, *_ = env.step(state, torch.tensor([int(a)], dtype=torch.int32))
    np.testing.assert_array_equal(full_obs(env).observe(state, env.config)["image"][0].numpy(), data["fullobs_image"])
    np.testing.assert_array_equal(one_hot_partial_obs(env).observe(state, env.config)["image"][0].numpy(),
                                  data["onehot_image"])
    np.testing.assert_array_equal(render_state(state, env.config, tile_size=8, highlight=False)[0].numpy(),
                                  data["rgb_full"])
    np.testing.assert_array_equal(render_obs_image(obs["image"], tile_size=8)[0].numpy(), data["rgb_partial"])

    genv = FlatObsWrapper(gym_make(env_id, device=CPU))
    fobs, _ = genv.reset(seed=seed)
    for a in data["actions"]:
        fobs, *_ = genv.step(int(a))
    np.testing.assert_array_equal(np.asarray(fobs, np.float32), data["flat_vec"])
