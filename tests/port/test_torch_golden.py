"""The golden trajectories (`tests/golden/*.npz`, written by
`tests/make_golden.py`) replayed through the port's `Env.step` and
`observe`.

The start state is the JAX package's: its exact replayer of the
reference's layout (`compat.exact.CompatEnv`) and `state_to_device`,
carried across as numpy arrays (`utils/convert.py`). Every observation
image and flag must match byte for byte, every reward to rtol 1e-6.

The DynamicObstacles fixtures are left out: their obstacle walk replays
the reference's MT19937 stream on the host (`compat/exact.py`), which
the port has not taken over (ROADMAP.md, A7); its own counter-based walk
is held against the JAX package's in `test_torch_engine.py`.
"""

import glob
import os

import numpy as np
import pytest
import torch

from minigrid_tpu_torch import make
from minigrid_tpu_torch.utils.convert import state_from_numpy

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "golden")
FIXTURES = sorted(
    f for f in glob.glob(os.path.join(GOLDEN_DIR, "*.npz"))
    if not os.path.basename(f).startswith(("wrappers_", "MiniGrid-Dynamic-Obstacles"))
)


def _parse(path):
    env_id, seed = os.path.basename(path)[: -len(".npz")].rsplit("_s", 1)
    return env_id, int(seed)


def test_every_family_but_dynamic_obstacles_has_fixtures():
    families = {make(_parse(f)[0]).config.family for f in FIXTURES}
    assert len(FIXTURES) >= 60 and len(families) == 20, sorted(families)


@pytest.mark.parametrize("fixture", FIXTURES, ids=[os.path.basename(f) for f in FIXTURES])
def test_golden_trajectory_replays_through_the_port(fixture):
    from minigrid_tpu.compat.exact import CompatEnv, state_to_device

    env_id, seed = _parse(fixture)
    data = np.load(fixture)
    env = make(env_id)
    jstate = state_to_device(CompatEnv(env_id, seed=seed).reset(), env.config)
    state = state_from_numpy({k: np.asarray(getattr(jstate, k))[None] for k in (
        "grid", "agent_pos", "agent_dir", "carrying", "step_count", "rng", "mission", "aux")}, device="cpu")
    np.testing.assert_array_equal(env.observe(state, env.config)["image"][0].numpy(), data["images"][0])
    for t, a in enumerate(data["actions"]):
        state, obs, r, te, tr = env.step(state, torch.tensor([int(a)], dtype=torch.int32))
        np.testing.assert_array_equal(obs["image"][0].numpy(), data["images"][t + 1], err_msg=f"{env_id} step {t}")
        np.testing.assert_allclose(float(r[0]), float(data["rewards"][t]), rtol=1e-6, atol=0, err_msg=f"step {t}")
        assert bool(te[0]) == bool(data["terminated"][t]) and bool(tr[0]) == bool(data["truncated"][t]), t
