"""Empty room (counterpart of `minigrid_tpu/envs/empty.py`).

A walled rectangle with the goal at `(width-2, height-2)`. The agent
starts at its fixed start, or for the `-Random-` variants
(`agent_start_pos=None`) on a uniform free cell with a uniform heading.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core import prng, sampling
from minigrid_tpu_torch.core.state import EnvConfig, EnvState, empty_state
from minigrid_tpu_torch.envs import missions

MISSION = missions.register_template("get to the green goal square")

FAMILY = "empty"


def generate(keys: torch.Tensor, config: EnvConfig) -> EnvState:
    """One state per row of the `(B, 2)` key tensor."""
    ks = prng.split(keys, 2)  # key, k_reset
    state = empty_state(config, rng=ks[:, 1])
    w, h = config.width, config.height
    grid = G.wall_rect(state.grid, 0, 0, w, h)
    grid = G.set_cell(grid, w - 2, h - 2, (C.GOAL, C.GREEN, 0, 0, 0))
    if config.agent_start_pos is not None:
        return fixed_start(state, grid, config, MISSION)
    k_pos, k_dir = prng.split(ks[:, 0], 2).unbind(1)
    x, y = sampling.sample_cell(k_pos, sampling.free_cell_mask(grid))
    return placed(state, grid, x, y, sampling.sample_direction(k_dir), missions.encode(MISSION))


def placed(state: EnvState, grid: torch.Tensor, x, y, agent_dir, mission) -> EnvState:
    """The state with its grid, the agent at `(x, y)` heading `agent_dir`
    (`(B,)` int32 each) and `mission` (a `(MISSION_LEN,)` vector, or
    `(B, MISSION_LEN)`)."""
    b = grid.shape[0]
    mission = torch.as_tensor(mission, dtype=torch.int32, device=grid.device).expand(b, -1).clone()
    return state.replace(grid=grid, agent_pos=torch.stack([x, y], dim=1), agent_dir=agent_dir, mission=mission)


def fixed_start(state: EnvState, grid: torch.Tensor, config: EnvConfig, mission: int):
    """The fixed agent start and mission of the static-layout families."""
    b, dev = grid.shape[0], grid.device
    i32 = dict(dtype=torch.int32, device=dev)
    return state.replace(
        grid=grid,
        agent_pos=torch.tensor(config.agent_start_pos, **i32).expand(b, 2).clone(),
        agent_dir=torch.full((b,), config.agent_start_dir or 0, **i32),
        mission=torch.as_tensor(missions.encode(mission), device=dev).expand(b, -1).clone(),
    )
