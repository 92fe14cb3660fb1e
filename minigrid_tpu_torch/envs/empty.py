"""Empty room (counterpart of `minigrid_tpu/envs/empty.py`).

A walled rectangle with the goal at `(width-2, height-2)` and the agent
at its fixed start. Only the fixed-start variants are ported: the
`-Random-` ones need `core/sampling.py`.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core import prng
from minigrid_tpu_torch.core.state import EnvConfig, EnvState, empty_state
from minigrid_tpu_torch.envs import missions

MISSION = missions.register_template("get to the green goal square")

FAMILY = "empty"


def generate(keys: torch.Tensor, config: EnvConfig) -> EnvState:
    """One state per row of the `(B, 2)` key tensor."""
    if config.agent_start_pos is None:
        raise NotImplementedError(
            "random agent placement (Empty-Random) is not ported yet; see ROADMAP.md"
        )
    state = empty_state(config, rng=prng.split(keys, 2)[:, 1])
    w, h = config.width, config.height
    grid = G.wall_rect(state.grid, 0, 0, w, h)
    grid = G.set_cell(grid, w - 2, h - 2, (C.GOAL, C.GREEN, 0, 0, 0))
    return fixed_start(state, grid, config, MISSION)


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
