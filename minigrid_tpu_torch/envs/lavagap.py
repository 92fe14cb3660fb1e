"""Lava gap (counterpart of `minigrid_tpu/envs/lavagap.py`).

One obstacle column at a random `gap_x` in `[2, width-2)` spans rows
`1..height-2` with a single gap at a random row in `[1, height-1)`; the
agent starts at `(1, 1)` facing right, the goal is at `(width-2,
height-2)`. The obstacle is lava, or a wall where `obstacle_type` is
"wall". The base transition.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core import prng
from minigrid_tpu_torch.core.state import EnvConfig, EnvState, empty_state
from minigrid_tpu_torch.envs import missions
from minigrid_tpu_torch.envs.empty import placed

MISSION_LAVA = missions.register_template("avoid the lava and get to the green goal square")
MISSION_WALL = missions.register_template("find the opening and get to the green goal square")
LAVA_CELL = (C.LAVA, C.RED, 0, 0, 0)


def obstacle(config: EnvConfig):
    """The obstacle cell and mission id of a LavaGap or Crossing config."""
    return (G.WALL_CELL, MISSION_WALL) if config.obstacle_type == "wall" else (LAVA_CELL, MISSION_LAVA)


def fixed_agent(state: EnvState, grid: torch.Tensor, mission: int) -> EnvState:
    """The agent at `(1, 1)` heading right, on every lane."""
    b, dev = grid.shape[0], grid.device
    ones = torch.ones(b, dtype=torch.int32, device=dev)
    return placed(state, grid, ones, ones, torch.zeros_like(ones), missions.encode(mission))


def generate(keys: torch.Tensor, config: EnvConfig) -> EnvState:
    """One state per row of the `(B, 2)` key tensor."""
    key, k_reset = prng.split(keys, 2).unbind(1)
    state = empty_state(config, rng=k_reset)
    w, h = config.width, config.height
    grid = G.wall_rect(state.grid, 0, 0, w, h)
    grid = G.set_cell(grid, w - 2, h - 2, (C.GOAL, C.GREEN, 0, 0, 0))

    k_x, k_y = prng.split(key, 2).unbind(1)
    gap_x = prng.randint(k_x, 2, w - 2)
    gap_y = prng.randint(k_y, 1, h - 1)
    cell, mission = obstacle(config)
    grid = G.paint_rect(grid, gap_x, 1, gap_x + 1, h - 1, cell)
    grid = G.set_cell(grid, gap_x, gap_y, G.EMPTY_CELL)
    return fixed_agent(state, grid, mission)
