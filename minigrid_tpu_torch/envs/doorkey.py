"""Door and key (counterpart of `minigrid_tpu/envs/doorkey.py`).

A vertical wall at a random column `split_x` in `[2, width-2)` divides
the room; a locked yellow door sits in it at a random row, a yellow key
lies left of it, the goal is at `(width-2, height-2)`, and the agent
starts left of the wall. The door row is drawn in `[1, width-2)`, as the
JAX package draws it (the grids are square). The base transition.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core import prng, sampling
from minigrid_tpu_torch.core.state import EnvConfig, EnvState, empty_state
from minigrid_tpu_torch.envs import missions
from minigrid_tpu_torch.envs.empty import placed

MISSION = missions.register_template("use the key to open the door and then get to the goal")


def generate(keys: torch.Tensor, config: EnvConfig) -> EnvState:
    """One state per row of the `(B, 2)` key tensor."""
    key, k_reset = prng.split(keys, 2).unbind(1)
    state = empty_state(config, rng=k_reset)
    w, h = config.width, config.height
    dev = keys.device
    grid = G.wall_rect(state.grid, 0, 0, w, h)
    grid = G.set_cell(grid, w - 2, h - 2, (C.GOAL, C.GREEN, 0, 0, 0))

    ks = prng.split(key, 5)
    split_x = prng.randint(ks[:, 0], 2, w - 2)
    grid = G.paint_rect(grid, split_x, 0, split_x + 1, h, G.WALL_CELL)
    left = sampling.rect_mask(h, w, 0, 0, split_x, h, device=dev)
    ax, ay = sampling.sample_cell(ks[:, 1], sampling.free_cell_mask(grid) & left)
    agent_dir = sampling.sample_direction(ks[:, 2])

    door_y = prng.randint(ks[:, 3], 1, w - 2)
    grid = G.set_cell(grid, split_x, door_y, (C.DOOR, C.YELLOW, C.STATE_LOCKED, 0, 0))
    agent_pos = torch.stack([ax, ay], dim=1)
    kx, ky = sampling.sample_cell(ks[:, 4], sampling.free_cell_mask(grid, agent_pos) & left)
    grid = G.set_cell(grid, kx, ky, (C.KEY, C.YELLOW, 0, 0, 0))
    return placed(state, grid, ax, ay, agent_dir, missions.encode(MISSION))
