"""Four rooms (counterpart of `minigrid_tpu/envs/fourrooms.py`).

A 19x19 grid split into 2x2 rooms by a cross of walls, one random gap in
each of the cross's four arms; the agent on a uniform free cell with a
uniform heading, then the goal on a uniform free cell other than the
agent's. The base transition.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core import prng, sampling
from minigrid_tpu_torch.core.state import EnvConfig, EnvState, empty_state
from minigrid_tpu_torch.envs import missions
from minigrid_tpu_torch.envs.empty import placed

MISSION = missions.register_template("Reach the goal")


def generate(keys: torch.Tensor, config: EnvConfig) -> EnvState:
    """One state per row of the `(B, 2)` key tensor."""
    key, k_reset = prng.split(keys, 2).unbind(1)
    state = empty_state(config, rng=k_reset)
    w, h = config.width, config.height
    room_w, room_h = w // 2, h // 2
    grid = G.wall_rect(state.grid, 0, 0, w, h)
    grid = G.vert_wall(grid, room_w, 0)
    grid = G.horz_wall(grid, 0, room_h)

    # The gaps: the upper and lower arms' rows, the left and right arms' columns.
    ks = prng.split(key, 7)
    gap_v0 = prng.randint(ks[:, 0], 1, room_h)
    gap_h0 = prng.randint(ks[:, 1], 1, room_w)
    gap_h1 = prng.randint(ks[:, 2], room_w + 1, w - 1)
    gap_v1 = prng.randint(ks[:, 3], room_h + 1, h - 1)
    grid = G.set_cell(grid, room_w, gap_v0, G.EMPTY_CELL)
    grid = G.set_cell(grid, gap_h0, room_h, G.EMPTY_CELL)
    grid = G.set_cell(grid, gap_h1, room_h, G.EMPTY_CELL)
    grid = G.set_cell(grid, room_w, gap_v1, G.EMPTY_CELL)

    ax, ay = sampling.sample_cell(ks[:, 4], sampling.free_cell_mask(grid))
    agent_dir = sampling.sample_direction(ks[:, 5])
    agent_pos = torch.stack([ax, ay], dim=1)
    gx, gy = sampling.sample_cell(ks[:, 6], sampling.free_cell_mask(grid, agent_pos))
    grid = G.set_cell(grid, gx, gy, (C.GOAL, C.GREEN, 0, 0, 0))
    return placed(state, grid, ax, ay, agent_dir, missions.encode(MISSION))
