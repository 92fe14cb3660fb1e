"""Distribution-shift pair (counterpart of `minigrid_tpu/envs/distshift.py`).

9×7 room, goal at `(width-2, 1)`, two lava strips over columns
`3 .. width-4`: one at row 1 and one at `strip2_row`. Agent fixed at
(1, 1) facing right.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core import prng
from minigrid_tpu_torch.core.state import EnvConfig, EnvState, empty_state
from minigrid_tpu_torch.envs import missions
from minigrid_tpu_torch.envs.empty import fixed_start

MISSION = missions.register_template("get to the green goal square")

LAVA_CELL = (C.LAVA, C.RED, 0, 0, 0)


def generate(keys: torch.Tensor, config: EnvConfig) -> EnvState:
    """One state per row of the `(B, 2)` key tensor."""
    state = empty_state(config, rng=prng.split(keys, 2)[:, 1])
    w, h = config.width, config.height
    grid = G.wall_rect(state.grid, 0, 0, w, h)
    grid = G.set_cell(grid, w - 2, 1, (C.GOAL, C.GREEN, 0, 0, 0))
    grid = G.paint_rect(grid, 3, 1, 3 + (w - 6), 2, LAVA_CELL)
    r2 = config.strip2_row
    grid = G.paint_rect(grid, 3, r2, 3 + (w - 6), r2 + 1, LAVA_CELL)
    return fixed_start(state, grid, config, MISSION)
