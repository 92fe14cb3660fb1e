"""T-maze memory (counterpart of `minigrid_tpu/envs/memory.py`).

A start chamber holding a green cue object (key or ball), a horizontal
hallway, and a vertical hallway whose two ends hold one green key and one
green ball. Stepping onto the cell beside the end object that matches the
cue rewards, onto the other fails with 0; either ends the episode (the
`memory` transition, `ops/packed_hooks.py`, where pickup also acts as
toggle). `aux[0:2]` hold the success cell, `aux[2:4]` the failure cell.
The `S*Random` ids draw the hallway's end column.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core import prng
from minigrid_tpu_torch.core.state import Actions, EnvConfig, EnvState, empty_state
from minigrid_tpu_torch.core.step import StepResult, base_step, success_reward
from minigrid_tpu_torch.envs import missions
from minigrid_tpu_torch.envs.empty import placed
from minigrid_tpu_torch.envs.fetch import object_cells

MISSION = missions.register_template("go to the matching object at the end of the hallway")

TRANSITION = "memory"


def generate(keys: torch.Tensor, config: EnvConfig) -> EnvState:
    """One state per row of the `(B, 2)` key tensor."""
    key, k_reset = prng.split(keys, 2).unbind(1)
    state = empty_state(config, rng=k_reset)
    w, h = config.width, config.height
    assert h % 2 == 1
    b, dev = keys.shape[0], keys.device
    upper, lower, mid = h // 2 - 2, h // 2 + 2, h // 2

    ks = prng.split(key, 4)
    if config.random_length:
        hallway_end = prng.randint(ks[:, 0], 4, w - 2)
    else:
        hallway_end = torch.full((b,), w - 3, dtype=torch.int32, device=dev)

    grid = G.wall_rect(state.grid, 0, 0, w, h)
    # The start room's walls and the two cells narrowing into the hallway.
    grid = G.horz_wall(grid, 1, upper, 4)
    grid = G.horz_wall(grid, 1, lower, 4)
    grid = G.set_cell(grid, 4, upper + 1, G.WALL_CELL)
    grid = G.set_cell(grid, 4, lower - 1, G.WALL_CELL)
    # The horizontal hallway up to the end column, and that column but for
    # the middle row.
    grid = G.paint_rect(grid, 5, upper + 1, hallway_end, upper + 2, G.WALL_CELL)
    grid = G.paint_rect(grid, 5, lower - 1, hallway_end, lower, G.WALL_CELL)
    grid = G.paint_rect(grid, hallway_end, 0, hallway_end + 1, mid, G.WALL_CELL)
    grid = G.paint_rect(grid, hallway_end, mid + 1, hallway_end + 1, h, G.WALL_CELL)

    agent_x = prng.randint(ks[:, 1], 1, hallway_end + 1)
    green = torch.full((b,), C.GREEN, dtype=torch.int32, device=dev)
    cue = torch.where(prng.randint(ks[:, 2], 0, 2) == 0, C.KEY, C.BALL).to(torch.int32)
    grid = G.set_cell(grid, 1, mid - 1, object_cells(cue, green))
    top_is_ball = prng.randint(ks[:, 3], 0, 2) == 0
    top = torch.where(top_is_ball, C.BALL, C.KEY).to(torch.int32)
    bottom = torch.where(top_is_ball, C.KEY, C.BALL).to(torch.int32)
    end_x = hallway_end + 1
    grid = G.set_cell(grid, end_x, mid - 2, object_cells(top, green))
    grid = G.set_cell(grid, end_x, mid + 2, object_cells(bottom, green))

    # The cell one step towards the hallway from each end object.
    top_matches = top == cue
    aux = state.aux.clone()
    aux[:, 0], aux[:, 2] = end_x, end_x
    aux[:, 1] = torch.where(top_matches, mid - 1, mid + 1)
    aux[:, 3] = torch.where(top_matches, mid + 1, mid - 1)
    agent_y = torch.full((b,), mid, dtype=torch.int32, device=dev)
    agent_dir = torch.zeros((b,), dtype=torch.int32, device=dev)
    return placed(state, grid, agent_x, agent_y, agent_dir, missions.encode(MISSION)).replace(aux=aux)


def step(state: EnvState, action: torch.Tensor, config: EnvConfig) -> StepResult:
    """The per-env `memory` transition: pickup acts as toggle; stepping on
    the success cell (`aux[0:2]`) rewards, on the failure cell (`aux[2:4]`)
    gives 0, and both end the episode."""
    a = torch.where(action == Actions.pickup, torch.full_like(action, Actions.toggle), action)
    res = base_step(state, a, config)
    pos, aux = res.state.agent_pos, res.state.aux
    on_success = (pos[:, 0] == aux[:, 0]) & (pos[:, 1] == aux[:, 1])
    on_failure = (pos[:, 0] == aux[:, 2]) & (pos[:, 1] == aux[:, 3])
    reward = torch.where(on_success, success_reward(res.state.step_count, config.max_steps), res.reward)
    reward = torch.where(on_failure, torch.zeros_like(reward), reward)
    return StepResult(res.state, reward, res.terminated | on_success | on_failure, res.truncated)
