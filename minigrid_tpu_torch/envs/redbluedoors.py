"""Red and blue doors (counterpart of `minigrid_tpu/envs/redbluedoors.py`).

A `2·size × size` walled area holding a `size × size` room, with a red
door in the room's left wall and a blue door in its right wall, each at a
random row. Opening red and then blue rewards and ends the episode;
opening blue while red is closed, or red after blue, ends it with 0 (the
`redbluedoors` transition, `ops/packed_hooks.py`). `aux[0:2]` hold the
red door's position, `aux[2:4]` the blue door's.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core import prng, sampling
from minigrid_tpu_torch.core.state import EnvConfig, EnvState, empty_state
from minigrid_tpu_torch.core.step import StepResult, base_step, success_reward
from minigrid_tpu_torch.envs import missions
from minigrid_tpu_torch.envs.empty import placed

MISSION = missions.register_template("open the red door then the blue door")

TRANSITION = "redbluedoors"


def generate(keys: torch.Tensor, config: EnvConfig) -> EnvState:
    """One state per row of the `(B, 2)` key tensor."""
    key, k_reset = prng.split(keys, 2).unbind(1)
    state = empty_state(config, rng=k_reset)
    size = config.height  # the room's; the area is 2·size wide
    grid = G.wall_rect(state.grid, 0, 0, 2 * size, size)
    grid = G.wall_rect(grid, size // 2, 0, size, size)

    ks = prng.split(key, 4)
    room = sampling.rect_mask(size, 2 * size, size // 2, 0, size, size, device=keys.device)
    ax, ay = sampling.sample_cell(ks[:, 0], sampling.free_cell_mask(grid) & room)
    agent_dir = sampling.sample_direction(ks[:, 1])

    red_x, blue_x = size // 2, size // 2 + size - 1
    red_y = prng.randint(ks[:, 2], 1, size - 1)
    grid = G.set_cell(grid, red_x, red_y, (C.DOOR, C.RED, C.STATE_CLOSED, 0, 0))
    blue_y = prng.randint(ks[:, 3], 1, size - 1)
    grid = G.set_cell(grid, blue_x, blue_y, (C.DOOR, C.BLUE, C.STATE_CLOSED, 0, 0))
    aux = state.aux.clone()
    aux[:, 0], aux[:, 1], aux[:, 2], aux[:, 3] = red_x, red_y, blue_x, blue_y
    return placed(state, grid, ax, ay, agent_dir, missions.encode(MISSION)).replace(aux=aux)


def _door_open(grid: torch.Tensor, x, y) -> torch.Tensor:
    cell = G.get_cell(grid, x, y)
    return (cell[:, 0] == C.DOOR) & (cell[:, 2] == C.STATE_OPEN)


def step(state: EnvState, action: torch.Tensor, config: EnvConfig) -> StepResult:
    """The per-env `redbluedoors` transition: the blue door (`aux[2:4]`)
    open after the step succeeds iff the red one (`aux[0:2]`) was open
    before it, and fails otherwise; opening the red door while the blue one
    stood open fails. Success and failure end the episode."""
    aux = state.aux
    red_before = _door_open(state.grid, aux[:, 0], aux[:, 1])
    blue_before = _door_open(state.grid, aux[:, 2], aux[:, 3])
    res = base_step(state, action, config)
    red_after = _door_open(res.state.grid, aux[:, 0], aux[:, 1])
    blue_after = _door_open(res.state.grid, aux[:, 2], aux[:, 3])
    success = blue_after & red_before
    fail = (blue_after & ~red_before) | (~blue_after & red_after & blue_before)
    reward = torch.where(success, success_reward(res.state.step_count, config.max_steps), res.reward)
    reward = torch.where(fail, torch.zeros_like(reward), reward)
    return StepResult(res.state, reward, res.terminated | success | fail, res.truncated)
