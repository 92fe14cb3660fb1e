"""Playground (counterpart of `minigrid_tpu/envs/playground.py`).

A 19x19 grid of 3x3 rooms with a closed door of a random colour at a
random place in each inner wall, and 12 objects (key, ball or box, of a
random colour) on uniform free cells; the agent on a uniform free cell
with a uniform heading. The mission is empty and there is no goal, so no
step rewards. The base transition.

The keys come from one `split(key, 9·2·2 + 12·3 + 2)`, consumed in order:
a room draws a door's place and colour only where it has a neighbour to
the right or below, so a room's first key is not at a fixed stride.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core import prng, sampling
from minigrid_tpu_torch.core.state import EnvConfig, EnvState, empty_state
from minigrid_tpu_torch.envs import missions
from minigrid_tpu_torch.envs.empty import placed
from minigrid_tpu_torch.envs.roomgrid import rand_color

NUM_OBJECTS = 12
OBJECT_TYPES = (C.KEY, C.BALL, C.BOX)


def _cell(kind, color) -> torch.Tensor:
    """`(B, 5)` cells of `kind` (an int or `(B,)`) and `(B,)` colours."""
    color = color.to(torch.int64)
    zero = torch.zeros_like(color)
    kind = torch.as_tensor(kind, dtype=torch.int64, device=color.device).expand_as(color)
    return torch.stack([kind, color, zero, zero, zero], dim=1)


def _door(color) -> torch.Tensor:
    cell = _cell(C.DOOR, color)
    cell[:, 2] = C.STATE_CLOSED
    return cell


def generate(keys: torch.Tensor, config: EnvConfig) -> EnvState:
    """One state per row of the `(B, 2)` key tensor."""
    key, k_reset = prng.split(keys, 2).unbind(1)
    state = empty_state(config, rng=k_reset)
    w, h = config.width, config.height
    dev = keys.device
    room_w, room_h = w // 3, h // 3
    grid = G.wall_rect(state.grid, 0, 0, w, h)

    ks = prng.split(key, 9 * 2 * 2 + NUM_OBJECTS * 3 + 2)
    order = iter(range(ks.shape[1]))

    def next_key():
        return ks[:, next(order)]

    for j in range(3):
        for i in range(3):
            x_l, y_t = i * room_w, j * room_h
            x_r, y_b = x_l + room_w, y_t + room_h
            if i + 1 < 3:
                grid = G.vert_wall(grid, x_r, y_t, room_h)
                dy = prng.randint(next_key(), y_t + 1, y_b - 1)
                grid = G.set_cell(grid, x_r, dy, _door(rand_color(next_key())))
            if j + 1 < 3:
                grid = G.horz_wall(grid, x_l, y_b, room_w)
                dx = prng.randint(next_key(), x_l + 1, x_r - 1)
                grid = G.set_cell(grid, dx, y_b, _door(rand_color(next_key())))

    types = torch.tensor(OBJECT_TYPES, dtype=torch.int64, device=dev)
    for _ in range(NUM_OBJECTS):
        kind = types[prng.randint(next_key(), 0, 3).long()]
        color = rand_color(next_key())
        x, y = sampling.sample_cell(next_key(), sampling.free_cell_mask(grid))
        grid = G.set_cell(grid, x, y, _cell(kind, color))

    ax, ay = sampling.sample_cell(next_key(), sampling.free_cell_mask(grid))
    agent_dir = sampling.sample_direction(next_key())
    return placed(state, grid, ax, ay, agent_dir, missions.encode(0))
