"""Locked room (counterpart of `minigrid_tpu/envs/lockedroom.py`).

A 19x19 grid with a vertical hallway down the middle and six rooms, three
a side, each with a door at a fixed place. A random room is locked with
the goal inside; the key of its door's colour lies in another random
room; the six doors take the six colours in a random order; the agent
starts in the hallway. The mission names the key's colour, the key room's
colour and the locked door's. The base transition.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core import prng, sampling
from minigrid_tpu_torch.core.state import MISSION_LEN, EnvConfig, EnvState, empty_state
from minigrid_tpu_torch.envs import missions
from minigrid_tpu_torch.envs.empty import placed
from minigrid_tpu_torch.envs.roomgrid import COLOR_ORDER

MISSION = missions.register_template(
    "get the {c0} key from the {c1} room, unlock the {c2} door and go to the goal"
)


def _in_room(keys: torch.Tensor, tops: torch.Tensor, span_x: int, span_y: int):
    """A cell inside each lane's room (`tops` `(B, 2)`): one key reduced
    twice, over the room's interior width and height."""
    higher, lower = prng.randint_bits(keys)
    x = prng.randint_from_bits(higher, lower, 0, span_x) + tops[:, 0] + 1
    y = prng.randint_from_bits(higher, lower, 0, span_y) + tops[:, 1] + 1
    return x, y


def generate(keys: torch.Tensor, config: EnvConfig) -> EnvState:
    """One state per row of the `(B, 2)` key tensor."""
    key, k_reset = prng.split(keys, 2).unbind(1)
    state = empty_state(config, rng=k_reset)
    w, h = config.width, config.height
    b, dev = keys.shape[0], keys.device
    l_wall, r_wall = w // 2 - 2, w // 2 + 2
    room_w, room_h = l_wall + 1, h // 3 + 1

    grid = G.wall_rect(state.grid, 0, 0, w, h)
    grid = G.vert_wall(grid, l_wall, 0)
    grid = G.vert_wall(grid, r_wall, 0)
    rooms = []  # (top_x, top_y, door_x, door_y), left then right in each band
    for n in range(3):
        j = n * (h // 3)
        grid = G.horz_wall(grid, 0, j, l_wall)
        grid = G.horz_wall(grid, r_wall, j, w - r_wall)
        rooms += [(0, j, l_wall, j + 3), (r_wall, j, r_wall, j + 3)]
    tops = torch.tensor([r[:2] for r in rooms], dtype=torch.int32, device=dev)  # (6, 2)

    ks = prng.split(key, 7)
    locked_idx = prng.randint(ks[:, 0], 0, 6).long()
    gx, gy = _in_room(ks[:, 1], tops[locked_idx], room_w - 2, room_h - 2)
    grid = G.set_cell(grid, gx, gy, (C.GOAL, C.GREEN, 0, 0, 0))

    # Distinct door colours: the sorted-name colours in a random order.
    colors = torch.tensor(COLOR_ORDER, dtype=torch.int64, device=dev)[prng.permutation(ks[:, 2], 6)]  # (B, 6)
    zero = torch.zeros(b, dtype=torch.int64, device=dev)
    for i, (_, _, dx, dy) in enumerate(rooms):
        state_i = torch.where(locked_idx == i, C.STATE_LOCKED, C.STATE_CLOSED)
        door = torch.stack([torch.full_like(zero, C.DOOR), colors[:, i], state_i, zero, zero], dim=1)
        grid = G.set_cell(grid, dx, dy, door)

    # The key: in another room, the locked door's colour.
    off = prng.randint(ks[:, 3], 1, 6).long()
    key_idx = (locked_idx + off) % 6  # both non-negative
    kx, ky = _in_room(ks[:, 4], tops[key_idx], room_w - 2, room_h - 2)
    locked_color = colors.gather(1, locked_idx[:, None])[:, 0]
    key_cell = torch.stack([torch.full_like(zero, C.KEY), locked_color, zero, zero, zero], dim=1)
    grid = G.set_cell(grid, kx, ky, key_cell)

    hall = sampling.rect_mask(h, w, l_wall, 0, r_wall - l_wall, h, device=dev)
    ax, ay = sampling.sample_cell(ks[:, 5], sampling.free_cell_mask(grid) & hall)
    agent_dir = sampling.sample_direction(ks[:, 6])

    mission = torch.zeros((b, MISSION_LEN), dtype=torch.int32, device=dev)
    mission[:, 0] = MISSION
    mission[:, 1] = mission[:, 3] = locked_color.to(torch.int32)
    mission[:, 2] = colors.gather(1, key_idx[:, None])[:, 0].to(torch.int32)
    return placed(state, grid, ax, ay, agent_dir, mission)
