"""Obstructed maze (counterpart of `minigrid_tpu/envs/obstructedmaze.py`).

Find the blue ball behind locked doors. A locked door may be blocked by a
green ball on the near side, and its key may lie inside a grey box in the
room the door leads from; the door colours are a random permutation of
the six colours. Picking up the blue ball rewards and ends the episode
(the `pickup_target` transition); `aux[0]`, `aux[1]` hold its type and
colour.

Variants (static, in `config.extras`):
  * `("1D", key_in_box, blocked)`: a 1×2 room grid, one locked door;
  * `("full", agent_i, agent_j, key_in_box, blocked, num_quarters)`: a 3×3
    room grid, the agent in room (agent_i, agent_j), two locked doors on
    each opened side room, the ball in a corner room drawn per lane.

The id refreshes through the generic regen route: this batched
`generate`, packed (`ops/packed_gen.py::packed_generator`).
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core import prng
from minigrid_tpu_torch.core.state import MISSION_LEN, EnvConfig, EnvState, empty_state
from minigrid_tpu_torch.envs import missions, roomgrid
from minigrid_tpu_torch.envs.empty import placed

MISSION = missions.register_template("pick up the {c0} ball")

TRANSITION = "pickup_target"

# COLOR_NAMES[0..2] (sorted): the ball to find, the blocking balls, the boxes.
BALL_COLOR = C.COLOR_TO_IDX[C.COLOR_NAMES[0]]  # blue
BLOCK_COLOR = C.COLOR_TO_IDX[C.COLOR_NAMES[1]]  # green
BOX_COLOR = C.COLOR_TO_IDX[C.COLOR_NAMES[2]]  # grey

# The full variant's side rooms (door slot idx of the centre room leads to
# side room idx) and the corner rooms the ball may sit in, quarter by quarter.
SIDE_ROOMS = ((2, 1), (1, 2), (0, 1), (1, 0))
CORNERS = ((2, 0), (2, 2), (0, 2), (0, 0))


def _add_locked_door(rg, config, keys, i: int, j: int, k: int, color, key_in_box: bool, blocked: bool):
    """A locked door of `(B,)` colours in slot k of room (i, j); with
    `blocked` a green ball in front of it outside the room; its key (in a
    grey box with `key_in_box`) on a free cell of room (i, j)."""
    rg = roomgrid.add_door(rg, config, i, j, k, color, True)
    if blocked:
        pos = rg.door_pos[:, j, i, k]
        vx, vy = C.DIR_TO_VEC[k]
        rg = rg._replace(grid=G.set_cell(rg.grid, pos[:, 0] - vx, pos[:, 1] - vy, (C.BALL, BLOCK_COLOR, 0, 0, 0)))
    color = color.to(torch.int32)
    z = torch.zeros_like(color)
    if key_in_box:
        cell = torch.stack([torch.full_like(color, C.BOX), torch.full_like(color, BOX_COLOR), z,
                            torch.full_like(color, C.KEY), color], dim=1)
    else:
        cell = torch.stack([torch.full_like(color, C.KEY), color, z, z, z], dim=1)
    rg, _, _ = roomgrid.place_in_room(rg, config, keys, i, j, cell)
    return rg


def generate(keys: torch.Tensor, config: EnvConfig) -> EnvState:
    """One state per row of the `(B, 2)` key tensor."""
    key, k_reset = prng.split(keys, 2).unbind(1)
    state = empty_state(config, rng=k_reset)
    b, dev = keys.shape[0], keys.device
    ks = prng.split(key, 16)

    rg = roomgrid.init(ks[:, 0], config, state.grid)
    order = torch.tensor(roomgrid.COLOR_ORDER, dtype=torch.int32, device=dev)
    door_colors = order[prng.permutation(ks[:, 1], 6)]  # (B, 6)
    ball = torch.full((b,), BALL_COLOR, dtype=torch.int32, device=dev)

    if config.extras[0] == "1D":
        _, key_in_box, blocked = config.extras
        rg = _add_locked_door(rg, config, ks[:, 2], 0, 0, roomgrid.RIGHT, door_colors[:, 0], key_in_box, blocked)
        rg, *_ = roomgrid.add_object(rg, config, ks[:, 3], 1, 0, kind=C.BALL, color=ball)
        rg, agent_dir = roomgrid.place_agent(rg, config, ks[:, 4], 0, 0)
    else:
        _, agent_i, agent_j, key_in_box, blocked, num_quarters = config.extras
        for idx, (si, sj) in enumerate(SIDE_ROOMS[:num_quarters]):
            rg = roomgrid.add_door(rg, config, 1, 1, idx, door_colors[:, idx], False)
            for t_off, k_off in enumerate((-1, 1)):
                rg = _add_locked_door(
                    rg, config, ks[:, 5 + 2 * idx + t_off], si, sj, (idx + k_off) % 4,
                    door_colors[:, (idx + k_off) % 6], key_in_box, blocked,
                )
        corners = torch.tensor(CORNERS[:num_quarters], dtype=torch.int32, device=dev)
        ci, cj = corners[prng.randint(ks[:, 2], 0, num_quarters).long()].unbind(1)  # per lane
        rg, *_ = roomgrid.add_object(rg, config, ks[:, 3], ci, cj, kind=C.BALL, color=ball)
        rg, agent_dir = roomgrid.place_agent(rg, config, ks[:, 4], agent_i, agent_j)

    aux = state.aux.clone()
    aux[:, 0], aux[:, 1] = C.BALL, BALL_COLOR
    mission = torch.zeros((b, MISSION_LEN), dtype=torch.int32, device=dev)
    mission[:, 0], mission[:, 1] = MISSION, BALL_COLOR
    ax, ay = rg.agent_pos.unbind(1)
    return placed(state, rg.grid, ax, ay, agent_dir, mission).replace(aux=aux)
