"""Go to the door (counterpart of `minigrid_tpu/envs/gotodoor.py`).

The room's width and height are drawn in `[5, size]` at each reset (the
grid stays `size × size`; cells outside the room are unreachable); four
doors of distinct colours sit on its four walls. The `done` action while
cross-adjacent to the target door rewards; `done` and `toggle` end the
episode (the `gotodoor` transition, `ops/packed_hooks.py`). `aux[0:2]`
hold the target door's position, `aux[2]` its colour.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core import prng, sampling
from minigrid_tpu_torch.core.state import MISSION_LEN, Actions, EnvConfig, EnvState, empty_state
from minigrid_tpu_torch.core.step import StepResult, base_step, success_reward
from minigrid_tpu_torch.envs import missions
from minigrid_tpu_torch.envs.empty import placed
from minigrid_tpu_torch.envs.roomgrid import COLOR_ORDER

MISSION = missions.register_template("go to the {c0} door")

TRANSITION = "gotodoor"


def generate(keys: torch.Tensor, config: EnvConfig) -> EnvState:
    """One state per row of the `(B, 2)` key tensor."""
    key, k_reset = prng.split(keys, 2).unbind(1)
    state = empty_state(config, rng=k_reset)
    size = config.width
    b, dev = keys.shape[0], keys.device

    ks = prng.split(key, 10)
    rw = prng.randint(ks[:, 0], 5, size + 1)
    rh = prng.randint(ks[:, 1], 5, size + 1)
    grid = G.paint_rect(state.grid, 0, 0, rw, 1, G.WALL_CELL)
    grid = G.paint_rect(grid, 0, rh - 1, rw, rh, G.WALL_CELL)
    grid = G.paint_rect(grid, 0, 0, 1, rh, G.WALL_CELL)
    grid = G.paint_rect(grid, rw - 1, 0, rw, rh, G.WALL_CELL)

    # The doors on the top, bottom, left and right walls.
    zero = torch.zeros_like(rw)
    door_x = torch.stack([prng.randint(ks[:, 2], 2, rw - 2), prng.randint(ks[:, 3], 2, rw - 2), zero, rw - 1], 1)
    door_y = torch.stack([zero, rh - 1, prng.randint(ks[:, 4], 2, rh - 2), prng.randint(ks[:, 5], 2, rh - 2)], 1)
    # Four distinct colours: the first four of a random permutation.
    order = torch.tensor(COLOR_ORDER, dtype=torch.int32, device=dev)
    colors = order[prng.permutation(ks[:, 6], 6)[:, :4]]
    for i in range(4):
        cell = torch.stack([torch.full_like(rw, C.DOOR), colors[:, i], torch.full_like(rw, C.STATE_CLOSED), zero, zero], 1)
        grid = G.set_cell(grid, door_x[:, i], door_y[:, i], cell)

    room = sampling.rect_mask(size, size, 0, 0, rw, rh, device=dev)
    ax, ay = sampling.sample_cell(ks[:, 7], sampling.free_cell_mask(grid) & room)
    agent_dir = sampling.sample_direction(ks[:, 8])

    target = prng.randint(ks[:, 9], 0, 4).long()[:, None]
    t_color = torch.gather(colors, 1, target)[:, 0]
    aux = state.aux.clone()
    aux[:, 0] = torch.gather(door_x, 1, target)[:, 0]
    aux[:, 1] = torch.gather(door_y, 1, target)[:, 0]
    aux[:, 2] = t_color
    mission = torch.zeros((b, MISSION_LEN), dtype=torch.int32, device=dev)
    mission[:, 0], mission[:, 1] = MISSION, t_color
    return placed(state, grid, ax, ay, agent_dir, mission).replace(aux=aux)


def done_near_step(state: EnvState, action: torch.Tensor, config: EnvConfig, near) -> StepResult:
    """The `done`-at-the-target transition (GoToDoor, GoToObject): `done`
    where `near(|dx|, |dy|)` holds between the agent and the target
    (`aux[0:2]`) rewards; `done` and `toggle` end the episode."""
    res = base_step(state, action, config)
    d = (res.state.agent_pos - res.state.aux[:, 0:2]).abs()
    is_done = action == Actions.done
    reward = torch.where(is_done & near(d[:, 0], d[:, 1]), success_reward(res.state.step_count, config.max_steps),
                         res.reward)
    return StepResult(res.state, reward, res.terminated | is_done | (action == Actions.toggle), res.truncated)


def step(state: EnvState, action: torch.Tensor, config: EnvConfig) -> StepResult:
    """The per-env `gotodoor` transition: `done` cross-adjacent to the
    target door rewards."""
    return done_near_step(state, action, config, lambda dx, dy: ((dx == 0) & (dy == 1)) | ((dy == 0) & (dx == 1)))
