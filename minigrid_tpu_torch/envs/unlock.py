"""Unlock (counterpart of `minigrid_tpu/envs/unlock.py`).

Two rooms side by side (a 1×2 room grid), joined by a locked door of a
random colour; the key of that colour lies in the left room, where the
agent starts. A toggle while the door stands open rewards and ends the
episode (the `unlock` transition, `ops/packed_hooks.py`). `aux[0:2]` hold
the door's position.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core import prng
from minigrid_tpu_torch.core.state import Actions, EnvConfig, EnvState, empty_state
from minigrid_tpu_torch.core.step import StepResult, base_step, success_reward
from minigrid_tpu_torch.envs import missions, roomgrid
from minigrid_tpu_torch.envs.empty import placed

MISSION = missions.register_template("open the door")

TRANSITION = "unlock"


def generate(keys: torch.Tensor, config: EnvConfig) -> EnvState:
    """One state per row of the `(B, 2)` key tensor."""
    key, k_reset = prng.split(keys, 2).unbind(1)
    state = empty_state(config, rng=k_reset)
    ks = prng.split(key, 4)

    rg = roomgrid.init(ks[:, 0], config, state.grid)
    color = roomgrid.rand_color(ks[:, 1])
    rg = roomgrid.add_door(rg, config, 0, 0, roomgrid.RIGHT, color, True)
    door_pos = rg.door_pos[:, 0, 0, roomgrid.RIGHT]
    rg, *_ = roomgrid.add_object(rg, config, ks[:, 2], 0, 0, kind=C.KEY, color=color)
    rg, agent_dir = roomgrid.place_agent(rg, config, ks[:, 3], 0, 0)

    aux = state.aux.clone()
    aux[:, 0], aux[:, 1] = door_pos[:, 0], door_pos[:, 1]
    ax, ay = rg.agent_pos.unbind(1)
    return placed(state, rg.grid, ax, ay, agent_dir, missions.encode(MISSION)).replace(aux=aux)


def step(state: EnvState, action: torch.Tensor, config: EnvConfig) -> StepResult:
    """The per-env `unlock` transition: a toggle that leaves the door
    (`aux[0:2]`) open rewards and ends the episode."""
    res = base_step(state, action, config)
    cell = G.get_cell(res.state.grid, res.state.aux[:, 0], res.state.aux[:, 1])
    door_open = (action == Actions.toggle) & (cell[:, 0] == C.DOOR) & (cell[:, 2] == C.STATE_OPEN)
    reward = torch.where(door_open, success_reward(res.state.step_count, config.max_steps), res.reward)
    return StepResult(res.state, reward, res.terminated | door_open, res.truncated)
