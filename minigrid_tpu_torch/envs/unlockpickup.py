"""Unlock-pickup, plain and blocked (counterpart of
`minigrid_tpu/envs/unlockpickup.py`).

Two rooms side by side (a 1×2 room grid): a box of a random colour in the
right room, behind a locked door of a random colour whose key lies in the
left room, where the agent starts. Picking up the box rewards and ends
the episode (the `pickup_target` transition, shared with KeyCorridor).
The blocked variant (`config.extras == ("blocked",)`,
BlockedUnlockPickup) also parks a ball of a random colour in front of the
door. `aux[0]`, `aux[1]` hold the box's type and colour.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core import prng
from minigrid_tpu_torch.core.state import MISSION_LEN, Actions, EnvConfig, EnvState, empty_state
from minigrid_tpu_torch.core.step import StepResult, base_step, success_reward
from minigrid_tpu_torch.envs import missions, roomgrid
from minigrid_tpu_torch.envs.empty import placed
from minigrid_tpu_torch.envs.fetch import object_cells

MISSION = missions.register_template("pick up the {c0} {t1}")

TRANSITION = "pickup_target"


def generate(keys: torch.Tensor, config: EnvConfig) -> EnvState:
    """One state per row of the `(B, 2)` key tensor."""
    key, k_reset = prng.split(keys, 2).unbind(1)
    state = empty_state(config, rng=k_reset)
    b, dev = keys.shape[0], keys.device
    ks = prng.split(key, 6)

    rg = roomgrid.init(ks[:, 0], config, state.grid)
    rg, obj_type, obj_color, _, _ = roomgrid.add_object(rg, config, ks[:, 1], 1, 0, kind=C.BOX)
    door_color = roomgrid.rand_color(ks[:, 2])
    rg = roomgrid.add_door(rg, config, 0, 0, roomgrid.RIGHT, door_color, True)
    if "blocked" in config.extras:
        pos = rg.door_pos[:, 0, 0, roomgrid.RIGHT]
        ball = object_cells(torch.full((b,), C.BALL, dtype=torch.int32, device=dev), roomgrid.rand_color(ks[:, 3]))
        rg = rg._replace(grid=G.set_cell(rg.grid, pos[:, 0] - 1, pos[:, 1], ball))
    rg, *_ = roomgrid.add_object(rg, config, ks[:, 4], 0, 0, kind=C.KEY, color=door_color)
    rg, agent_dir = roomgrid.place_agent(rg, config, ks[:, 5], 0, 0)

    aux = state.aux.clone()
    aux[:, 0], aux[:, 1] = obj_type, obj_color
    mission = torch.zeros((b, MISSION_LEN), dtype=torch.int32, device=dev)
    mission[:, 0], mission[:, 1], mission[:, 2] = MISSION, obj_color, obj_type
    ax, ay = rg.agent_pos.unbind(1)
    return placed(state, rg.grid, ax, ay, agent_dir, mission).replace(aux=aux)


def pickup_target_step(state: EnvState, action: torch.Tensor, config: EnvConfig) -> StepResult:
    """The per-env `pickup_target` transition (UnlockPickup, KeyCorridor,
    ObstructedMaze): a pickup that leaves the agent carrying the target
    (type, colour) of `aux[0:2]` rewards and terminates."""
    res = base_step(state, action, config)
    c, aux = res.state.carrying.to(torch.int32), res.state.aux
    got = (action == Actions.pickup) & (c[:, 0] == aux[:, 0]) & (c[:, 1] == aux[:, 1])
    reward = torch.where(got, success_reward(res.state.step_count, config.max_steps), res.reward)
    return StepResult(res.state, reward, res.terminated | got, res.truncated)

