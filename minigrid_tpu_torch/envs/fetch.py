"""Fetch (counterpart of `minigrid_tpu/envs/fetch.py`).

`num_objs` keys and balls of random colours on a walled room; one is the
target. Picking up the target rewards and ends the episode; picking up
anything else ends it with 0 (the `fetch` transition,
`ops/packed_hooks.py`). The mission is one of five synonym templates.
`aux[0]`, `aux[1]` hold the target's type and colour.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core import prng, sampling
from minigrid_tpu_torch.core.state import MISSION_LEN, EnvConfig, EnvState, empty_state
from minigrid_tpu_torch.core.step import StepResult, base_step, success_reward
from minigrid_tpu_torch.envs import missions
from minigrid_tpu_torch.envs.empty import placed
from minigrid_tpu_torch.envs.roomgrid import rand_color

MISSIONS = [
    missions.register_template("get a {c0} {t1}"),
    missions.register_template("go get a {c0} {t1}"),
    missions.register_template("fetch a {c0} {t1}"),
    missions.register_template("go fetch a {c0} {t1}"),
    missions.register_template("you must fetch a {c0} {t1}"),
]

TRANSITION = "fetch"


def object_cells(types: torch.Tensor, colors: torch.Tensor) -> torch.Tensor:
    """`(B, 5)` cells of plain objects of the given `(B,)` types and colours."""
    z = torch.zeros_like(types)
    return torch.stack([types, colors, z, z, z], dim=1)


def generate(keys: torch.Tensor, config: EnvConfig) -> EnvState:
    """One state per row of the `(B, 2)` key tensor."""
    key, k_reset = prng.split(keys, 2).unbind(1)
    state = empty_state(config, rng=k_reset)
    w, h, n = config.width, config.height, config.num_objs
    b, dev = keys.shape[0], keys.device
    grid = G.wall_rect(state.grid, 0, 0, w, h)

    ks = prng.split(key, 3 * n + 4)
    types, colors = [], []
    for i in range(n):
        t = torch.where(prng.randint(ks[:, 3 * i], 0, 2) == 0, C.KEY, C.BALL).to(torch.int32)
        col = rand_color(ks[:, 3 * i + 1])
        x, y = sampling.sample_cell(ks[:, 3 * i + 2], sampling.free_cell_mask(grid))
        grid = G.set_cell(grid, x, y, object_cells(t, col))
        types.append(t)
        colors.append(col)
    ax, ay = sampling.sample_cell(ks[:, -4], sampling.free_cell_mask(grid))
    agent_dir = sampling.sample_direction(ks[:, -3])

    target = prng.randint(ks[:, -2], 0, n).long()[:, None]
    t_type = torch.gather(torch.stack(types, 1), 1, target)[:, 0]
    t_color = torch.gather(torch.stack(colors, 1), 1, target)[:, 0]
    tmpl = torch.tensor(MISSIONS, dtype=torch.int32, device=dev)[prng.randint(ks[:, -1], 0, 5).long()]
    mission = torch.zeros((b, MISSION_LEN), dtype=torch.int32, device=dev)
    mission[:, 0], mission[:, 1], mission[:, 2] = tmpl, t_color, t_type
    aux = state.aux.clone()
    aux[:, 0], aux[:, 1] = t_type, t_color
    return placed(state, grid, ax, ay, agent_dir, mission).replace(aux=aux)


def step(state: EnvState, action: torch.Tensor, config: EnvConfig) -> StepResult:
    """The per-env `fetch` transition: holding any object ends the episode,
    rewarded iff it is the target (type, colour) of `aux[0:2]`."""
    res = base_step(state, action, config)
    c, aux = res.state.carrying.to(torch.int32), res.state.aux
    has = c[:, 0] > 0
    match = has & (c[:, 0] == aux[:, 0]) & (c[:, 1] == aux[:, 1])
    reward = torch.where(match, success_reward(res.state.step_count, config.max_steps), res.reward)
    reward = torch.where(has & ~match, torch.zeros_like(reward), reward)
    return StepResult(res.state, reward, res.terminated | has, res.truncated)
