"""Put near (counterpart of `minigrid_tpu/envs/putnear.py`).

`num_objs` distinct objects, no two within one cell of each other; the
agent must pick up the `move` object and drop it within one cell
(Chebyshev distance 1) of the `target` object. A pickup action while
holding the wrong object ends the episode; any drop after carrying ends
it, rewarded only when the drop landed near the target (the `putnear`
transition, `ops/packed_hooks.py`). `aux[0]`, `aux[1]` hold the move
object's type and colour, `aux[2:4]` the target's position, `aux[4]`,
`aux[5]` its type and colour.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core import prng, sampling
from minigrid_tpu_torch.core.state import MISSION_LEN, Actions, EnvConfig, EnvState, empty_state
from minigrid_tpu_torch.core.step import StepResult, base_step, success_reward
from minigrid_tpu_torch.core.view import front_pos
from minigrid_tpu_torch.envs import missions
from minigrid_tpu_torch.envs.empty import placed
from minigrid_tpu_torch.envs.fetch import object_cells
from minigrid_tpu_torch.envs.gotoobject import distinct_objects, pick

MISSION = missions.register_template("put the {c0} {t1} near the {c2} {t3}")

TRANSITION = "putnear"


def generate(keys: torch.Tensor, config: EnvConfig) -> EnvState:
    """One state per row of the `(B, 2)` key tensor."""
    key, k_reset = prng.split(keys, 2).unbind(1)
    state = empty_state(config, rng=k_reset)
    w, h, n = config.width, config.height, config.num_objs
    b, dev = keys.shape[0], keys.device
    grid = G.wall_rect(state.grid, 0, 0, w, h)

    ks = prng.split(key, n + 5)
    types, colors = distinct_objects(ks[:, 0], n)
    # Each object avoids the 3x3 neighbourhoods of those placed before it.
    not_near = torch.ones((b, h, w), dtype=torch.bool, device=dev)
    xs, ys = [], []
    for i in range(n):
        x, y = sampling.sample_cell(ks[:, 1 + i], sampling.free_cell_mask(grid) & not_near)
        grid = G.set_cell(grid, x, y, object_cells(types[:, i], colors[:, i]))
        not_near = not_near & ~sampling.rect_mask(h, w, x - 1, y - 1, 3, 3, device=dev)
        xs.append(x)
        ys.append(y)
    ax, ay = sampling.sample_cell(ks[:, -4], sampling.free_cell_mask(grid))
    agent_dir = sampling.sample_direction(ks[:, -3])

    move = prng.randint(ks[:, -2], 0, n)
    target = (move + prng.randint(ks[:, -1], 1, n)) % n  # any object but the move one
    aux = state.aux.clone()
    aux[:, 0], aux[:, 1] = pick(types, move), pick(colors, move)
    aux[:, 2], aux[:, 3] = pick(torch.stack(xs, 1), target), pick(torch.stack(ys, 1), target)
    aux[:, 4], aux[:, 5] = pick(types, target), pick(colors, target)
    mission = torch.zeros((b, MISSION_LEN), dtype=torch.int32, device=dev)
    mission[:, 0] = MISSION
    mission[:, 1], mission[:, 2], mission[:, 3], mission[:, 4] = aux[:, 1], aux[:, 0], aux[:, 5], aux[:, 4]
    return placed(state, grid, ax, ay, agent_dir, mission).replace(aux=aux)


def step(state: EnvState, action: torch.Tensor, config: EnvConfig) -> StepResult:
    """The per-env `putnear` transition: a pickup while holding anything
    but the object to move (`aux[0:2]`) ends the episode; so does any drop
    while holding, rewarded iff it landed next to the target (`aux[2:4]`)."""
    res = base_step(state, action, config)
    aux = res.state.aux
    c = res.state.carrying.to(torch.int32)
    wrong = (c[:, 0] > 0) & ((c[:, 0] != aux[:, 0]) | (c[:, 1] != aux[:, 1]))
    pickup_fail = (action == Actions.pickup) & wrong
    dropped = (state.carrying[:, 0] > 0) & (action == Actions.drop)
    landed = dropped & (c[:, 0] == 0)
    fwd = front_pos(state.agent_pos, state.agent_dir)
    near = ((fwd[:, 0] - aux[:, 2]).abs() <= 1) & ((fwd[:, 1] - aux[:, 3]).abs() <= 1)
    reward = torch.where(landed & near, success_reward(res.state.step_count, config.max_steps), res.reward)
    return StepResult(res.state, reward, res.terminated | pickup_fail | dropped, res.truncated)
