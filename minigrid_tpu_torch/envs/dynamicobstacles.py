"""Dynamic obstacles (counterpart of `minigrid_tpu/envs/dynamicobstacles.py`).

A walled room with the goal at `(width-2, height-2)` and `n_obstacles`
blue balls. Before each step every ball random-walks one cell in its 3×3
box, one after another, to a uniform free cell (staying put when boxed
in); walking forward into a cell that was blocked before the walk costs
-1 and ends the episode. Actions outside {left, right, forward} act as
left. The walk and the penalty are the packed pre-hook and hook of the
`dynamicobstacles` transition (`ops/packed_hooks.py`); obstacle i's
coordinates live in `aux[2i]`, `aux[2i + 1]`.

The walk's bits are counter-based (`core/prng.py::hash_u31`, keyed on the
state's rng words and `step_count·n + i`), so the rng leaf never
advances inside an episode. `select_walk_target` is the one candidate
selection the plain pre-hook and the JAX package's both run.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core import prng, sampling
from minigrid_tpu_torch.core.state import Actions, EnvConfig, EnvState, empty_state
from minigrid_tpu_torch.core.step import StepResult, base_step
from minigrid_tpu_torch.core.view import front_pos
from minigrid_tpu_torch.envs import missions
from minigrid_tpu_torch.envs.empty import placed

MISSION = missions.register_template("get to the green goal square")

TRANSITION = "dynamicobstacles"

BALL_CELL = (C.BALL, C.BLUE, 0, 0, 0)

# The 3×3 box in row-major (dy, dx) order: the candidate order the
# selection indexes.
WALK_OFFSETS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))


def select_walk_target(valid9, u31, xs9, ys9, ox, oy):
    """The `u31 % count`-th valid candidate of the 3×3 box, or `(ox, oy)`
    when none is valid. `valid9`, `xs9`, `ys9` are nine tensors of one
    shape in `WALK_OFFSETS` order; `u31` holds 31 uniform bits."""
    count = valid9[0].to(torch.int32)
    for v in valid9[1:]:
        count = count + v.to(torch.int32)
    r = u31 % count.clamp(min=1)
    nx = torch.zeros_like(ox)
    ny = torch.zeros_like(oy)
    cum = torch.zeros_like(count)
    for j in range(9):
        vj = valid9[j].to(torch.int32)
        picked = (vj > 0) & (cum == r)
        nx = torch.where(picked, xs9[j], nx)
        ny = torch.where(picked, ys9[j], ny)
        cum = cum + vj
    movable = count > 0
    return torch.where(movable, nx, ox), torch.where(movable, ny, oy)


def generate(keys: torch.Tensor, config: EnvConfig) -> EnvState:
    """One state per row of the `(B, 2)` key tensor."""
    key, k_reset = prng.split(keys, 2).unbind(1)
    state = empty_state(config, rng=k_reset)
    w, h, n = config.width, config.height, config.n_obstacles
    b, dev = keys.shape[0], keys.device
    grid = G.wall_rect(state.grid, 0, 0, w, h)
    grid = G.set_cell(grid, w - 2, h - 2, (C.GOAL, C.GREEN, 0, 0, 0))

    ks = prng.split(key, 2 + n)
    if config.agent_start_pos is not None:
        ax = torch.full((b,), config.agent_start_pos[0], dtype=torch.int32, device=dev)
        ay = torch.full((b,), config.agent_start_pos[1], dtype=torch.int32, device=dev)
        agent_dir = torch.full((b,), config.agent_start_dir or 0, dtype=torch.int32, device=dev)
    else:
        ax, ay = sampling.sample_cell(ks[:, 0], sampling.free_cell_mask(grid))
        agent_dir = sampling.sample_direction(ks[:, 1])
    agent_pos = torch.stack([ax, ay], dim=1)

    aux = state.aux.clone()
    for i in range(n):
        ox, oy = sampling.sample_cell(ks[:, 2 + i], sampling.free_cell_mask(grid, agent_pos))
        grid = G.set_cell(grid, ox, oy, BALL_CELL)
        aux[:, 2 * i], aux[:, 2 * i + 1] = ox, oy
    return placed(state, grid, ax, ay, agent_dir, missions.encode(MISSION)).replace(aux=aux)


def _remap(action: torch.Tensor, config: EnvConfig) -> torch.Tensor:
    """Actions from `num_actions` up act as 0."""
    return torch.where(action >= config.num_actions, torch.zeros_like(action), action)


def step(state: EnvState, action: torch.Tensor, config: EnvConfig) -> StepResult:
    """The per-env `dynamicobstacles` transition: the front cell's
    clearance before the walk, the obstacles' walk (obstacle i of step t
    draws `hash_u31(rng, t·n + i)`, one after another, each to a uniform
    free cell of its 3×3 box that is not the agent's), then
    `post_walk_step`."""
    a = _remap(action, config)
    fwd = front_pos(state.agent_pos, state.agent_dir)
    ft = G.get_cell(state.grid, fwd[:, 0], fwd[:, 1])[:, 0]
    not_clear = (ft != C.EMPTY) & (ft != C.GOAL)

    grid, aux = state.grid, state.aux.clone()
    h, w, n = config.height, config.width, config.n_obstacles
    ax, ay = state.agent_pos[:, 0], state.agent_pos[:, 1]
    for i in range(n):
        u = prng.hash_u31(state.rng[:, 0], state.rng[:, 1], state.step_count * n + i)
        ox, oy = aux[:, 2 * i], aux[:, 2 * i + 1]
        valid9, xs9, ys9 = [], [], []
        for dy, dx in WALK_OFFSETS:
            nx, ny = ox + dx, oy + dy
            inb = (nx >= 0) & (nx < w) & (ny >= 0) & (ny < h)
            free = G.get_cell(grid, nx, ny)[:, 0] == C.EMPTY
            valid9.append(inb & free & ~((nx == ax) & (ny == ay)))
            xs9.append(nx)
            ys9.append(ny)
        nx, ny = select_walk_target(valid9, u, xs9, ys9, ox, oy)
        grid = G.set_cell(grid, ox, oy, G.EMPTY_CELL)
        grid = G.set_cell(grid, nx, ny, BALL_CELL)
        aux[:, 2 * i], aux[:, 2 * i + 1] = nx, ny
    return post_walk_step(state.replace(grid=grid, aux=aux), a, config, not_clear)


def post_walk_step(state: EnvState, action: torch.Tensor, config: EnvConfig, not_clear: torch.Tensor) -> StepResult:
    """The tail of `step` on a state whose walk is done: the base
    transition, then -1 and the end of the episode for a forward move whose
    front cell was blocked before the walk (`not_clear`)."""
    a = _remap(action, config)
    res = base_step(state, a, config)
    collided = (a == Actions.forward) & not_clear
    reward = torch.where(collided, torch.full_like(res.reward, -1.0), res.reward)
    return StepResult(res.state, reward, res.terminated | collided, res.truncated)
