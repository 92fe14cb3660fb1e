"""Go to the object (counterpart of `minigrid_tpu/envs/gotoobject.py`).

`num_objs` distinct (type, colour) objects among keys, balls and boxes on
a walled room. The `done` action within one cell (Chebyshev distance 1)
of the target rewards; `done` and `toggle` end the episode (the
`gotoobject` transition, `ops/packed_hooks.py`). `aux[0:2]` hold the
target's position, `aux[2]` its type, `aux[3]` its colour.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core import prng, sampling
from minigrid_tpu_torch.core.state import MISSION_LEN, EnvConfig, EnvState, empty_state
from minigrid_tpu_torch.core.step import StepResult
from minigrid_tpu_torch.envs import missions
from minigrid_tpu_torch.envs.empty import placed
from minigrid_tpu_torch.envs.fetch import object_cells
from minigrid_tpu_torch.envs.gotodoor import done_near_step

MISSION = missions.register_template("go to the {c0} {t1}")

OBJ_TYPES = (C.KEY, C.BALL, C.BOX)

TRANSITION = "gotoobject"


def distinct_objects(keys: torch.Tensor, n: int):
    """`n` distinct (type, colour) pairs per key, the first `n` of a
    permutation of the 18 candidates: `(B, n)` int32 types and colours."""
    pairs = prng.permutation(keys, 18)[:, :n]
    types = torch.tensor(OBJ_TYPES, dtype=torch.int32, device=keys.device)[pairs // 6]
    return types, (pairs % 6).to(torch.int32)


def pick(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`rows[b, idx[b]]` of a `(B, n)` tensor: `(B,)`."""
    return torch.gather(rows, 1, idx.long()[:, None])[:, 0]


def generate(keys: torch.Tensor, config: EnvConfig) -> EnvState:
    """One state per row of the `(B, 2)` key tensor."""
    key, k_reset = prng.split(keys, 2).unbind(1)
    state = empty_state(config, rng=k_reset)
    w, h, n = config.width, config.height, config.num_objs
    b, dev = keys.shape[0], keys.device
    grid = G.wall_rect(state.grid, 0, 0, w, h)

    ks = prng.split(key, n + 5)
    types, colors = distinct_objects(ks[:, 0], n)
    xs, ys = [], []
    for i in range(n):
        x, y = sampling.sample_cell(ks[:, 1 + i], sampling.free_cell_mask(grid))
        grid = G.set_cell(grid, x, y, object_cells(types[:, i], colors[:, i]))
        xs.append(x)
        ys.append(y)
    ax, ay = sampling.sample_cell(ks[:, -4], sampling.free_cell_mask(grid))
    agent_dir = sampling.sample_direction(ks[:, -3])

    target = prng.randint(ks[:, -2], 0, n)
    t_type, t_color = pick(types, target), pick(colors, target)
    aux = state.aux.clone()
    aux[:, 0], aux[:, 1] = pick(torch.stack(xs, 1), target), pick(torch.stack(ys, 1), target)
    aux[:, 2], aux[:, 3] = t_type, t_color
    mission = torch.zeros((b, MISSION_LEN), dtype=torch.int32, device=dev)
    mission[:, 0], mission[:, 1], mission[:, 2] = MISSION, t_color, t_type
    return placed(state, grid, ax, ay, agent_dir, mission).replace(aux=aux)


def step(state: EnvState, action: torch.Tensor, config: EnvConfig) -> StepResult:
    """The per-env `gotoobject` transition: `done` within one cell of the
    target rewards."""
    return done_near_step(state, action, config, lambda dx, dy: (dx <= 1) & (dy <= 1))
