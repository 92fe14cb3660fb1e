"""World <-> egocentric-view coordinates (counterpart of
`minigrid_tpu/core/view.py`), batched: poses are `(B, 2)` int32 positions
and `(B,)` int32 headings, and world cells are ints or `(B,)` tensors.

View frame: `(vx, vy)`, `vx` in [0, V) the lateral index (the view's left
edge is 0) and `vy` in [0, V) the forward index (the far edge is 0); the
agent sits at `(V // 2, V - 1)` facing `vy = 0`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core.state import CH_TYPE, EnvConfig, EnvState


def dir_vec(agent_dir: torch.Tensor) -> torch.Tensor:
    """`(B, 2)` heading unit vectors."""
    table = torch.tensor(C.DIR_TO_VEC, dtype=torch.int32, device=agent_dir.device)
    return table[agent_dir.long()]


def right_vec(agent_dir: torch.Tensor) -> torch.Tensor:
    """`(B, 2)` right-perpendiculars of the headings."""
    d = dir_vec(agent_dir)
    return torch.stack([-d[..., 1], d[..., 0]], dim=-1)


def front_pos(agent_pos: torch.Tensor, agent_dir: torch.Tensor) -> torch.Tensor:
    """`(B, 2)` cells directly in front of the agents."""
    return agent_pos + dir_vec(agent_dir)


def get_view_exts(
    agent_pos: torch.Tensor, agent_dir: torch.Tensor, view_size: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """`(top_x, top_y, bot_x, bot_y)`, `(B,)` each: the view window's world
    extents, the agent centred on its bottom row."""
    half = view_size // 2
    dev = agent_dir.device
    dx = torch.tensor([0, -half, -view_size + 1, -half], dtype=torch.int32, device=dev)
    dy = torch.tensor([-half, 0, -half, -view_size + 1], dtype=torch.int32, device=dev)
    top_x = agent_pos[..., 0] + dx[agent_dir.long()]
    top_y = agent_pos[..., 1] + dy[agent_dir.long()]
    return top_x, top_y, top_x + view_size, top_y + view_size


def get_view_coords(agent_pos: torch.Tensor, agent_dir: torch.Tensor, view_size: int, i, j):
    """World cell `(i, j)` -> view coords `(vx, vy)`, `(B,)` int32 each;
    they may fall outside [0, V) (see `relative_coords`)."""
    f = dir_vec(agent_dir)
    r = right_vec(agent_dir)
    half = view_size // 2
    top = agent_pos + f * (view_size - 1) - r * half  # the view's far-left corner
    lx = torch.as_tensor(i, dtype=torch.int32, device=agent_pos.device) - top[..., 0]
    ly = torch.as_tensor(j, dtype=torch.int32, device=agent_pos.device) - top[..., 1]
    vx = r[..., 0] * lx + r[..., 1] * ly
    vy = -(f[..., 0] * lx + f[..., 1] * ly)
    return vx, vy


def relative_coords(agent_pos: torch.Tensor, agent_dir: torch.Tensor, view_size: int, x, y):
    """`(vx, vy, valid)`: the view coords and whether they lie in the view."""
    vx, vy = get_view_coords(agent_pos, agent_dir, view_size, x, y)
    valid = (vx >= 0) & (vx < view_size) & (vy >= 0) & (vy < view_size)
    return vx, vy, valid


def in_view(agent_pos: torch.Tensor, agent_dir: torch.Tensor, view_size: int, x, y) -> torch.Tensor:
    """`(B,)` bool: world cell `(x, y)` lies inside the view window."""
    return relative_coords(agent_pos, agent_dir, view_size, x, y)[2]


def agent_sees(state: EnvState, config: EnvConfig, x, y) -> torch.Tensor:
    """`(B,)` bool: the agent observes world cell `(x, y)`: it is in the
    view window and the observation shows its object type there."""
    from minigrid_tpu_torch.core.grid import get_cell
    from minigrid_tpu_torch.core.obs import gen_obs_image

    v = config.agent_view_size
    vx, vy, valid = relative_coords(state.agent_pos, state.agent_dir, v, x, y)
    image = gen_obs_image(state, config)  # (B, V, V, 3), [vx, vy]
    lanes = torch.arange(image.shape[0], device=image.device)
    obs_type = image[lanes, vx.clamp(0, v - 1).long(), vy.clamp(0, v - 1).long(), 0]
    world_type = get_cell(state.grid, x, y)[:, CH_TYPE]
    return valid & (obs_type == world_type)
