"""The egocentric observation (counterpart of `minigrid_tpu/core/obs.py`).

The reference crops a window around the agent, fills cells off the grid
with walls, rotates it so the agent faces up from the bottom centre, masks
what the agent cannot see, overlays what it carries on its own cell and
encodes `(V, V, 3)` bytes. Here the crop and the rotation are one gather:
view cell (row, col) lies at world

    agent_pos + f·(V - 1 - row) + r·(col - V // 2)

(f the heading, r its right-perpendicular), read by its index from the
flattened grid, so no float is on the path. Batched over a leading B.
"""

from __future__ import annotations

from typing import Tuple

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core.grid import WALL_CELL, encode
from minigrid_tpu_torch.core.state import NUM_CHANNELS, EnvConfig, EnvState
from minigrid_tpu_torch.core.view import dir_vec
from minigrid_tpu_torch.core.vision import process_vis


def gen_obs_grid(state: EnvState, config: EnvConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The egocentric `(B, V, V, 5)` view and its `(B, V, V)` visibility."""
    v, h, w = config.agent_view_size, config.height, config.width
    b, dev = state.grid.shape[0], state.grid.device
    f = dir_vec(state.agent_dir)  # (B, 2)
    r = torch.stack([-f[:, 1], f[:, 0]], dim=1)
    rows = ((v - 1) - torch.arange(v, dtype=torch.int32, device=dev))[None, :, None]  # forward distance
    cols = (torch.arange(v, dtype=torch.int32, device=dev) - v // 2)[None, None, :]  # lateral offset

    def col(t):
        return t[:, None, None]

    wx = col(state.agent_pos[:, 0]) + col(f[:, 0]) * rows + col(r[:, 0]) * cols  # (B, V, V)
    wy = col(state.agent_pos[:, 1]) + col(f[:, 1]) * rows + col(r[:, 1]) * cols
    in_bounds = (wx >= 0) & (wx < w) & (wy >= 0) & (wy < h)
    flat = (wy.clamp(0, h - 1) * w + wx.clamp(0, w - 1)).long().reshape(b, v * v, 1)
    cells = state.grid.reshape(b, h * w, NUM_CHANNELS)
    view = torch.gather(cells, 1, flat.expand(b, v * v, NUM_CHANNELS)).reshape(b, v, v, NUM_CHANNELS)
    wall = torch.tensor(WALL_CELL, dtype=torch.uint8, device=dev)
    view = torch.where(in_bounds[..., None], view, wall)

    if config.see_through_walls:
        vis_mask = torch.ones((b, v, v), dtype=torch.bool, device=dev)
    else:
        vis_mask = process_vis(view)

    # What the agent carries (or nothing) on its own cell.
    c = state.carrying
    held = torch.stack([c[:, 0], c[:, 1], torch.zeros_like(c[:, 0]), c[:, 2], c[:, 3]], dim=1)
    nothing = torch.tensor((C.EMPTY, 0, 0, 0, 0), dtype=torch.uint8, device=dev)
    view[:, v - 1, v // 2] = torch.where((c[:, 0] > 0)[:, None], held, nothing)
    return view, vis_mask


def gen_obs_image(state: EnvState, config: EnvConfig) -> torch.Tensor:
    """The `(B, V, V, 3)` uint8 partial observation, indexed `[x, y]` as
    the reference's encode."""
    view, vis_mask = gen_obs_grid(state, config)
    return encode(view, vis_mask)


def gen_obs(state: EnvState, config: EnvConfig) -> dict:
    """The observation dict: the image, the headings and the missions as
    integer vectors (template id and slots; `envs/missions.py`)."""
    return {
        "image": gen_obs_image(state, config),
        "direction": state.agent_dir,
        "mission": state.mission,
    }
