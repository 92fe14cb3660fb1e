"""RGB rendering by atlas gather (counterpart of
`minigrid_tpu/render/render.py`), batched over a leading B.

A frame is an integer tile id per cell (pure arithmetic on the grid
channels), a gather from the constant atlas (`render/atlas.py`), a
transpose-reshape into an image, and the highlight mask's alpha blend,
in the JAX package's f32 operations and order: `tiles · 0.7 + 76.5`, two
roundings, then a clamp to [0, 255] and truncation to uint8.
"""

from __future__ import annotations

from typing import Optional

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core.grid import decode, jax_index
from minigrid_tpu_torch.core.obs import gen_obs_grid
from minigrid_tpu_torch.core.state import CH_COLOR, CH_STATE, CH_TYPE, EnvConfig, EnvState
from minigrid_tpu_torch.core.view import dir_vec
from minigrid_tpu_torch.render.atlas import NUM_TILES, atlas_tensor, tile_id

HIGHLIGHT_ALPHA = 0.30


def render_grid(
    grid: torch.Tensor,
    tile_size: int = C.TILE_PIXELS,
    agent_pos: Optional[torch.Tensor] = None,
    agent_dir: Optional[torch.Tensor] = None,
    highlight_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Render `(B, H, W, 5)` grids to `(B, H·ts, W·ts, 3)` uint8 images,
    each lane's agent (`(B, 2)` positions, `(B,)` headings) drawn on its
    cell and its `(B, H, W)` highlight mask blended in.

    Indices follow the JAX package's: an agent position off the grid
    (after a negative one counts from the end) draws no agent, and a tile
    id off the atlas clamps to its ends, as the gather does."""
    b, h, w = grid.shape[:3]
    dev = grid.device
    atlas = atlas_tensor(tile_size, dev)

    t = grid[..., CH_TYPE].to(torch.int32)
    c = grid[..., CH_COLOR].to(torch.int32)
    s = grid[..., CH_STATE].to(torch.int32)

    agent_code = torch.zeros((b, h, w), dtype=torch.int32, device=dev)
    if agent_pos is not None and agent_dir is not None:
        ax = jax_index(agent_pos[:, 0].to(torch.int32), w)[:, None, None]
        ay = jax_index(agent_pos[:, 1].to(torch.int32), h)[:, None, None]
        here = (torch.arange(w, device=dev)[None, None, :] == ax) & (torch.arange(h, device=dev)[None, :, None] == ay)
        code = (1 + agent_dir.to(torch.int32))[:, None, None]
        agent_code = torch.where(here, code, agent_code)

    tid = jax_index(tile_id(t, c, s, agent_code), NUM_TILES).clamp(0, NUM_TILES - 1)
    tiles = atlas[tid.long()]  # (B, H, W, ts, ts, 3)

    if highlight_mask is not None:
        hl = highlight_mask[:, :, :, None, None, None]
        blended = tiles.float() * (1 - HIGHLIGHT_ALPHA) + 255.0 * HIGHLIGHT_ALPHA
        tiles = torch.where(hl, blended.clamp(0, 255).to(torch.uint8), tiles)

    return tiles.permute(0, 1, 3, 2, 4, 5).reshape(b, h * tile_size, w * tile_size, 3)


def _view_highlight_mask(state: EnvState, config: EnvConfig) -> torch.Tensor:
    """`(B, H, W)` world-frame mask of the visible view cells
    (`MiniGridEnv.render`'s highlight). View cell (x=i, y=j) lies at world
    `top_left - f·j + r·i`, its position clamped onto the grid; a cell
    that two view cells reach is lit if either is (an OR, as the JAX
    package's sequential updates give)."""
    v, h, w = config.agent_view_size, config.height, config.width
    b, dev = state.grid.shape[0], state.grid.device
    _, vis_mask = gen_obs_grid(state, config)  # (B, V, V), [row, col] = [j, i]

    f = dir_vec(state.agent_dir)
    r = torch.stack([-f[:, 1], f[:, 0]], dim=1)
    top_left = state.agent_pos + f * (v - 1) - r * (v // 2)
    j = torch.arange(v, dtype=torch.int32, device=dev)[None, :, None]
    i = torch.arange(v, dtype=torch.int32, device=dev)[None, None, :]

    def col(x):
        return x[:, None, None]

    px = col(top_left[:, 0]) - col(f[:, 0]) * j + col(r[:, 0]) * i  # (B, V, V)
    py = col(top_left[:, 1]) - col(f[:, 1]) * j + col(r[:, 1]) * i
    ok = vis_mask & (px >= 0) & (px < w) & (py >= 0) & (py < h)
    idx = (py.clamp(0, h - 1) * w + px.clamp(0, w - 1)).long().reshape(b, v * v)
    hits = torch.zeros((b, h * w), dtype=torch.int32, device=dev)
    hits.scatter_add_(1, idx, ok.reshape(b, v * v).to(torch.int32))
    return (hits > 0).reshape(b, h, w)


def render_state(
    state: EnvState,
    config: EnvConfig,
    tile_size: int = C.TILE_PIXELS,
    highlight: bool = True,
) -> torch.Tensor:
    """Full-frame renders with the agents and their view highlights
    (`MiniGridEnv.render('rgb_array')`): `(B, H·ts, W·ts, 3)` uint8."""
    hl = _view_highlight_mask(state, config) if highlight else None
    return render_grid(
        state.grid,
        tile_size=tile_size,
        agent_pos=state.agent_pos,
        agent_dir=state.agent_dir,
        highlight_mask=hl,
    )


def render_obs_image(
    obs_image: torch.Tensor,
    tile_size: int = C.TILE_PIXELS // 2,
) -> torch.Tensor:
    """Render encoded `(B, V, V, 3)` partial observations (`get_obs_render`):
    the agent at the bottom centre facing up, invisible cells dark, visible
    cells highlighted. `(B, V·ts, V·ts, 3)` uint8."""
    grid, vis_mask = decode(obs_image)
    b, v = grid.shape[0], grid.shape[1]
    dev = grid.device
    return render_grid(
        grid,
        tile_size=tile_size,
        agent_pos=torch.tensor([v // 2, v - 1], dtype=torch.int32, device=dev).expand(b, 2),
        agent_dir=torch.full((b,), 3, dtype=torch.int32, device=dev),
        highlight_mask=vis_mask,
    )
