"""Rendering: tile-atlas rasterizer for RGB observations and frames
(counterpart of `minigrid_tpu/render/`)."""

from minigrid_tpu_torch.render.atlas import TileAtlas, atlas_tensor, get_atlas
from minigrid_tpu_torch.render.render import (
    render_grid,
    render_obs_image,
    render_state,
)

__all__ = [
    "TileAtlas",
    "atlas_tensor",
    "get_atlas",
    "render_grid",
    "render_obs_image",
    "render_state",
]
