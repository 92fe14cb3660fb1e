"""Constant tile atlas (counterpart of `minigrid_tpu/render/atlas.py`).

The reference memoizes tile rasters at render time in a Python dict
(`Grid.render_tile`'s `tile_cache`, minigrid.py:~492-540). TPU-native
equivalent: precompute EVERY tile — (object type × color × door-state ×
{no-agent, agent-dir 0..3}) — into one constant uint8 array, so on-device
rendering reduces to an integer tile-id computation plus a gather.

Tile visuals follow the documented WorldObj.render bodies
(minigrid.py:~162-365) and `Grid.render_tile`: 3× supersampled drawing,
grey grid lines on the top/left edges, red agent triangle rotated
`0.5π·dir`, box-mean downsample.

The NumPy build is the JAX package's, byte for byte; `atlas_tensor`
keeps one uint8 tensor of it per tile size and device for the renderer's
gather.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.render import draw

SUBDIVS = 3
AGENT_NONE = 0  # agent_code: 0 = no agent, 1+dir = agent facing dir
NUM_AGENT_CODES = 5
NUM_TILES = C.NUM_OBJECTS * C.NUM_COLORS * C.NUM_STATES * NUM_AGENT_CODES


def tile_id(type_idx, color_idx, state_idx, agent_code=0):
    """Flat atlas index; works elementwise on arrays."""
    return ((type_idx * C.NUM_COLORS + color_idx) * C.NUM_STATES + state_idx) * (
        NUM_AGENT_CODES
    ) + agent_code


def _render_object(img: np.ndarray, type_idx: int, color_idx: int, state_idx: int):
    """Draw one object into a supersampled tile (WorldObj.render bodies)."""
    color = C.COLOR_PALETTE[color_idx]
    if type_idx == C.WALL:
        draw.fill_coords(img, draw.point_in_rect(0, 1, 0, 1), color)
    elif type_idx == C.FLOOR:
        # Dark version of the color over the non-gridline area.
        draw.fill_coords(img, draw.point_in_rect(0.031, 1, 0.031, 1), color // 2)
    elif type_idx == C.GOAL:
        draw.fill_coords(img, draw.point_in_rect(0, 1, 0, 1), color)
    elif type_idx == C.LAVA:
        orange = (255, 128, 0)
        draw.fill_coords(img, draw.point_in_rect(0, 1, 0, 1), orange)
        for i in range(3):
            ylo = 0.3 + 0.2 * i
            yhi = 0.4 + 0.2 * i
            for x0, y0, x1, y1 in (
                (0.1, ylo, 0.3, yhi),
                (0.3, yhi, 0.5, ylo),
                (0.5, ylo, 0.7, yhi),
                (0.7, yhi, 0.9, ylo),
            ):
                draw.fill_coords(
                    img, draw.point_in_line(x0, y0, x1, y1, r=0.03), (0, 0, 0)
                )
    elif type_idx == C.DOOR:
        if state_idx == C.STATE_OPEN:
            draw.fill_coords(img, draw.point_in_rect(0.88, 1.00, 0.00, 1.00), color)
            draw.fill_coords(img, draw.point_in_rect(0.92, 0.96, 0.04, 0.96), (0, 0, 0))
        elif state_idx == C.STATE_LOCKED:
            draw.fill_coords(img, draw.point_in_rect(0.00, 1.00, 0.00, 1.00), color)
            draw.fill_coords(
                img, draw.point_in_rect(0.06, 0.94, 0.06, 0.94),
                (0.45 * color.astype(np.float64)).astype(np.uint8),
            )
            draw.fill_coords(img, draw.point_in_rect(0.52, 0.75, 0.50, 0.56), color)
        else:  # closed
            draw.fill_coords(img, draw.point_in_rect(0.00, 1.00, 0.00, 1.00), color)
            draw.fill_coords(img, draw.point_in_rect(0.04, 0.96, 0.04, 0.96), (0, 0, 0))
            draw.fill_coords(img, draw.point_in_rect(0.08, 0.92, 0.08, 0.92), color)
            draw.fill_coords(img, draw.point_in_rect(0.12, 0.88, 0.12, 0.88), (0, 0, 0))
            draw.fill_coords(img, draw.point_in_circle(cx=0.75, cy=0.50, r=0.08), color)
    elif type_idx == C.KEY:
        draw.fill_coords(img, draw.point_in_rect(0.50, 0.63, 0.31, 0.88), color)
        draw.fill_coords(img, draw.point_in_rect(0.38, 0.50, 0.59, 0.66), color)
        draw.fill_coords(img, draw.point_in_rect(0.38, 0.50, 0.81, 0.88), color)
        draw.fill_coords(img, draw.point_in_circle(cx=0.56, cy=0.28, r=0.190), color)
        draw.fill_coords(img, draw.point_in_circle(cx=0.56, cy=0.28, r=0.064), (0, 0, 0))
    elif type_idx == C.BALL:
        draw.fill_coords(img, draw.point_in_circle(0.5, 0.5, 0.31), color)
    elif type_idx == C.BOX:
        draw.fill_coords(img, draw.point_in_rect(0.12, 0.88, 0.12, 0.88), color)
        draw.fill_coords(img, draw.point_in_rect(0.18, 0.82, 0.18, 0.82), (0, 0, 0))
        draw.fill_coords(img, draw.point_in_rect(0.16, 0.84, 0.47, 0.53), color)
    # unseen (0), empty (1), agent (10): background only.


class TileAtlas(NamedTuple):
    tile_size: int
    tiles: np.ndarray  # (NUM_TILES, tile_size, tile_size, 3) uint8


@functools.lru_cache(maxsize=None)
def get_atlas(tile_size: int = C.TILE_PIXELS) -> TileAtlas:
    """Build (and cache) the full tile atlas for a tile size."""
    ss = tile_size * SUBDIVS
    tiles = np.zeros((NUM_TILES, tile_size, tile_size, 3), dtype=np.uint8)

    tri = draw.point_in_triangle((0.12, 0.19), (0.87, 0.50), (0.12, 0.81))
    for t in range(C.NUM_OBJECTS):
        for col in range(C.NUM_COLORS):
            for s in range(C.NUM_STATES):
                base = np.zeros((ss, ss, 3), dtype=np.uint8)
                # Grid lines on the top/left edges.
                draw.fill_coords(base, draw.point_in_rect(0, 0.031, 0, 1), (100, 100, 100))
                draw.fill_coords(base, draw.point_in_rect(0, 1, 0, 0.031), (100, 100, 100))
                _render_object(base, t, col, s)
                for agent_code in range(NUM_AGENT_CODES):
                    img = base.copy()
                    if agent_code > 0:
                        theta = 0.5 * math.pi * (agent_code - 1)
                        draw.fill_coords(
                            img, draw.rotate_fn(tri, 0.5, 0.5, theta), (255, 0, 0)
                        )
                    tiles[tile_id(t, col, s, agent_code)] = draw.downsample(
                        img, SUBDIVS
                    )
    return TileAtlas(tile_size=tile_size, tiles=tiles)


@functools.lru_cache(maxsize=None)
def atlas_tensor(tile_size: int, device: torch.device) -> torch.Tensor:
    """The atlas's `(NUM_TILES, tile_size, tile_size, 3)` uint8 tiles on
    `device` (cached per tile size and device)."""
    return torch.from_numpy(get_atlas(tile_size).tiles).to(device)
