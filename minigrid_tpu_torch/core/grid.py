"""Batched grid operations (counterpart of `minigrid_tpu/core/grid.py`).

A grid batch is a `(B, H, W, 5)` uint8 tensor; a cell is addressed as
`(x, y)` = (column, row), i.e. `grid[:, y, x]`. Every helper returns a
new tensor and leaves its input untouched. `encode` gives the reference's
observation bytes, indexed `[x, y]` (transposed against the storage).
"""

from __future__ import annotations

import torch

from typing import Tuple

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core.state import CH_STATE, CH_TYPE, NUM_CHANNELS

EMPTY_CELL = (C.EMPTY, 0, 0, 0, 0)
WALL_CELL = (C.WALL, C.GREY, 0, 0, 0)


def _cell(cell, grid: torch.Tensor) -> torch.Tensor:
    """A cell as uint8 that broadcasts against `grid`: a `(5,)` constant,
    or a `(B, 5)` tensor of one cell per lane."""
    cell = torch.as_tensor(cell, dtype=torch.uint8, device=grid.device)
    return cell[:, None, None, :] if cell.ndim == 2 else cell


def set_cell(grid: torch.Tensor, x, y, cell) -> torch.Tensor:
    """Write one cell per lane; `x`, `y` are ints or `(B,)` tensors, `cell`
    a `(5,)` constant or a `(B, 5)` tensor."""
    b, h, w = grid.shape[:3]
    dev = grid.device
    xs = torch.as_tensor(x, device=dev).reshape(-1, 1, 1)
    ys = torch.as_tensor(y, device=dev).reshape(-1, 1, 1)
    mask = (torch.arange(h, device=dev)[None, :, None] == ys) & (
        torch.arange(w, device=dev)[None, None, :] == xs
    )
    return torch.where(mask[..., None], _cell(cell, grid), grid)


def horz_wall(grid: torch.Tensor, x: int, y: int, length=None) -> torch.Tensor:
    """Paint a horizontal wall run from `(x, y)`."""
    if length is None:
        length = grid.shape[2] - x
    out = grid.clone()
    out[:, y, x : x + length] = _cell(WALL_CELL, grid)
    return out


def vert_wall(grid: torch.Tensor, x: int, y: int, length=None) -> torch.Tensor:
    """Paint a vertical wall run from `(x, y)`."""
    if length is None:
        length = grid.shape[1] - y
    out = grid.clone()
    out[:, y : y + length, x] = _cell(WALL_CELL, grid)
    return out


def wall_rect(grid: torch.Tensor, x: int, y: int, w: int, h: int) -> torch.Tensor:
    """Paint a rectangular wall outline."""
    grid = horz_wall(grid, x, y, w)
    grid = horz_wall(grid, x, y + h - 1, w)
    grid = vert_wall(grid, x, y, h)
    grid = vert_wall(grid, x + w - 1, y, h)
    return grid


def paint_rect(grid: torch.Tensor, x0, y0, x1, y1, cell) -> torch.Tensor:
    """Fill every cell with `x0 <= x < x1 and y0 <= y < y1` (bounds are
    ints or `(B,)` tensors)."""
    h, w = grid.shape[1:3]
    dev = grid.device

    def col(v):
        return torch.as_tensor(v, device=dev).reshape(-1, 1, 1)

    ys = torch.arange(h, device=dev)[None, :, None]
    xs = torch.arange(w, device=dev)[None, None, :]
    mask = (xs >= col(x0)) & (xs < col(x1)) & (ys >= col(y0)) & (ys < col(y1))
    return torch.where(mask[..., None], _cell(cell, grid), grid)


def jax_index(v, n: int) -> torch.Tensor:
    """Coordinates as the JAX package's indexing reads them: a negative one
    counts from the end (once)."""
    return torch.where(v < 0, v + n, v)


def get_cell(grid: torch.Tensor, x, y) -> torch.Tensor:
    """The `(B, 5)` cell of each lane at `(x, y)` (ints or `(B,)` tensors),
    indexed as the JAX package's gather indexes: a negative coordinate
    counts from the end, and one still off the grid clamps to its edge."""
    b, h, w = grid.shape[:3]
    dev = grid.device
    xs = jax_index(torch.as_tensor(x, device=dev).long(), w).clamp(0, w - 1).expand(b)
    ys = jax_index(torch.as_tensor(y, device=dev).long(), h).clamp(0, h - 1).expand(b)
    return grid[torch.arange(b, device=dev), ys, xs]


def is_empty(cell: torch.Tensor) -> torch.Tensor:
    """True where a cell holds no object (the reference's `None` cell)."""
    return cell[..., CH_TYPE] == C.EMPTY


def encode(grid: torch.Tensor, vis_mask=None) -> torch.Tensor:
    """`(B, H, W, 5)` -> the reference's `(B, W, H, 3)` uint8 observation
    bytes: visible cells keep (type, colour, state), invisible ones read
    `(unseen, 0, 0)`; indexed `[x, y]`."""
    out = grid[..., :3]
    if vis_mask is not None:
        out = torch.where(vis_mask[..., None], out, torch.zeros_like(out))
    return out.transpose(-3, -2).contiguous()


def decode(array: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of `encode`: `(B, W, H, 3)` -> `(grid (B, H, W, 5), vis_mask
    (B, H, W))`; unseen cells decode to empty cells and read invisible."""
    a = torch.as_tensor(array).to(torch.uint8).transpose(-3, -2)
    vis_mask = a[..., CH_TYPE] != C.UNSEEN
    grid = torch.cat([a, torch.zeros(a.shape[:-1] + (NUM_CHANNELS - 3,), dtype=torch.uint8, device=a.device)], -1)
    empty = torch.tensor(EMPTY_CELL, dtype=torch.uint8, device=a.device)
    return torch.where(vis_mask[..., None], grid, empty), vis_mask


def see_behind_mask(grid: torch.Tensor) -> torch.Tensor:
    """`(..., H, W)` bool: True where vision passes through the cell (not
    a wall, not a door that is closed or locked)."""
    t = grid[..., CH_TYPE]
    s = grid[..., CH_STATE]
    return ~((t == C.WALL) | ((t == C.DOOR) & (s != C.STATE_OPEN)))


def type_in(t: torch.Tensor, types) -> torch.Tensor:
    """True where the type ids `t` are among `types`."""
    out = torch.zeros(t.shape, dtype=torch.bool, device=t.device)
    for k in types:
        out = out | (t == k)
    return out


def can_overlap_mask(grid: torch.Tensor) -> torch.Tensor:
    """`(..., H, W)` bool: True where the agent may stand (open doors too)."""
    t = grid[..., CH_TYPE]
    return type_in(t, C.OVERLAP_TYPES) | ((t == C.DOOR) & (grid[..., CH_STATE] == C.STATE_OPEN))
