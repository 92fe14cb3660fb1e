"""Batched grid painting (counterpart of `minigrid_tpu/core/grid.py`).

A grid batch is a `(B, H, W, 5)` uint8 tensor; a cell is addressed as
`(x, y)` = (column, row), i.e. `grid[:, y, x]`. Every helper returns a
new tensor and leaves its input untouched.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C

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
