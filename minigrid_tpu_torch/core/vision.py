"""Occlusion (counterpart of `minigrid_tpu/core/vision.py`).

The reference's `Grid.process_vis` seeds the agent's cell, then for each
view row from the bottom up runs a left-to-right pass and a right-to-left
pass in which every visible cell that lets light through lights its
lateral neighbour in scan direction and the cells above. Within one pass
the lateral spread is a monotone flood along the row, so a pass is at most
V - 1 shift-OR steps over the whole row, and the seeds of the row above
are shift/OR combinations of the lit, transparent cells:

  L->R (visits i in [0, V-2]): row = flood_right(row); qL = row & trans,
      lane V-1 cleared; seeds up at {i, i+1}: qL | shift_right(qL)
  R->L (visits i in [1, V-1]): row = flood_left(row); qR = row & trans,
      lane 0 cleared; seeds up at {i-1, i}: qR | shift_left(qR)

Every step is boolean algebra on `(B, V)` rows.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core.grid import see_behind_mask


def _shift_right(x: torch.Tensor) -> torch.Tensor:
    """`[0, x0, ..., x_{n-2}]` along the last dimension."""
    return torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]], dim=-1)


def _shift_left(x: torch.Tensor) -> torch.Tensor:
    """`[x1, ..., x_{n-1}, 0]` along the last dimension."""
    return torch.cat([x[..., 1:], torch.zeros_like(x[..., :1])], dim=-1)


def _flood(row: torch.Tensor, trans: torch.Tensor, shift) -> torch.Tensor:
    """Converge `row[i + d] |= row[i] & trans[i]` (d the shift's direction)."""
    for _ in range(row.shape[-1] - 1):
        row = row | shift(row & trans)
    return row


def process_vis(view_grid: torch.Tensor) -> torch.Tensor:
    """`(B, V, V)` bool visibility of `(B, V, V, 5)` egocentric views, the
    agent at row V-1, column V//2, facing row 0."""
    v = view_grid.shape[-3]
    trans = see_behind_mask(view_grid)  # (B, V, V)
    carry = torch.zeros(trans.shape[:-2] + (v,), dtype=torch.bool, device=view_grid.device)
    rows = []
    for j in range(v - 1, -1, -1):
        seed = carry
        if j == v - 1:
            seed = seed.clone()
            seed[..., v // 2] = True
        trow = trans[..., j, :]
        row = _flood(seed, trow, _shift_right)
        q_l = row & trow
        q_l[..., v - 1] = False
        row = _flood(row, trow, _shift_left)
        q_r = row & trow
        q_r[..., 0] = False
        carry = q_l | _shift_right(q_l) | q_r | _shift_left(q_r)
        rows.append(row)
    rows.reverse()
    return torch.stack(rows, dim=-2)
