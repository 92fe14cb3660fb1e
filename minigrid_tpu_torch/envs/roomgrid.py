"""RoomGrid scaffolding (counterpart of the parts of
`minigrid_tpu/envs/roomgrid.py` that the packed generators use).

A `num_rows × num_cols` matrix of `room_size²` rooms sharing wall lines,
with per-room door slots in the order right, down, left, up. The port
has the pieces `generate_packed` draws with: the colour order, the door
slot positions (`init_plan`) and the neighbour arithmetic. The scalar
`RG` helpers (`init`, `add_door`, `add_object`, `place_agent`,
`connect_all`) come with the RoomGrid families that need them.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import prng
from minigrid_tpu_torch.core.state import EnvConfig

# _rand_color draws uniformly from the sorted colour names.
COLOR_ORDER = tuple(C.COLOR_TO_IDX[name] for name in C.COLOR_NAMES)

# Door slot order; slot k's wall direction vector is DIR_TO_VEC[k].
RIGHT, DOWN, LEFT, UP = 0, 1, 2, 3


def rand_color(keys: torch.Tensor) -> torch.Tensor:
    """A uniform colour id per key, in the sorted-name order: `(B,)` int32."""
    order = torch.tensor(COLOR_ORDER, dtype=torch.int32, device=keys.device)
    return order[prng.randint(keys, 0, 6).long()]


def init_plan(keys: torch.Tensor, config: EnvConfig) -> torch.Tensor:
    """The random door-slot positions of `init`: `(B, R, C, 4, 2)` int32
    `(x, y)` per slot. Per lane, `split(key, R·C·2)` gives room `(i, j)`
    the keys `2·(j·C + i)` (right wall) and `+1` (down wall); left and up
    slots alias the neighbour's right and down slots; a slot without a
    wall stays (0, 0)."""
    rows, cols, rs = config.num_rows, config.num_cols, config.room_size
    b, dev = keys.shape[0], keys.device
    ks = prng.split(keys, rows * cols * 2).reshape(b, rows, cols, 2, 2)
    top_x = torch.arange(cols, device=dev)[None, :] * (rs - 1)  # (1, C)
    top_y = torch.arange(rows, device=dev)[:, None] * (rs - 1)  # (R, 1)
    ry = prng.randint(ks[:, :, :, 0], top_y + 1, top_y + rs - 1)  # (B, R, C)
    dx = prng.randint(ks[:, :, :, 1], top_x + 1, top_x + rs - 1)
    pos = torch.zeros((b, rows, cols, 4, 2), dtype=torch.int32, device=dev)
    pos[:, :, : cols - 1, RIGHT, 0] = (top_x + rs - 1).to(torch.int32)[:, : cols - 1]
    pos[:, :, : cols - 1, RIGHT, 1] = ry[:, :, : cols - 1]
    pos[:, : rows - 1, :, DOWN, 0] = dx[:, : rows - 1]
    pos[:, : rows - 1, :, DOWN, 1] = (top_y + rs - 1).to(torch.int32)[: rows - 1]
    pos[:, :, 1:, LEFT] = pos[:, :, :-1, RIGHT]
    pos[:, 1:, :, UP] = pos[:, :-1, :, DOWN]
    return pos


def neighbor_exists(rows: int, cols: int, i, j, k) -> torch.Tensor:
    """Whether room (i, j) has a neighbour across wall slot k (tensors of
    one shape); JAX's `neighbor_exists(config, i, j, k)` with the config's
    `num_rows` and `num_cols`."""
    return ((k == RIGHT) & (i < cols - 1)) | ((k == DOWN) & (j < rows - 1)) | ((k == LEFT) & (i > 0)) | (
        (k == UP) & (j > 0)
    )


def _neighbor_idx(i, j, k):
    """The room across wall slot k of room (i, j): `(i + dx[k], j + dy[k])`
    for `DIR_TO_VEC[k]`, which may lie off the grid."""
    dx = (k == RIGHT).to(i.dtype) - (k == LEFT).to(i.dtype)
    dy = (k == DOWN).to(i.dtype) - (k == UP).to(i.dtype)
    return i + dx, j + dy
