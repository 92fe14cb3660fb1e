"""RoomGrid scaffolding (counterpart of the parts of
`minigrid_tpu/envs/roomgrid.py` that the packed generators use).

A `num_rows × num_cols` matrix of `room_size²` rooms sharing wall lines,
with per-room door slots in the order right, down, left, up. The port
has the pieces `generate_packed` draws with (the colour order, the door
slot positions `init_plan`, the neighbour arithmetic) and the `RG`
helpers of the JAX package batched over lanes: `init`, `add_door`,
`room_interior_mask`, `reject_next_to_mask`, `place_in_room`,
`add_object` and `place_agent`, each on a `(B, H, W, 5)` grid with one
key per lane. Slot indices are Python ints; the room indices of
`room_top`, `room_interior_mask`, `place_in_room` and `add_object` are
ints or `(B,)` tensors of one room per lane (ObstructedMaze draws its
ball's corner room per lane). `remove_wall` and `connect_all` come with
the families that need them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core import prng, sampling
from minigrid_tpu_torch.core.state import CH_TYPE, EnvConfig

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


class RG(NamedTuple):
    """A batch of room-grid build states (`B` leading everywhere)."""

    grid: torch.Tensor  # (B, H, W, 5) uint8
    door_pos: torch.Tensor  # (B, R, C, 4, 2) int32, (x, y) per slot
    has_door: torch.Tensor  # (B, R, C, 4) bool
    door_locked: torch.Tensor  # (B, R, C, 4) bool
    locked: torch.Tensor  # (B, R, C) bool: the room owns a locked door
    agent_pos: torch.Tensor  # (B, 2) int32


def room_top(config: EnvConfig, i, j):
    """The top-left corner of room (i = column, j = row); ints, or `(B,)`
    tensors for room indices given per lane."""
    s = config.room_size - 1
    return i * s, j * s


def init(keys: torch.Tensor, config: EnvConfig, base_grid: torch.Tensor) -> RG:
    """Every room's wall outline painted on `base_grid`, the door slots
    drawn (`init_plan`) and the agent at the centre of the middle room."""
    rows, cols, rs = config.num_rows, config.num_cols, config.room_size
    b, dev = keys.shape[0], keys.device
    grid = base_grid
    for j in range(rows):
        for i in range(cols):
            grid = G.wall_rect(grid, *room_top(config, i, j), rs, rs)
    ax = (cols // 2) * (rs - 1) + rs // 2
    ay = (rows // 2) * (rs - 1) + rs // 2
    no = torch.zeros((b, rows, cols, 4), dtype=torch.bool, device=dev)
    return RG(
        grid=grid,
        door_pos=init_plan(keys, config),
        has_door=no,
        door_locked=no.clone(),
        locked=torch.zeros((b, rows, cols), dtype=torch.bool, device=dev),
        agent_pos=torch.tensor([ax, ay], dtype=torch.int32, device=dev).expand(b, 2).clone(),
    )


def add_door(rg: RG, config: EnvConfig, i: int, j: int, k: int, color: torch.Tensor, locked: bool) -> RG:
    """A door of `(B,)` colours in slot k of room (i, j), locked or closed,
    registered on both rooms it joins."""
    pos = rg.door_pos[:, j, i, k]
    state = C.STATE_LOCKED if locked else C.STATE_CLOSED
    z = torch.zeros_like(color)
    cell = torch.stack([torch.full_like(color, C.DOOR), color, torch.full_like(color, state), z, z], dim=1)
    grid = G.set_cell(rg.grid, pos[:, 0], pos[:, 1], cell)
    ni = i + int(C.DIR_TO_VEC[k][0])
    nj = j + int(C.DIR_TO_VEC[k][1])
    has_door, door_locked, room_locked = rg.has_door.clone(), rg.door_locked.clone(), rg.locked.clone()
    has_door[:, j, i, k] = has_door[:, nj, ni, (k + 2) % 4] = True
    door_locked[:, j, i, k] = door_locked[:, nj, ni, (k + 2) % 4] = locked
    room_locked[:, j, i] |= locked
    return rg._replace(grid=grid, has_door=has_door, door_locked=door_locked, locked=room_locked)


def room_interior_mask(config: EnvConfig, i, j, device="cpu") -> torch.Tensor:
    """`(1, H, W)` bool of room (i, j)'s whole rectangle (`place_obj`'s
    window; the free-cell test leaves its walls out), or `(B, H, W)` for
    `(B,)` room indices."""
    rs = config.room_size
    return sampling.rect_mask(config.height, config.width, *room_top(config, i, j), rs, rs, device=device)


def reject_next_to_mask(config: EnvConfig, agent_pos: torch.Tensor) -> torch.Tensor:
    """`(B, H, W)` bool: cells at Manhattan distance 2 or more from each
    lane's agent (`(B, 2)` x, y)."""
    dev = agent_pos.device
    ys = torch.arange(config.height, device=dev)[None, :, None]
    xs = torch.arange(config.width, device=dev)[None, None, :]
    ax = agent_pos[:, 0].reshape(-1, 1, 1)
    ay = agent_pos[:, 1].reshape(-1, 1, 1)
    return (xs - ax).abs() + (ys - ay).abs() >= 2


def place_in_room(rg: RG, config: EnvConfig, keys: torch.Tensor, i, j, cell: torch.Tensor):
    """One `(B, 5)` cell per lane on a free cell of room (i, j) away from
    the agent; `i`, `j` are ints or `(B,)` tensors. Returns `(rg, x, y)`."""
    mask = (
        sampling.free_cell_mask(rg.grid, rg.agent_pos)
        & room_interior_mask(config, i, j, device=rg.grid.device)
        & reject_next_to_mask(config, rg.agent_pos)
    )
    x, y = sampling.sample_cell(keys, mask)
    return rg._replace(grid=G.set_cell(rg.grid, x, y, cell)), x, y


def add_object(
    rg: RG,
    config: EnvConfig,
    keys: torch.Tensor,
    i,
    j,
    kind: Optional[int] = None,
    color: Optional[torch.Tensor] = None,
):
    """An object in room (i, j) (ints or `(B,)` tensors): of a random kind
    among key, ball and box and of a random colour, where `kind` (an int)
    and `color` (`(B,)`) are not given. Returns `(rg, type, color, x, y)`, `(B,)` int32 each."""
    k_kind, k_color, k_pos = prng.split(keys, 3).unbind(1)
    if kind is None:
        kinds = torch.tensor([C.KEY, C.BALL, C.BOX], dtype=torch.int32, device=keys.device)
        kind_arr = kinds[prng.randint(k_kind, 0, 3).long()]
    else:
        kind_arr = torch.full((keys.shape[0],), kind, dtype=torch.int32, device=keys.device)
    if color is None:
        color = rand_color(k_color)
    z = torch.zeros_like(kind_arr)
    cell = torch.stack([kind_arr, color.to(torch.int32), z, z, z], dim=1)
    rg, x, y = place_in_room(rg, config, k_pos, i, j, cell)
    return rg, kind_arr, color.to(torch.int32), x, y


def place_agent(rg: RG, config: EnvConfig, keys: torch.Tensor, i: int, j: int):
    """The agent on a free cell of room (i, j) with a heading whose front
    cell is empty or a wall, the (position, heading) pair drawn uniformly
    in the `(y·W + x)·4 + d` order. Returns `(rg, dir)`."""
    b, h, w = rg.grid.shape[:3]
    free = sampling.free_cell_mask(rg.grid) & room_interior_mask(config, i, j, device=rg.grid.device)
    t = rg.grid[..., CH_TYPE]
    ok = (t == C.EMPTY) | (t == C.WALL)
    no_col = torch.zeros_like(ok[:, :, :1])
    no_row = torch.zeros_like(ok[:, :1, :])
    front_ok = torch.stack(
        [
            torch.cat([ok[:, :, 1:], no_col], 2),  # right
            torch.cat([ok[:, 1:, :], no_row], 1),  # down
            torch.cat([no_col, ok[:, :, :-1]], 2),  # left
            torch.cat([no_row, ok[:, :-1, :]], 1),  # up
        ],
        dim=-1,
    )
    idx = sampling.sample_flat(keys, (free[..., None] & front_ok).reshape(b, h * w * 4))
    x = ((idx // 4) % w).to(torch.int32)
    y = (idx // (4 * w)).to(torch.int32)
    return rg._replace(agent_pos=torch.stack([x, y], dim=1)), (idx % 4).to(torch.int32)
