"""Lava and wall crossings (counterpart of `minigrid_tpu/envs/crossing.py`).

`num_crossings` rivers of lava (or walls where `obstacle_type` is "wall")
fill whole interior rows or columns, chosen among the even positions
`2, 4, ..., size-3` of both axes by `permutation(key, 2K)[:n]`; one
opening per river lies on a random monotone room-to-room path from the
top-left room to the goal's, at `(size-2, size-2)`. The agent starts at
`(1, 1)` facing right. The base transition.

As in the JAX package: the rivers' coordinates are sorted and padded with
`size - 1` into `limits_v`/`limits_h`, so a room index gathers its bounds
per lane; the path's horizontal and vertical moves are `permute(key,
arange(n) < nv)`; and each of the `n` steps reduces its one key over two
spans (the horizontal move's row, the vertical move's column) and keeps
the one its move takes.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core import prng
from minigrid_tpu_torch.core.state import EnvConfig, EnvState, empty_state
from minigrid_tpu_torch.envs.lavagap import fixed_agent, obstacle


def generate(keys: torch.Tensor, config: EnvConfig) -> EnvState:
    """One state per row of the `(B, 2)` key tensor."""
    key, k_reset = prng.split(keys, 2).unbind(1)
    state = empty_state(config, rng=k_reset)
    size, n = config.width, config.num_crossings
    assert size % 2 == 1
    b, dev = keys.shape[0], keys.device
    grid = G.wall_rect(state.grid, 0, 0, size, size)
    grid = G.set_cell(grid, size - 2, size - 2, (C.GOAL, C.GREEN, 0, 0, 0))
    cell, mission = obstacle(config)

    # Candidates: the first K vertical (columns), the next K horizontal (rows).
    cand = torch.arange(2, size - 2, 2, dtype=torch.int64, device=dev)
    k_cand = cand.numel()
    assert n <= 2 * k_cand
    all_pos = torch.cat([cand, cand])
    all_isv = torch.cat([torch.ones(k_cand, dtype=torch.int64, device=dev),
                         torch.zeros(k_cand, dtype=torch.int64, device=dev)])

    ks = prng.split(key, 3 + n)
    perm = prng.permutation(ks[:, 0], 2 * k_cand)[:, :n]  # (B, n)
    sel_pos, sel_isv = all_pos[perm], all_isv[perm]
    nv = sel_isv.sum(dim=1, keepdim=True)

    zeros = torch.zeros((b, size), dtype=torch.int64, device=dev)
    col_sel = zeros.scatter_add(1, sel_pos, sel_isv) > 0
    row_sel = zeros.scatter_add(1, sel_pos, 1 - sel_isv) > 0
    idx = torch.arange(size, device=dev)
    interior = (idx >= 1) & (idx < size - 1)
    river = (col_sel[:, None, :] | row_sel[:, :, None]) & interior[None, :, None] & interior[None, None, :]
    grid = torch.where(river[..., None], torch.tensor(cell, dtype=torch.uint8, device=dev), grid)

    big = size - 1
    pad = torch.full((b, n), big, dtype=torch.int64, device=dev)
    rivers_v = torch.where(sel_isv == 1, sel_pos, pad).sort(dim=1).values
    rivers_h = torch.where(sel_isv == 0, sel_pos, pad).sort(dim=1).values
    edge0 = torch.zeros((b, 1), dtype=torch.int64, device=dev)
    edge1 = torch.full((b, 1), big, dtype=torch.int64, device=dev)
    limits_v = torch.cat([edge0, rivers_v, edge1], dim=1)
    limits_h = torch.cat([edge0, rivers_h, edge1], dim=1)

    path_is_h = prng.permute(ks[:, 1], (torch.arange(n, device=dev) < nv).to(torch.int64))
    room_i = torch.zeros((b, 1), dtype=torch.int64, device=dev)
    room_j = torch.zeros((b, 1), dtype=torch.int64, device=dev)

    def limit(limits, i):
        return limits.gather(1, i)[:, 0]

    for t in range(n):
        is_h = path_is_h[:, t : t + 1]
        higher, lower = prng.randint_bits(ks[:, 3 + t])
        xh = limit(limits_v, room_i + 1)
        yh = prng.randint_from_bits(higher, lower, limit(limits_h, room_j) + 1, limit(limits_h, room_j + 1))
        xv = prng.randint_from_bits(higher, lower, limit(limits_v, room_i) + 1, limit(limits_v, room_i + 1))
        yv = limit(limits_h, room_j + 1)
        h_move = is_h[:, 0] == 1
        gx = torch.where(h_move, xh.to(torch.int32), xv)
        gy = torch.where(h_move, yh, yv.to(torch.int32))
        grid = G.set_cell(grid, gx, gy, G.EMPTY_CELL)
        room_i = room_i + is_h
        room_j = room_j + (1 - is_h)
    return fixed_agent(state, grid, mission)
