"""Registrations of the ported env ids, in the JAX package's order
(`minigrid_tpu/envs/_register_all.py`): the static-layout families Empty
and DistShift, MultiRoom and KeyCorridor."""

from __future__ import annotations

from minigrid_tpu_torch.core.state import EnvConfig
from minigrid_tpu_torch.envs import distshift as _distshift
from minigrid_tpu_torch.envs import empty as _empty
from minigrid_tpu_torch.envs import keycorridor as _keycorridor
from minigrid_tpu_torch.envs import multiroom as _multiroom
from minigrid_tpu_torch.envs.registry import register

for _size in (5, 6, 8, 16):
    register(
        f"MiniGrid-Empty-{_size}x{_size}-v0",
        EnvConfig(
            family="empty",
            width=_size,
            height=_size,
            max_steps=4 * _size * _size,
            see_through_walls=True,
            agent_start_pos=(1, 1),
            agent_start_dir=0,
        ),
        _empty.generate,
    )

for _v, _row in ((1, 2), (2, 5)):
    register(
        f"MiniGrid-DistShift{_v}-v0",
        EnvConfig(
            family="distshift",
            width=9,
            height=7,
            max_steps=4 * 9 * 7,
            see_through_walls=True,
            agent_start_pos=(1, 1),
            agent_start_dir=0,
            strip2_row=_row,
        ),
        _distshift.generate,
    )

# A 25x25 grid; max_steps = 20 * max_num_rooms.
for _name, _min, _max, _maxsz in (("N2-S4", 2, 2, 4), ("N4-S5", 4, 4, 5), ("N6", 6, 6, 10)):
    register(
        f"MiniGrid-MultiRoom-{_name}-v0",
        EnvConfig(
            family="multiroom",
            width=25,
            height=25,
            max_steps=_max * 20,
            min_num_rooms=_min,
            max_num_rooms=_max,
            max_room_size=_maxsz,
        ),
        _multiroom.generate,
    )

# Three columns of rooms; max_steps = 30 * room_size**2.
for _rs, _rows in ((3, 1), (3, 2), (3, 3), (4, 3), (5, 3), (6, 3)):
    register(
        f"MiniGrid-KeyCorridorS{_rs}R{_rows}-v0",
        EnvConfig(
            family="keycorridor",
            width=(_rs - 1) * 3 + 1,
            height=(_rs - 1) * _rows + 1,
            max_steps=30 * _rs * _rs,
            room_size=_rs,
            num_rows=_rows,
            num_cols=3,
        ),
        _keycorridor.generate,
        _keycorridor.TRANSITION,
    )
