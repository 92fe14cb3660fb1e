"""Registrations of the ported env ids, in the JAX package's order
(`minigrid_tpu/envs/_register_all.py`): Empty (fixed and random start),
DistShift, LavaGap, FourRooms, DoorKey, Lava and Simple Crossing,
DynamicObstacles, Memory, Fetch, GoToDoor, GoToObject, PutNear,
RedBlueDoors, MultiRoom, LockedRoom, Playground, Unlock, UnlockPickup,
BlockedUnlockPickup, KeyCorridor and ObstructedMaze: all 70 of the JAX
package's ids, each with its configuration."""

from __future__ import annotations

from minigrid_tpu_torch.core.state import EnvConfig
from minigrid_tpu_torch.envs import crossing as _crossing
from minigrid_tpu_torch.envs import distshift as _distshift
from minigrid_tpu_torch.envs import doorkey as _doorkey
from minigrid_tpu_torch.envs import dynamicobstacles as _dynobst
from minigrid_tpu_torch.envs import empty as _empty
from minigrid_tpu_torch.envs import fetch as _fetch
from minigrid_tpu_torch.envs import fourrooms as _fourrooms
from minigrid_tpu_torch.envs import gotodoor as _gotodoor
from minigrid_tpu_torch.envs import gotoobject as _gotoobject
from minigrid_tpu_torch.envs import keycorridor as _keycorridor
from minigrid_tpu_torch.envs import lavagap as _lavagap
from minigrid_tpu_torch.envs import lockedroom as _lockedroom
from minigrid_tpu_torch.envs import memory as _memory
from minigrid_tpu_torch.envs import multiroom as _multiroom
from minigrid_tpu_torch.envs import obstructedmaze as _om
from minigrid_tpu_torch.envs import playground as _playground
from minigrid_tpu_torch.envs import putnear as _putnear
from minigrid_tpu_torch.envs import redbluedoors as _rbd
from minigrid_tpu_torch.envs import unlock as _unlock
from minigrid_tpu_torch.envs import unlockpickup as _unlockpickup
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

for _size in (5, 6):
    register(
        f"MiniGrid-Empty-Random-{_size}x{_size}-v0",
        EnvConfig(
            family="empty",
            width=_size,
            height=_size,
            max_steps=4 * _size * _size,
            see_through_walls=True,
            agent_start_pos=None,
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

for _size in (5, 6, 7):
    register(
        f"MiniGrid-LavaGapS{_size}-v0",
        EnvConfig(family="lavagap", width=_size, height=_size, max_steps=4 * _size * _size, obstacle_type="lava"),
        _lavagap.generate,
    )

register("MiniGrid-FourRooms-v0", EnvConfig(family="fourrooms", width=19, height=19, max_steps=100), _fourrooms.generate)

for _size in (5, 6, 8, 16):
    register(
        f"MiniGrid-DoorKey-{_size}x{_size}-v0",
        EnvConfig(family="doorkey", width=_size, height=_size, max_steps=10 * _size * _size),
        _doorkey.generate,
    )

for _obst, _name in (("lava", "Lava"), ("wall", "Simple")):
    for _size, _n in ((9, 1), (9, 2), (9, 3), (11, 5)):
        register(
            f"MiniGrid-{_name}CrossingS{_size}N{_n}-v0",
            EnvConfig(
                family="crossing",
                width=_size,
                height=_size,
                max_steps=4 * _size * _size,
                num_crossings=_n,
                obstacle_type=_obst,
            ),
            _crossing.generate,
        )

# Three actions; max_steps = 4 * size * size.
for _name, _size, _n, _random in (
    ("5x5", 5, 2, False),
    ("Random-5x5", 5, 2, True),
    ("6x6", 6, 3, False),
    ("Random-6x6", 6, 3, True),
    ("8x8", 8, 4, False),
    ("16x16", 16, 8, False),
):
    register(
        f"MiniGrid-Dynamic-Obstacles-{_name}-v0",
        EnvConfig(
            family="dynamicobstacles",
            width=_size,
            height=_size,
            max_steps=4 * _size * _size,
            num_actions=3,
            n_obstacles=_n,
            agent_start_pos=None if _random else (1, 1),
            agent_start_dir=None if _random else 0,
        ),
        _dynobst.generate,
        _dynobst.TRANSITION,
    )

# max_steps = 5 * size * size.
for _name, _size, _rand in (
    ("S17Random", 17, True),
    ("S13Random", 13, True),
    ("S13", 13, False),
    ("S11", 11, False),
    ("S9", 9, False),
    ("S7", 7, False),
):
    register(
        f"MiniGrid-Memory{_name}-v0",
        EnvConfig(family="memory", width=_size, height=_size, max_steps=5 * _size * _size, random_length=_rand),
        _memory.generate,
        _memory.TRANSITION,
    )

for _size, _n in ((5, 2), (6, 2), (8, 3)):
    register(
        f"MiniGrid-Fetch-{_size}x{_size}-N{_n}-v0",
        EnvConfig(
            family="fetch", width=_size, height=_size, max_steps=5 * _size * _size, see_through_walls=True, num_objs=_n
        ),
        _fetch.generate,
        _fetch.TRANSITION,
    )

for _size in (5, 6, 8):
    register(
        f"MiniGrid-GoToDoor-{_size}x{_size}-v0",
        EnvConfig(family="gotodoor", width=_size, height=_size, max_steps=4 * _size * _size, see_through_walls=True),
        _gotodoor.generate,
        _gotodoor.TRANSITION,
    )

for _size, _n in ((6, 2), (8, 2)):
    register(
        f"MiniGrid-GoToObject-{_size}x{_size}-N{_n}-v0",
        EnvConfig(
            family="gotoobject", width=_size, height=_size, max_steps=5 * _size * _size, see_through_walls=True,
            num_objs=_n,
        ),
        _gotoobject.generate,
        _gotoobject.TRANSITION,
    )

for _size, _n in ((6, 2), (8, 3)):
    register(
        f"MiniGrid-PutNear-{_size}x{_size}-N{_n}-v0",
        EnvConfig(
            family="putnear", width=_size, height=_size, max_steps=5 * _size, see_through_walls=True, num_objs=_n
        ),
        _putnear.generate,
        _putnear.TRANSITION,
    )

# A 2·size × size area.
for _size in (6, 8):
    register(
        f"MiniGrid-RedBlueDoors-{_size}x{_size}-v0",
        EnvConfig(family="redbluedoors", width=2 * _size, height=_size, max_steps=20 * _size * _size),
        _rbd.generate,
        _rbd.TRANSITION,
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

register(
    "MiniGrid-LockedRoom-v0", EnvConfig(family="lockedroom", width=19, height=19, max_steps=10 * 19), _lockedroom.generate
)
register(
    "MiniGrid-Playground-v0", EnvConfig(family="playground", width=19, height=19, max_steps=100), _playground.generate
)

# Two rooms of size 6 side by side: an 11x6 grid.
_RS = 6
_ROOMGRID_1x2 = dict(width=(_RS - 1) * 2 + 1, height=_RS, room_size=_RS, num_rows=1, num_cols=2)
register(
    "MiniGrid-Unlock-v0",
    EnvConfig(family="unlock", max_steps=8 * _RS * _RS, **_ROOMGRID_1x2),
    _unlock.generate,
    _unlock.TRANSITION,
)
register(
    "MiniGrid-UnlockPickup-v0",
    EnvConfig(family="unlockpickup", max_steps=8 * _RS * _RS, **_ROOMGRID_1x2),
    _unlockpickup.generate,
    _unlockpickup.TRANSITION,
)
register(
    "MiniGrid-BlockedUnlockPickup-v0",
    EnvConfig(family="blockedunlockpickup", max_steps=16 * _RS * _RS, extras=("blocked",), **_ROOMGRID_1x2),
    _unlockpickup.generate,
    _unlockpickup.TRANSITION,
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

# A 1×2 or 3×3 grid of rooms of size 6; max_steps = 4 * rooms visited * 6**2.
_OM_RS = 6
for _name, _extras, _visited, _rows, _cols in (
    ("1Dl", ("1D", False, False), 2, 1, 2),
    ("1Dlh", ("1D", True, False), 2, 1, 2),
    ("1Dlhb", ("1D", True, True), 2, 1, 2),
    ("2Dlh", ("full", 2, 1, True, False, 1), 4, 3, 3),
    ("2Dlhb", ("full", 2, 1, True, True, 1), 4, 3, 3),
    ("1Q", ("full", 1, 1, True, True, 1), 5, 3, 3),
    ("2Q", ("full", 1, 1, True, True, 2), 11, 3, 3),
    ("Full", ("full", 1, 1, True, True, 4), 25, 3, 3),
):
    register(
        f"MiniGrid-ObstructedMaze-{_name}-v0",
        EnvConfig(
            family="obstructedmaze",
            width=(_OM_RS - 1) * _cols + 1,
            height=(_OM_RS - 1) * _rows + 1,
            max_steps=4 * _visited * _OM_RS * _OM_RS,
            room_size=_OM_RS,
            num_rows=_rows,
            num_cols=_cols,
            extras=_extras,
        ),
        _om.generate,
        _om.TRANSITION,
    )
