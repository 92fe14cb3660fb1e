"""Environment state and static configuration (counterpart of
`minigrid_tpu/core/state.py`).

`EnvConfig` has the JAX package's frozen fields, so
`EnvConfig(**dataclasses.asdict(jax_config))` carries a configuration
across. `EnvState` is a dataclass of tensors that all share a leading
batch dimension `B`; the grid is `(B, H, W, 5)` uint8 with channels
`(type, color, state, contains_type, contains_color)`.

The rng leaf is `(B, 2)` int64 holding the two uint32 words of a
`jax.random` key (values in `[0, 2**32)`): torch has no full-featured
uint32, and int64 keeps Threefry's wrapping arithmetic simple
(`core/prng.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from minigrid_tpu_torch.core import constants as C

CH_TYPE = 0
CH_COLOR = 1
CH_STATE = 2
CH_CONT_TYPE = 3
CH_CONT_COLOR = 4
NUM_CHANNELS = 5

MISSION_LEN = 8  # (template_id, slot0..slot6) int32
AUX_LEN = 24  # per-family extras


class Actions:
    """The 7-action vocabulary."""

    left = 0
    right = 1
    forward = 2
    pickup = 3
    drop = 4
    toggle = 5
    done = 6


@dataclasses.dataclass(frozen=True)
class EnvState:
    """A batch of environment states; every leaf has a leading `B`."""

    grid: torch.Tensor  # (B, H, W, 5) uint8
    agent_pos: torch.Tensor  # (B, 2) int32 — (x, y)
    agent_dir: torch.Tensor  # (B,) int32 — 0=right 1=down 2=left 3=up
    carrying: torch.Tensor  # (B, 4) uint8 — (type, color, cont_type, cont_color)
    step_count: torch.Tensor  # (B,) int32
    rng: torch.Tensor  # (B, 2) int64 — uint32 key words
    mission: torch.Tensor  # (B, MISSION_LEN) int32
    aux: torch.Tensor  # (B, AUX_LEN) int32

    def replace(self, **changes) -> "EnvState":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static environment configuration (same fields as the JAX package's)."""

    family: str
    width: int
    height: int
    max_steps: int
    agent_view_size: int = 7
    see_through_walls: bool = False
    num_actions: int = 7

    agent_start_pos: Optional[Tuple[int, int]] = None
    agent_start_dir: Optional[int] = None
    num_objs: Optional[int] = None
    n_obstacles: Optional[int] = None
    num_crossings: Optional[int] = None
    obstacle_type: Optional[str] = None
    strip2_row: Optional[int] = None
    room_size: Optional[int] = None
    num_rows: Optional[int] = None
    num_cols: Optional[int] = None
    min_num_rooms: Optional[int] = None
    max_num_rooms: Optional[int] = None
    max_room_size: Optional[int] = None
    random_length: Optional[bool] = None
    num_distractors: Optional[int] = None
    extras: Tuple[Any, ...] = ()


def empty_state(config: EnvConfig, rng: torch.Tensor) -> EnvState:
    """An all-empty batch of states on `rng.device`, one per row of the
    `(B, 2)` key tensor `rng`."""
    b, device = rng.shape[0], rng.device
    grid = torch.zeros(
        (b, config.height, config.width, NUM_CHANNELS), dtype=torch.uint8, device=device
    )
    grid[..., CH_TYPE] = C.EMPTY
    i32 = dict(dtype=torch.int32, device=device)
    return EnvState(
        grid=grid,
        agent_pos=torch.zeros((b, 2), **i32),
        agent_dir=torch.zeros((b,), **i32),
        carrying=torch.zeros((b, 4), dtype=torch.uint8, device=device),
        step_count=torch.zeros((b,), **i32),
        rng=rng,
        mission=torch.zeros((b, MISSION_LEN), **i32),
        aux=torch.zeros((b, AUX_LEN), **i32),
    )
