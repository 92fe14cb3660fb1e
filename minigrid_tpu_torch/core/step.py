"""The base transition (counterpart of `minigrid_tpu/core/step.py`), on a
batched `EnvState`.

The reference's `MiniGridEnv.step` branches over the action; here every
action's outcome is computed for every lane and selected by the action.
Every grid change of the base transition touches only the forward cell
(pickup clears it, drop fills it, toggle rewrites it), so the grid update
is one `(B, 5)` cell select and one masked write. Timeouts stay apart from
termination (`truncated`), as gymnasium has them.

This is the per-env path, independent of the packed rollout's
`ops/fused_rollout.py::step_core`; the tests and the chip run hold the
rollout kernel against it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core.state import (
    CH_COLOR, CH_CONT_COLOR, CH_CONT_TYPE, CH_STATE, CH_TYPE, Actions, EnvConfig, EnvState,
)
from minigrid_tpu_torch.core.view import dir_vec


class StepResult(NamedTuple):
    state: EnvState
    reward: torch.Tensor  # (B,) float32
    terminated: torch.Tensor  # (B,) bool
    truncated: torch.Tensor  # (B,) bool


def success_reward(step_count: torch.Tensor, max_steps: int) -> torch.Tensor:
    """`1 - 0.9 · t / T` in f32, one operation at a time in the reference's
    order. The divisor is a tensor: PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal, which is not correctly rounded."""
    t = step_count.to(torch.float32)
    return 1.0 - 0.9 * (t / torch.full_like(t, float(max_steps)))


def as_actions(state: EnvState, action) -> torch.Tensor:
    """`action` (a number or a `(B,)` tensor) as the `(B,)` int32 tensor on
    the state's device that every transition takes."""
    return torch.as_tensor(action, device=state.grid.device).to(torch.int32).expand(state.step_count.shape)


def base_step(state: EnvState, action: torch.Tensor, config: EnvConfig) -> StepResult:
    """One transition of every lane under its `(B,)` int32 action
    (`as_actions`)."""
    a = action
    step_count = state.step_count + 1
    u8 = dict(dtype=torch.uint8, device=state.grid.device)

    fwd = state.agent_pos + dir_vec(state.agent_dir)
    fx, fy = fwd[:, 0], fwd[:, 1]
    cell = G.get_cell(state.grid, fx, fy)  # (B, 5) uint8
    ft = cell[:, CH_TYPE].to(torch.int32)
    fc = cell[:, CH_COLOR]
    fs = cell[:, CH_STATE].to(torch.int32)

    is_left, is_right, is_fwd = a == Actions.left, a == Actions.right, a == Actions.forward
    is_pickup, is_drop, is_toggle = a == Actions.pickup, a == Actions.drop, a == Actions.toggle

    # Turns and the forward move.
    agent_dir = (state.agent_dir + is_right.to(torch.int32) - is_left.to(torch.int32)) % 4
    moves = is_fwd & G.can_overlap_mask(cell)
    agent_pos = torch.where(moves[:, None], fwd, state.agent_pos)
    hit_goal = is_fwd & (ft == C.GOAL)
    terminated = hit_goal | (is_fwd & (ft == C.LAVA))
    success = success_reward(step_count, config.max_steps)
    reward = torch.where(hit_goal, success, torch.zeros_like(success))

    # Pickup and drop.
    carrying = state.carrying
    hands_empty = carrying[:, 0] == 0
    do_pickup = is_pickup & G.type_in(ft, C.PICKUP_TYPES) & hands_empty
    do_drop = is_drop & (ft == C.EMPTY) & ~hands_empty
    picked = cell[:, [CH_TYPE, CH_COLOR, CH_CONT_TYPE, CH_CONT_COLOR]]
    zero = torch.zeros_like(carrying[:, 0])
    dropped = torch.stack([carrying[:, 0], carrying[:, 1], zero, carrying[:, 2], carrying[:, 3]], dim=1)
    new_carrying = torch.where(do_pickup[:, None], picked, carrying)
    new_carrying = torch.where(do_drop[:, None], torch.zeros_like(new_carrying), new_carrying)

    # Toggle. A locked door opens iff the agent holds the key of its
    # colour; otherwise open <-> closed. A box turns into its contents.
    has_key = (carrying[:, 0] == C.KEY) & (carrying[:, 1] == fc)
    door_state = torch.where(
        fs == C.STATE_LOCKED,
        torch.where(has_key, torch.full_like(fs, C.STATE_OPEN), torch.full_like(fs, C.STATE_LOCKED)),
        1 - fs,
    ).to(torch.uint8)
    toggled_door = cell.clone()
    toggled_door[:, CH_STATE] = door_state
    ctype = cell[:, CH_CONT_TYPE]
    toggled_box = torch.stack(
        [torch.where(ctype > 0, ctype, torch.full_like(ctype, C.EMPTY)), cell[:, CH_CONT_COLOR], zero, zero, zero],
        dim=1,
    )

    # The one forward-cell write.
    empty = torch.tensor((C.EMPTY, 0, 0, 0, 0), **u8)
    new_cell = torch.where(do_pickup[:, None], empty, cell)
    new_cell = torch.where(do_drop[:, None], dropped, new_cell)
    new_cell = torch.where((is_toggle & (ft == C.DOOR))[:, None], toggled_door, new_cell)
    new_cell = torch.where((is_toggle & (ft == C.BOX))[:, None], toggled_box, new_cell)
    # As the JAX package's scatter: a negative coordinate counts from the
    # end, and a write still off the grid is dropped.
    h, w = state.grid.shape[1:3]
    grid = G.set_cell(state.grid, G.jax_index(fx, w), G.jax_index(fy, h), new_cell)

    new_state = state.replace(
        grid=grid, agent_pos=agent_pos, agent_dir=agent_dir, carrying=new_carrying, step_count=step_count
    )
    return StepResult(new_state, reward, terminated, step_count >= config.max_steps)
