"""Family hooks of the packed rollout (counterpart of
`minigrid_tpu/ops/packed_hooks.py`).

A family whose `step` overrides the base transition (reward on an event,
an extra termination) runs the base transition and then its hook, which
adjusts `(reward, terminated)`. A hook is elementwise math on `(1, B)`
lane vectors, plus for the door families reads of absolute grid cells;
`step_core` runs it in the plain version, and the CUDA kernels run its
counterpart in `csrc/step_device.cuh`, chosen by the id in
`KERNEL_HOOK_IDS`.

Hooks are keyed by the transition name an `Env` carries. Ported, in the
rollout kernel and the policy kernel: six of the JAX package's nine
post-hooks (`minigrid_tpu/ops/packed_hooks.py::HOOKS`): pickup-target
(KeyCorridor; UnlockPickup and ObstructedMaze share it, but their
generators are not ported), Fetch, GoToDoor, GoToObject, PutNear and
RedBlueDoors. Still to port (ROADMAP.md): the Unlock, Memory and
DynamicObstacles hooks, the DynamicObstacles pre-hook, and the two action
remaps (`ACTION_REMAPS`: Memory's pickup acts as toggle, DynamicObstacles'
actions from 3 up act as 0).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core.state import Actions
from minigrid_tpu_torch.envs.base import BASE_STEP


class HookVals(NamedTuple):
    """Lane vectors of one packed base transition, all `(1, B)` but `aux`.

    `read_pre(x, y)` / `read_post(x, y)` read the packed word of the
    absolute cell `(x, y)` (`(1, B)` coordinates) from the grid before /
    after this step's forward-cell write."""

    a: torch.Tensor  # the action
    x: torch.Tensor  # pre-step agent position and carried type, colour
    y: torch.Tensor
    ct: torch.Tensor
    cc: torch.Tensor
    x1: torch.Tensor  # post-step agent position and carried type, colour
    y1: torch.Tensor
    ct1: torch.Tensor
    cc1: torch.Tensor
    fwd_x: torch.Tensor  # the pre-step forward cell
    fwd_y: torch.Tensor
    reward: torch.Tensor  # base-step outcomes (f32, bool)
    terminated: torch.Tensor
    success: torch.Tensor  # 1 - 0.9 * (step_count + 1) / max_steps, f32
    aux: torch.Tensor  # (AUX_LEN, B) the episode's extras
    read_pre: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    read_post: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _zero(reward: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(reward)


def _hook_pickup_target(v: HookVals):
    """Unlock-Pickup / KeyCorridor / ObstructedMaze: a pickup that leaves
    the agent carrying the aux target (type, colour) rewards `success` and
    terminates."""
    got = (v.a == Actions.pickup) & (v.ct1 == v.aux[0:1]) & (v.cc1 == v.aux[1:2])
    return torch.where(got, v.success, v.reward), v.terminated | got


def _hook_fetch(v: HookVals):
    """Fetch: any pickup ends the episode, rewarded iff the carried (type,
    colour) is the aux target."""
    has = v.ct1 > 0
    match = has & (v.ct1 == v.aux[0:1]) & (v.cc1 == v.aux[1:2])
    reward = torch.where(match, v.success, v.reward)
    reward = torch.where(has & ~match, _zero(reward), reward)
    return reward, v.terminated | has


def _done_or_toggle(v: HookVals, near: torch.Tensor):
    """The go-to families: `done` while near the target rewards; `done`
    and `toggle` terminate."""
    done_act = v.a == Actions.done
    reward = torch.where(done_act & near, v.success, v.reward)
    return reward, v.terminated | done_act | (v.a == Actions.toggle)


def _hook_gotodoor(v: HookVals):
    """GoToDoor: near is cross-adjacent to the target door (post-step)."""
    tx, ty = v.aux[0:1], v.aux[1:2]
    near = ((v.x1 == tx) & ((v.y1 - ty).abs() == 1)) | ((v.y1 == ty) & ((v.x1 - tx).abs() == 1))
    return _done_or_toggle(v, near)


def _hook_gotoobject(v: HookVals):
    """GoToObject: near is within one cell of the target (post-step)."""
    near = ((v.x1 - v.aux[0:1]).abs() <= 1) & ((v.y1 - v.aux[1:2]).abs() <= 1)
    return _done_or_toggle(v, near)


def _hook_putnear(v: HookVals):
    """PutNear: a pickup action while holding the wrong object terminates;
    a drop after carrying terminates, rewarded iff it landed (in the
    pre-step forward cell) within one cell of the target."""
    wrong = (v.ct1 > 0) & ((v.ct1 != v.aux[0:1]) | (v.cc1 != v.aux[1:2]))
    pickup_fail = (v.a == Actions.pickup) & wrong
    dropped = (v.ct > 0) & (v.a == Actions.drop)
    drop_succeeded = dropped & (v.ct1 == 0)
    near = ((v.fwd_x - v.aux[2:3]).abs() <= 1) & ((v.fwd_y - v.aux[3:4]).abs() <= 1)
    reward = torch.where(drop_succeeded & near, v.success, v.reward)
    return reward, v.terminated | pickup_fail | dropped


def _door_open(w: torch.Tensor) -> torch.Tensor:
    return ((w & 15) == C.DOOR) & (((w >> 8) & 15) == C.STATE_OPEN)


def _hook_redbluedoors(v: HookVals):
    """RedBlueDoors: blue open after the step with red open before it
    rewards; blue open with red closed before, or red opened while blue
    stood open and blue closed, fails with 0. Each ends the episode."""
    rx, ry, bx, by = v.aux[0:1], v.aux[1:2], v.aux[2:3], v.aux[3:4]
    red_before = _door_open(v.read_pre(rx, ry))
    blue_before = _door_open(v.read_pre(bx, by))
    red_after = _door_open(v.read_post(rx, ry))
    blue_after = _door_open(v.read_post(bx, by))
    success = blue_after & red_before
    fail = (blue_after & ~red_before) | (~blue_after & red_after & blue_before)
    reward = torch.where(success, v.success, v.reward)
    reward = torch.where(fail, _zero(reward), reward)
    return reward, v.terminated | success | fail


# Transition name -> post-hook.
HOOKS = {
    "pickup_target": _hook_pickup_target,
    "fetch": _hook_fetch,
    "gotodoor": _hook_gotodoor,
    "gotoobject": _hook_gotoobject,
    "putnear": _hook_putnear,
    "redbluedoors": _hook_redbluedoors,
}

# Transition name -> the hook's id in the CUDA kernels (step_device.cuh).
KERNEL_HOOK_IDS = {
    BASE_STEP: 0,
    "pickup_target": 1,
    "fetch": 2,
    "gotodoor": 3,
    "gotoobject": 4,
    "putnear": 5,
    "redbluedoors": 6,
}


def packed_hook(transition: str) -> Optional[object]:
    """The hook of a transition, or None for the base step. A transition
    whose hook is not ported raises."""
    if transition == BASE_STEP:
        return None
    if transition not in HOOKS:
        raise NotImplementedError(
            f"the packed step hooks of transition {transition!r} are not ported yet (see ROADMAP.md)"
        )
    return HOOKS[transition]
