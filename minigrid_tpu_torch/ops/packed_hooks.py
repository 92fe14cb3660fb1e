"""Family hooks of the packed rollout (counterpart of
`minigrid_tpu/ops/packed_hooks.py`).

A family whose `step` overrides the base transition (reward on an event,
an extra termination) runs the base transition and then its hook, which
adjusts `(reward, terminated)`. A hook is elementwise math on `(1, B)`
lane vectors; `step_core` runs it in the plain version, and the CUDA
kernels run its counterpart in `csrc/step_device.cuh`, chosen by the id in
`KERNEL_HOOK_IDS`.

Hooks are keyed by the transition name an `Env` carries. Ported: the
pickup-target hook (KeyCorridor; UnlockPickup and ObstructedMaze share
it, but their generators are not ported), in the rollout kernel and the
policy kernel. The JAX package has nine post-hooks
(`minigrid_tpu/ops/packed_hooks.py::HOOKS`); the other eight (Fetch,
GoToDoor, GoToObject, PutNear, Memory, Unlock, RedBlueDoors,
DynamicObstacles), the DynamicObstacles pre-hook and the two action
remaps (`ACTION_REMAPS`: Memory's pickup acts as toggle, DynamicObstacles'
actions from 3 up act as 0) are still to port (ROADMAP.md).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from minigrid_tpu_torch.core.state import Actions
from minigrid_tpu_torch.envs.base import BASE_STEP


class HookVals(NamedTuple):
    """Lane vectors of one packed base transition, all `(1, B)` but `aux`."""

    a: torch.Tensor  # the action
    ct1: torch.Tensor  # post-step carried type and colour
    cc1: torch.Tensor
    reward: torch.Tensor  # base-step outcomes (f32, bool)
    terminated: torch.Tensor
    success: torch.Tensor  # 1 - 0.9 * (step_count + 1) / max_steps, f32
    aux: torch.Tensor  # (AUX_LEN, B) the episode's extras


def _hook_pickup_target(v: HookVals):
    """Unlock-Pickup / KeyCorridor / ObstructedMaze: a pickup that leaves
    the agent carrying the aux target (type, colour) rewards `success` and
    terminates."""
    got = (v.a == Actions.pickup) & (v.ct1 == v.aux[0:1]) & (v.cc1 == v.aux[1:2])
    return torch.where(got, v.success, v.reward), v.terminated | got


# Transition name -> post-hook.
HOOKS = {"pickup_target": _hook_pickup_target}

# Transition name -> the hook's id in the CUDA kernels (step_device.cuh).
KERNEL_HOOK_IDS = {BASE_STEP: 0, "pickup_target": 1}


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
