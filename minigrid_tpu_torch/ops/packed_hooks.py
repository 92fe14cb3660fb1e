"""Family hooks of the packed rollout (counterpart of
`minigrid_tpu/ops/packed_hooks.py`).

A family whose `step` overrides the base transition runs up to three
pieces around it, each keyed by the transition name an `Env` carries:

  * a post-hook (`HOOKS`), after the base transition: elementwise math on
    `(1, B)` lane vectors, plus for the door families reads of absolute
    grid cells, that adjusts `(reward, terminated)`;
  * an action remap (`ACTION_REMAPS`), before it: the base transition
    takes the remapped action, the post-hook the original one;
  * a pre-hook (`PRE_HOOK_FACTORIES`, built per configuration), before it:
    a grid mutation whose stash the post-hook reads.

`step_core` runs them in the plain version, and the CUDA kernels run
their counterparts in `csrc/step_device.cuh`, chosen by the id in
`KERNEL_HOOK_IDS`. All of the JAX package's are ported, in the rollout
kernel and the policy kernel: the nine post-hooks (pickup-target, shared
by KeyCorridor, UnlockPickup and BlockedUnlockPickup; Fetch, GoToDoor,
GoToObject, PutNear, RedBlueDoors, Memory, Unlock and DynamicObstacles),
the DynamicObstacles pre-hook (the obstacles' random walk) and the two
remaps (Memory's pickup acts as toggle; DynamicObstacles' actions from 3
up act as 0).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import prng
from minigrid_tpu_torch.core.state import Actions, EnvConfig
from minigrid_tpu_torch.envs import dynamicobstacles as _dynobst
from minigrid_tpu_torch.envs.base import BASE_STEP
from minigrid_tpu_torch.ops.packing import EMPTY_WORD, R_AUX, R_DIR, R_RNG, R_SC, R_X, R_Y, _dir_tables, _sel4


class HookVals(NamedTuple):
    """Lane vectors of one packed base transition, all `(1, B)` but `aux`.

    `read_pre(x, y)` / `read_post(x, y)` read the packed word of the
    absolute cell `(x, y)` (`(1, B)` coordinates) from the grid before /
    after this step's forward-cell write (after the pre-hook's writes in
    both cases)."""

    a: torch.Tensor  # the action, before any remap
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
    stash: Any = None  # what the family's pre-hook returned, or None


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


def _hook_memory(v: HookVals):
    """Memory: stepping onto the success cell (aux 0, 1) rewards, onto the
    failure cell (aux 2, 3) fails with 0; either ends the episode."""
    on_success = (v.x1 == v.aux[0:1]) & (v.y1 == v.aux[1:2])
    on_failure = (v.x1 == v.aux[2:3]) & (v.y1 == v.aux[3:4])
    reward = torch.where(on_success, v.success, v.reward)
    reward = torch.where(on_failure, _zero(reward), reward)
    return reward, v.terminated | on_success | on_failure


def _hook_unlock(v: HookVals):
    """Unlock: a toggle that leaves the door (aux 0, 1) open rewards and
    ends the episode."""
    door_open = (v.a == Actions.toggle) & _door_open(v.read_post(v.aux[0:1], v.aux[1:2]))
    return torch.where(door_open, v.success, v.reward), v.terminated | door_open


def _hook_dynamicobstacles(v: HookVals):
    """DynamicObstacles: a forward move into a cell that was blocked before
    the walk (the pre-hook's stash) costs -1 and ends the episode. The
    action is remapped here too, since a hook sees the original."""
    collided = (_remap_dynamicobstacles(v.a) == Actions.forward) & v.stash
    return torch.where(collided, torch.full_like(v.reward, -1.0), v.reward), v.terminated | collided


def _make_pre_dynamicobstacles(config: EnvConfig):
    """The DynamicObstacles pre-hook for `config`: `pre(words, regs) ->
    (words', regs', not_clear)`.

    `not_clear` is whether the agent's forward cell holds anything but an
    empty cell or the goal before the walk (the collision predicate). Then
    each obstacle i in turn draws `hash_u31(rng rows, step_count·n + i)`
    and moves to that draw's pick among the free cells of its 3×3 box
    (`select_walk_target`): interior, not the goal (w-2, h-2), not the
    agent's cell, and no obstacle's current cell (obstacles before i at
    their new cells, itself and those after at their old ones). Validity
    comes from the registers (`aux[0:2n]`), as in the JAX package: such a
    grid holds only its outer wall, the goal and the obstacles. Each
    obstacle empties its old cell and puts a blue ball in its new one."""
    n = config.n_obstacles
    w, h = config.width, config.height
    hw = w * h
    ball_word = C.BALL | (C.BLUE << 4)
    off_fwd = _dir_tables(w, h, config.agent_view_size)[0]

    def pre(words: torch.Tensor, regs: torch.Tensor):
        x, y, d = regs[R_X : R_X + 1], regs[R_Y : R_Y + 1], regs[R_DIR : R_DIR + 1]
        sc = regs[R_SC : R_SC + 1]
        k0, k1 = regs[R_RNG : R_RNG + 1], regs[R_RNG + 1 : R_RNG + 2]
        base = y * w + x
        ft = _sel4(d, [words[o : o + 1] for o in off_fwd]) & 15
        not_clear = (ft != C.EMPTY) & (ft != C.GOAL)

        cur = [(regs[R_AUX + 2 * i : R_AUX + 2 * i + 1], regs[R_AUX + 2 * i + 1 : R_AUX + 2 * i + 2]) for i in range(n)]
        for i in range(n):
            u = prng.hash_u31(k0, k1, sc.to(torch.int64) * n + i)
            ox, oy = cur[i]
            valid9, xs9, ys9 = [], [], []
            for dy, dx in _dynobst.WALK_OFFSETS:
                nx, ny = ox + dx, oy + dy
                ok = (nx >= 1) & (nx <= w - 2) & (ny >= 1) & (ny <= h - 2)
                ok &= ~((nx == w - 2) & (ny == h - 2))
                ok &= ~((nx == x) & (ny == y))
                for cx, cy in cur:
                    ok &= ~((nx == cx) & (ny == cy))
                valid9.append(ok)
                xs9.append(nx)
                ys9.append(ny)
            nx, ny = _dynobst.select_walk_target(valid9, u, xs9, ys9, ox, oy)
            words = words.scatter(0, (((oy * w + ox) - base) % hw).long(), EMPTY_WORD)
            words = words.scatter(0, (((ny * w + nx) - base) % hw).long(), ball_word)
            cur[i] = (nx, ny)
        regs = torch.cat([regs[:R_AUX], *(r for xy in cur for r in xy), regs[R_AUX + 2 * n :]])
        return words, regs, not_clear

    return pre


# Transition name -> post-hook.
HOOKS = {
    "pickup_target": _hook_pickup_target,
    "fetch": _hook_fetch,
    "gotodoor": _hook_gotodoor,
    "gotoobject": _hook_gotoobject,
    "putnear": _hook_putnear,
    "redbluedoors": _hook_redbluedoors,
    "memory": _hook_memory,
    "unlock": _hook_unlock,
    "dynamicobstacles": _hook_dynamicobstacles,
}

# Transition name -> pre-hook factory `(EnvConfig) -> pre(words, regs) ->
# (words', regs', stash)`, run before the base transition.
PRE_HOOK_FACTORIES = {
    "dynamicobstacles": _make_pre_dynamicobstacles,
}


def _remap_memory(a: torch.Tensor) -> torch.Tensor:
    return torch.where(a == Actions.pickup, torch.full_like(a, Actions.toggle), a)


def _remap_dynamicobstacles(a: torch.Tensor) -> torch.Tensor:
    return torch.where(a >= 3, torch.zeros_like(a), a)


# Transition name -> the action remap the base transition takes.
ACTION_REMAPS = {
    "memory": _remap_memory,
    "dynamicobstacles": _remap_dynamicobstacles,
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
    "memory": 7,
    "unlock": 8,
    "dynamicobstacles": 9,
}


def packed_hook(transition: str, config: EnvConfig):
    """`(hook, remap_action, pre_hook)` of a transition under `config`, each
    None where the transition has none (all three for the base step). A
    transition without packed hooks raises."""
    if transition == BASE_STEP:
        return None, None, None
    if transition not in HOOKS:
        raise NotImplementedError(
            f"transition {transition!r} has no packed step hooks in the port (see ROADMAP.md)"
        )
    factory = PRE_HOOK_FACTORIES.get(transition)
    return HOOKS[transition], ACTION_REMAPS.get(transition), factory(config) if factory is not None else None
