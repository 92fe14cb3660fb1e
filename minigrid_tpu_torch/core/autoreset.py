"""Auto-reset on the per-env path (counterpart of
`minigrid_tpu/core/autoreset.py`): a lane whose episode ends takes a
freshly generated state in the same step, so a batch runs on without the
caller resetting it.

Two modes:
  * "regen": a new layout at every reset, generated from the finishing
    state's rng leaf (`generate(res.state.rng)`), which moves the lane's
    reset chain on;
  * "cached": every reset of a lane replays one layout, generated from the
    lane's rng leaf before the step, with that key pinned back into the
    fresh state.

The JAX package generates every lane at every step and selects; a lane's
fresh state depends on its own key alone, so the port generates only the
lanes that finished, with the same bytes. `tools/autoreset_designs.py`
times the two designs against each other on a card.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from minigrid_tpu_torch.core.state import EnvState

MODES = ("regen", "cached")


def select_state(done: torch.Tensor, fresh: EnvState, old: EnvState) -> EnvState:
    """Per field, `fresh` where `done` (`(B,)` bool) else `old`."""

    def pick(a, b):
        return torch.where(done.reshape(done.shape + (1,) * (a.ndim - 1)), a, b)

    return EnvState(**{f.name: pick(getattr(fresh, f.name), getattr(old, f.name)) for f in dataclasses.fields(old)})


def put_lanes(state: EnvState, lanes: torch.Tensor, fresh: EnvState) -> EnvState:
    """`state` with lanes `lanes` (`(N,)` indices) replaced by the `N`
    lanes of `fresh`."""
    out = {}
    for f in dataclasses.fields(state):
        t = getattr(state, f.name).clone()
        t[lanes] = getattr(fresh, f.name)
        out[f.name] = t
    return EnvState(**out)


def take_lanes(state: EnvState, lanes: torch.Tensor) -> EnvState:
    """The lanes `lanes` (`(N,)` indices) of `state`."""
    return EnvState(**{f.name: getattr(state, f.name)[lanes] for f in dataclasses.fields(state)})


def reset_finished(state: EnvState, done: torch.Tensor, fresh) -> EnvState:
    """`state` with the lanes where `done` replaced by `fresh(lanes)`, the
    fresh states of those `(N,)` lane indices (not called when none is
    done)."""
    lanes = done.nonzero().flatten()
    return put_lanes(state, lanes, fresh(lanes)) if lanes.numel() else state


def make_autoreset_step(env, mode: str = "regen") -> Callable[..., Tuple]:
    """`step(states, actions) -> (states, obs, reward, terminated,
    truncated)` with auto-reset folded in: `states` already holds the fresh
    state where an episode ended and `obs` observes it (the next policy
    input); the reward and flags are the finishing transition's."""
    from minigrid_tpu_torch.core.step import as_actions
    from minigrid_tpu_torch.envs.base import step_fn

    if mode not in MODES:
        raise ValueError(f"unknown autoreset mode {mode!r}")
    transition = step_fn(env.transition)

    def step(state: EnvState, action):
        res = transition(state, as_actions(state, action), env.config)
        keys = res.state.rng if mode == "regen" else state.rng

        def fresh(lanes):
            new = env.generate(keys[lanes], env.config)
            return new if mode == "regen" else new.replace(rng=keys[lanes])

        new_state = reset_finished(res.state, res.terminated | res.truncated, fresh)
        return new_state, env.observe(new_state, env.config), res.reward, res.terminated, res.truncated

    return step
