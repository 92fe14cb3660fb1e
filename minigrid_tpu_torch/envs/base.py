"""The environment bundle (counterpart of `minigrid_tpu/envs/base.py`).

An `Env` pairs a static `EnvConfig` with a batched generator
`generate(keys (B, 2), config) -> EnvState`, names its transition (the
base transition, `BASE_STEP`, or a family's) and carries an observation
encoder (`observe`, by default `core/obs.py::gen_obs`). The transition's
name is the one key of both engines: the packed rollout looks its hooks up
by it (`ops/packed_hooks.py`), and the per-env engine its step function
(`STEP_FNS`).

    env = minigrid_tpu_torch.make("MiniGrid-Empty-8x8-v0")
    states, obs = env.reset_batch(key(0), 8192)  # key(0): on the card
    states, obs, reward, terminated, truncated = env.step(states, actions)

Every method takes a batch: where the JAX package's `reset` and `step`
take one env (and `vmap` batches them), the port's take a batch of any
size, one included. Tensors follow the key's and the state's device.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from minigrid_tpu_torch.core import prng
from minigrid_tpu_torch.core.obs import gen_obs
from minigrid_tpu_torch.core.state import EnvConfig, EnvState
from minigrid_tpu_torch.core.step import StepResult, as_actions

GenerateFn = Callable[[torch.Tensor, EnvConfig], EnvState]
StepFn = Callable[[EnvState, torch.Tensor, EnvConfig], StepResult]
ObserveFn = Callable[[EnvState, EnvConfig], Any]
Obs = Dict[str, Any]

# The base transition (the reference's MiniGridEnv.step). A family with its
# own step rules names its own instead (KeyCorridor: "pickup_target").
BASE_STEP = "base"

# The per-env step function of each transition name, as (module, function).
STEP_FNS = {
    BASE_STEP: ("minigrid_tpu_torch.core.step", "base_step"),
    "pickup_target": ("minigrid_tpu_torch.envs.unlockpickup", "pickup_target_step"),
    "fetch": ("minigrid_tpu_torch.envs.fetch", "step"),
    "gotodoor": ("minigrid_tpu_torch.envs.gotodoor", "step"),
    "gotoobject": ("minigrid_tpu_torch.envs.gotoobject", "step"),
    "putnear": ("minigrid_tpu_torch.envs.putnear", "step"),
    "redbluedoors": ("minigrid_tpu_torch.envs.redbluedoors", "step"),
    "memory": ("minigrid_tpu_torch.envs.memory", "step"),
    "unlock": ("minigrid_tpu_torch.envs.unlock", "step"),
    "dynamicobstacles": ("minigrid_tpu_torch.envs.dynamicobstacles", "step"),
}


def step_fn(transition: str) -> StepFn:
    """The per-env step function of a transition name."""
    if transition not in STEP_FNS:
        raise NotImplementedError(f"transition {transition!r} has no per-env step (known: {sorted(STEP_FNS)})")
    module, name = STEP_FNS[transition]
    return getattr(importlib.import_module(module), name)


@dataclasses.dataclass(frozen=True)
class Env:
    env_id: str
    config: EnvConfig
    generate: Optional[GenerateFn]
    transition: str = BASE_STEP
    observe: ObserveFn = gen_obs

    # ------------------------------------------------------------------ API
    def _generate(self, keys: torch.Tensor) -> EnvState:
        if self.generate is None:
            raise NotImplementedError(
                f"{self.env_id}: the port has no generator for this family (see ROADMAP.md)"
            )
        return self.generate(keys, self.config)

    def reset(self, key: torch.Tensor) -> Tuple[EnvState, Obs]:
        """The generator on `key` itself: a `(2,)` key gives a batch of one
        (the JAX package's `reset(key)`), `(B, 2)` keys a batch of B."""
        state = self._generate(key.reshape(-1, 2))
        return state, self.observe(state, self.config)

    def step(self, state: EnvState, action) -> Tuple[EnvState, Obs, torch.Tensor, torch.Tensor, torch.Tensor]:
        """One transition of every lane under its action, and the
        observation of the new state."""
        res = step_fn(self.transition)(state, as_actions(state, action), self.config)
        return res.state, self.observe(res.state, self.config), res.reward, res.terminated, res.truncated

    def reset_batch(self, key: torch.Tensor, batch_size: int) -> Tuple[EnvState, Obs]:
        """`split(key, batch_size)`, then the generator on every key in one
        batched call on `key.device`: `(states, obs)`."""
        return self.reset(prng.split(key, batch_size))

    def step_batch(self, states: EnvState, actions):
        """`step` (every method takes a batch)."""
        return self.step(states, actions)

    # ----------------------------------------------------------- metadata
    @property
    def num_actions(self) -> int:
        return self.config.num_actions

    @property
    def obs_shape(self) -> Tuple[int, int, int]:
        v = self.config.agent_view_size
        return (v, v, 3)
