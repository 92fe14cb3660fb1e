"""The environment bundle (counterpart of `minigrid_tpu/envs/base.py`).

An `Env` pairs a static `EnvConfig` with a batched generator
`generate(keys (B, 2), config) -> EnvState` and names its transition: the
base transition (`BASE_STEP`) or a family's, whose packed hook
(`ops/packed_hooks.py`) the packed rollout runs after the base
transition. The port runs transitions only inside the packed rollout
(`ops/fused_rollout.py`); the per-env step and observation engine of the
JAX package is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from minigrid_tpu_torch.core import prng
from minigrid_tpu_torch.core.state import EnvConfig, EnvState

GenerateFn = Callable[[torch.Tensor, EnvConfig], EnvState]

# The base transition (the reference's MiniGridEnv.step). A family with its
# own step rules names its hook instead (KeyCorridor: "pickup_target").
BASE_STEP = "base"


@dataclasses.dataclass(frozen=True)
class Env:
    env_id: str
    config: EnvConfig
    generate: Optional[GenerateFn]
    transition: str = BASE_STEP

    def reset_batch(self, key: torch.Tensor, batch_size: int) -> EnvState:
        """`split(key, batch_size)`, then the generator on every key, in one
        batched call on `key.device`. Unlike the JAX package's
        `reset_batch`, no observation is returned: the port has no per-env
        observation encoder yet."""
        if self.generate is None:
            raise NotImplementedError(
                f"{self.env_id}: the port has no generator for this family "
                "yet (see ROADMAP.md)"
            )
        return self.generate(prng.split(key, batch_size), self.config)
