"""Environment registry (counterpart of `minigrid_tpu/envs/registry.py`)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from minigrid_tpu_torch.core.state import EnvConfig
from minigrid_tpu_torch.envs.base import BASE_STEP, Env, GenerateFn


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    env_id: str
    config: EnvConfig
    generate: GenerateFn
    transition: str = BASE_STEP


registry: Dict[str, EnvSpec] = {}
env_list: List[str] = []  # registration order


def register(env_id: str, config: EnvConfig, generate: GenerateFn, transition: str = BASE_STEP) -> None:
    """Register an id with its configuration, its batched generator and the
    name of its transition (`BASE_STEP`, or a family's name in
    `envs/base.py::STEP_FNS` and `ops/packed_hooks.py`)."""
    if env_id in registry:
        raise ValueError(f"duplicate env id: {env_id}")
    registry[env_id] = EnvSpec(env_id, config, generate, transition)
    env_list.append(env_id)


def make(env_id: str) -> Env:
    """Resolve an env id to an `Env`; an id that is not registered raises
    `KeyError`, as the JAX package's `make` does."""
    if env_id not in registry:
        raise KeyError(f"unknown env id {env_id!r}; known: {sorted(registry)[:10]}...")
    spec = registry[env_id]
    return Env(spec.env_id, spec.config, spec.generate, spec.transition)
