"""Rollout metrics and the random policy (counterpart of the parts of
`minigrid_tpu/core/rollout.py` the packed rollout uses)."""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class RolloutMetrics(NamedTuple):
    """Batch totals of one rollout call, as 0-d tensors on the device.

    Integer totals are int32 and wrap like the JAX package's int32 sums."""

    episodes: torch.Tensor  # int32 — completed episodes
    total_reward: torch.Tensor  # float32 — summed terminal rewards
    total_steps: torch.Tensor  # int32
    obs_checksum: torch.Tensor  # int32 — folds every visible obs byte
    reset_overlaps: torch.Tensor  # int32 — always 0 on the static paths


PolicyFn = Callable[[torch.Generator, int, int], torch.Tensor]


def random_policy(num_actions: int) -> PolicyFn:
    """`policy(generator, num_steps, batch) -> (num_steps, batch)` int32
    actions, uniform in `[0, num_actions)`, on the generator's device.

    The draws come from `torch.Generator`, so they differ from the JAX
    package's `jax.random` stream under any seed; tests that compare the
    two feed both the same actions instead."""

    def policy(generator: torch.Generator, num_steps: int, batch: int) -> torch.Tensor:
        return torch.randint(
            0,
            num_actions,
            (num_steps, batch),
            dtype=torch.int32,
            generator=generator,
            device=generator.device,
        )

    return policy
