"""The per-env rollout, its metrics and the random policies (counterpart
of `minigrid_tpu/core/rollout.py`).

`build_rollout` steps a batch through the per-env engine
(`core/autoreset.py`, the family's per-env transition, `core/obs.py`) one
step at a time in plain PyTorch: the independent reference that the
packed rollout (`ops/fused_rollout.py`) and its kernel are held against,
as the JAX package holds its own. Under the same key its random policy
draws the JAX package's actions, the stream `prng.randint_stream` gives
the packed surfaces.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from minigrid_tpu_torch.core import prng
from minigrid_tpu_torch.core.state import EnvState


class RolloutMetrics(NamedTuple):
    """Batch totals of one rollout call, as 0-d tensors on the device.

    Integer totals are int32 and wrap like the JAX package's int32 sums."""

    episodes: torch.Tensor  # int32 — completed episodes
    total_reward: torch.Tensor  # float32 — summed terminal rewards
    total_steps: torch.Tensor  # int32
    obs_checksum: torch.Tensor  # int32 — folds every visible obs byte
    reset_overlaps: torch.Tensor  # int32 — always 0 on the static paths


GeneratorPolicyFn = Callable[[torch.Generator, int, int], torch.Tensor]
PolicyFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # (key, obs images) -> actions


def generator_policy(num_actions: int) -> GeneratorPolicyFn:
    """`policy(generator, num_steps, batch) -> (num_steps, batch)` int32
    actions, uniform in `[0, num_actions)`, on the generator's device: the
    packed surfaces' cheaper stream.

    The draws come from `torch.Generator`, so they differ from the JAX
    package's `jax.random` stream under any seed (`random_policy` draws
    that one)."""

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


def random_policy(num_actions: int, lane0: int = 0) -> PolicyFn:
    """`policy(key, obs_images) -> (B,)` int32 actions, uniform in `[0,
    num_actions)`: the JAX package's `jax.random.randint(key, (B,), 0,
    num_actions)` for a `(2,)` key; with `lane0`, the actions of lanes
    `lane0` onwards of a larger batch (a shard's)."""

    def policy(key: torch.Tensor, obs_image: torch.Tensor) -> torch.Tensor:
        return prng.randint_lanes(key, obs_image.shape[0], 0, num_actions, lane0)

    return policy


class Transition(NamedTuple):
    """One step of a collected trajectory (`(T, B, ...)` when stacked)."""

    obs_image: torch.Tensor  # (B, V, V, 3) uint8: what the policy acted on
    action: torch.Tensor  # (B,) int32
    reward: torch.Tensor  # (B,) float32
    done: torch.Tensor  # (B,) bool


def _image(obs):
    return obs["image"] if isinstance(obs, dict) else obs


def wrap_i32(total: torch.Tensor) -> torch.Tensor:
    """An int64 total wrapped to int32, as the JAX package's int32 sums wrap."""
    return ((total + 2**31) % 2**32 - 2**31).to(torch.int32)


def totals_metrics(episodes, total_reward, checksum, env_steps: int, overlaps=None) -> RolloutMetrics:
    """A call's `RolloutMetrics` from its int64 episode and checksum totals
    (0-d tensors), its f32 reward sum and its `env_steps` (B·T); the
    integers wrapped to int32."""
    dev = total_reward.device
    return RolloutMetrics(
        episodes=wrap_i32(episodes),
        total_reward=total_reward,
        total_steps=wrap_i32(torch.tensor(env_steps, dtype=torch.int64, device=dev)),
        obs_checksum=wrap_i32(checksum),
        reset_overlaps=torch.zeros((), dtype=torch.int32, device=dev) if overlaps is None else wrap_i32(overlaps),
    )


def run_rollout(auto_step, observe, policy: PolicyFn, num_steps: int, key: torch.Tensor, states: EnvState,
                collect: bool = False):
    """`num_steps` steps of `auto_step(states, actions) -> (states, obs,
    reward, terminated, truncated)` from `states`: step t acts with
    `policy(split(key, num_steps)[t], obs)` on the observation the step
    before returned (`observe(states)` at the start), so the encoder runs
    once a step. Returns `(states, RolloutMetrics[, Transition])`."""
    dev = states.grid.device
    keys = prng.split(key.to(dev), num_steps)
    obs_img = _image(observe(states))
    b = obs_img.shape[0]
    episodes = torch.zeros((), dtype=torch.int64, device=dev)
    checksum = torch.zeros((), dtype=torch.int64, device=dev)
    total_reward = torch.zeros((), dtype=torch.float32, device=dev)
    traj = []
    for t in range(num_steps):
        actions = policy(keys[t], obs_img)
        states, obs, reward, terminated, truncated = auto_step(states, actions)
        next_img = _image(obs)
        done = terminated | truncated
        episodes = episodes + done.sum()
        total_reward = total_reward + reward.sum()
        checksum = checksum + next_img.sum(dtype=torch.int64)
        if collect:
            traj.append(Transition(obs_img, actions, reward, done))
        obs_img = next_img
    metrics = totals_metrics(episodes, total_reward, checksum, b * num_steps)
    if collect:
        return states, metrics, Transition(*(torch.stack(x) for x in zip(*traj)))
    return states, metrics


def build_rollout(
    env,
    num_steps: int,
    policy: Optional[PolicyFn] = None,
    collect: bool = False,
    autoreset_mode: str = "regen",
):
    """`rollout(key, states) -> (states, RolloutMetrics[, Transition])` over
    `num_steps` steps of the per-env engine (`run_rollout` over
    `make_autoreset_step`), acting with `policy` (default `random_policy`).
    `states` is a batched `EnvState` (`env.reset_batch`); every tensor
    follows its device. `autoreset_mode` is `make_autoreset_step`'s
    ("regen" or "cached"); with `collect` the stacked trajectory comes
    third."""
    from minigrid_tpu_torch.core.autoreset import make_autoreset_step

    policy = policy or random_policy(env.num_actions)
    auto_step = make_autoreset_step(env, mode=autoreset_mode)

    def rollout(key: torch.Tensor, states: EnvState):
        return run_rollout(auto_step, lambda s: env.observe(s, env.config), policy, num_steps, key, states, collect)

    return rollout
