"""Gymnasium adapter: drop-in class-based environments (counterpart of
`minigrid_tpu/compat/gym_env.py`).

`MiniGridGymEnv` is `compat/host_env.py::HostEnv` — the stateful
`reset()`/`step()` over the port's `Env` on a batch of one, on the card
unless given `device=` — with gymnasium's spaces and spec. `OldGymShim`
restores the old-gym 4-tuple `(obs, reward, done, info)` contract the
reference uses (minigrid.py:~1087 returns no terminated/truncated split).

Importing the port registers nothing into gymnasium: `register_all_gymnasium()`
does, under the `minigrid_tpu_torch/` namespace, so the ids never collide
with the JAX package's bare ones in one process.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import gymnasium
import numpy as np
from gymnasium import spaces

from minigrid_tpu_torch.compat.host_env import HostEnv
from minigrid_tpu_torch.envs.base import Env
from minigrid_tpu_torch.envs.registry import make

NAMESPACE = "minigrid_tpu_torch"
ENTRY_POINT = "minigrid_tpu_torch.compat.gym_env:_gymnasium_entry_point"
REWARD_THRESHOLD = 0.95


def gym_id(env_id: str) -> str:
    """The gymnasium id of a port env id: `minigrid_tpu_torch/<env_id>`."""
    return f"{NAMESPACE}/{env_id}"


class MiniGridGymEnv(HostEnv, gymnasium.Env):
    """Stateful adapter over a functional `Env`: `action_space =
    Discrete(N)`, `observation_space` with the `(V, V, 3)` image box, and
    `HostEnv`'s `reset`, `step`, `render`, `seed`, `hash`, ASCII `__str__`
    and view members."""

    metadata = {"render_modes": ["rgb_array", "ansi"], "render_fps": 10}

    def __init__(self, env: Env, render_mode: Optional[str] = None, device=None):
        HostEnv.__init__(self, env, render_mode=render_mode, device=device)
        # `spec`-like metadata the reference exposes through gym's registry
        # (register.py:~5-25). `gymnasium.make` overwrites this with the
        # registry's spec; direct construction gets the same fields here.
        self.spec = gymnasium.envs.registration.EnvSpec(
            id=gym_id(env.env_id),
            entry_point=ENTRY_POINT,
            reward_threshold=REWARD_THRESHOLD,
            max_episode_steps=env.config.max_steps,
            disable_env_checker=True,
            kwargs={"env_id": env.env_id},
        )
        v = env.config.agent_view_size
        self.action_space = spaces.Discrete(env.config.num_actions)
        self.observation_space = spaces.Dict(
            {
                "image": spaces.Box(0, 255, (v, v, 3), dtype=np.uint8),
                "direction": spaces.Discrete(4),
                "mission": spaces.Text(max_length=256),
            }
        )


class OldGymShim:
    """Old-gym API shim: 4-tuple step, reset returns obs only
    (the reference's contract — SURVEY.md §3.2)."""

    def __init__(self, env: MiniGridGymEnv):
        self.env = env

    def __getattr__(self, name):
        return getattr(self.env, name)

    def seed(self, seed=1337):
        return self.env.seed(seed)

    def reset(self):
        obs, _ = self.env.reset(seed=self.env._seed)
        return obs

    def step(self, action) -> Tuple[Any, float, bool, dict]:
        obs, reward, terminated, truncated, info = self.env.step(action)
        return obs, reward, terminated or truncated, info


def gym_make(env_id: str, render_mode: Optional[str] = None, old_api: bool = False, device=None):
    """`gym.make` equivalent resolving against the port's registry, on the
    card unless given `device=`."""
    env = MiniGridGymEnv(make(env_id), render_mode=render_mode, device=device)
    return OldGymShim(env) if old_api else env


def _gymnasium_entry_point(env_id: str, render_mode: Optional[str] = None, device=None, **kwargs):
    """Entry point `gymnasium.make` resolves registered ids through."""
    return MiniGridGymEnv(make(env_id), render_mode=render_mode, device=device)


def register_all_gymnasium() -> None:
    """Register every port env id into gymnasium's global registry as
    `minigrid_tpu_torch/<env_id>` (idempotent: ids already there are
    skipped), so `gymnasium.make("minigrid_tpu_torch/MiniGrid-Empty-8x8-v0")`
    works; pass `device=` to `gymnasium.make` to run off the card.

    `max_episode_steps` stays None because truncation is internal to the
    engine (the reference conflates the max-step timeout into `done`,
    minigrid.py:~1150): a TimeLimit wrapper would double-count.
    """
    from minigrid_tpu_torch.envs.registry import env_list

    for env_id in env_list:
        if gym_id(env_id) in gymnasium.registry:
            continue
        gymnasium.register(
            id=gym_id(env_id),
            entry_point=ENTRY_POINT,
            reward_threshold=REWARD_THRESHOLD,
            max_episode_steps=None,
            disable_env_checker=True,
            kwargs={"env_id": env_id},
        )
