"""Host-stateful wrappers over the gymnasium adapter (counterpart of
`minigrid_tpu/compat/host_wrappers.py`).

These are the wrappers whose reference semantics depend on host-side state
that has no fixed-size device representation: a cycling seed list, unbounded
hash-keyed count dicts, and mission-string character one-hots.
Reference: gym_minigrid/wrappers.py:~12-105, ~271-315. The render
wrappers render on the adapter's device; `ViewSizeWrapper` goes through
`wrappers.view_size`.
"""

from __future__ import annotations

import math

import gymnasium
import numpy as np
from gymnasium import spaces

from minigrid_tpu_torch.compat.host_env import MAX_MISSION_CHARS, NUM_CHAR_CODES, mission_chars


class ReseedWrapper(gymnasium.Wrapper):
    """Cycle deterministically through a fixed seed list on each reset
    (`ReseedWrapper`, wrappers.py:~12-35)."""

    def __init__(self, env, seeds=(0,), seed_idx=0):
        super().__init__(env)
        self.seeds = list(seeds)
        self.seed_idx = seed_idx

    def reset(self, **kwargs):
        seed = self.seeds[self.seed_idx]
        self.seed_idx = (self.seed_idx + 1) % len(self.seeds)
        kwargs.pop("seed", None)
        return self.env.reset(seed=int(seed), **kwargs)


class ActionBonus(gymnasium.Wrapper):
    """Count-based exploration bonus keyed on `(env.hash(), action)`
    (`ActionBonus`, wrappers.py:~38-70)."""

    def __init__(self, env):
        super().__init__(env)
        self.counts = {}

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        tup = (self.env.unwrapped.hash(), int(action))
        new_count = self.counts.get(tup, 0) + 1
        self.counts[tup] = new_count
        reward += 1 / math.sqrt(new_count)
        return obs, reward, terminated, truncated, info


class StateBonus(gymnasium.Wrapper):
    """Count-based exploration bonus keyed on the agent position
    (`StateBonus`, wrappers.py:~73-105)."""

    def __init__(self, env):
        super().__init__(env)
        self.counts = {}

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        tup = tuple(self.env.unwrapped.agent_pos)
        new_count = self.counts.get(tup, 0) + 1
        self.counts[tup] = new_count
        reward += 1 / math.sqrt(new_count)
        return obs, reward, terminated, truncated, info


class ImgObsWrapper(gymnasium.ObservationWrapper):
    """Obs is the raw image only, dropping mission/direction
    (`ImgObsWrapper`, wrappers.py:~108-122)."""

    def __init__(self, env):
        super().__init__(env)
        self.observation_space = env.observation_space["image"]

    def observation(self, obs):
        return obs["image"]


class OneHotPartialObsWrapper(gymnasium.ObservationWrapper):
    """(V, V, 3) id triples -> (V, V, 20) one-hot over 11 types + 6 colors
    + 3 states (`OneHotPartialObsWrapper`, wrappers.py:~125-165)."""

    def __init__(self, env):
        super().__init__(env)
        from minigrid_tpu_torch.core import constants as C

        self.widths = (C.NUM_OBJECTS, C.NUM_COLORS, C.NUM_STATES)
        img_space = env.observation_space["image"]
        v = img_space.shape[0]
        new_img = spaces.Box(0, 255, (v, v, sum(self.widths)), dtype=np.uint8)
        self.observation_space = spaces.Dict(
            {**env.observation_space.spaces, "image": new_img}
        )

    def observation(self, obs):
        img = np.asarray(obs["image"], np.int32)
        feats = [
            (img[..., i : i + 1] == np.arange(w)).astype(np.uint8)
            for i, w in enumerate(self.widths)
        ]
        return {**obs, "image": np.concatenate(feats, axis=-1)}


class RGBImgObsWrapper(gymnasium.ObservationWrapper):
    """Obs image := full-grid RGB render, no highlight
    (`RGBImgObsWrapper`, wrappers.py:~168-200)."""

    def __init__(self, env, tile_size: int = 8):
        super().__init__(env)
        self.tile_size = tile_size
        base = env.unwrapped
        h, w = base.fenv.config.height, base.fenv.config.width
        new_img = spaces.Box(
            0, 255, (h * tile_size, w * tile_size, 3), dtype=np.uint8
        )
        self.observation_space = spaces.Dict(
            {**env.observation_space.spaces, "image": new_img}
        )

    def observation(self, obs):
        from minigrid_tpu_torch.render.render import render_state

        base = self.env.unwrapped
        img = render_state(base.state, base.fenv.config, self.tile_size, highlight=False)
        return {**obs, "image": img[0].cpu().numpy()}


class RGBImgPartialObsWrapper(gymnasium.ObservationWrapper):
    """Obs image := rendered egocentric view
    (`RGBImgPartialObsWrapper`, wrappers.py:~203-235)."""

    def __init__(self, env, tile_size: int = 8):
        super().__init__(env)
        self.tile_size = tile_size
        v = env.observation_space["image"].shape[0]
        new_img = spaces.Box(
            0, 255, (v * tile_size, v * tile_size, 3), dtype=np.uint8
        )
        self.observation_space = spaces.Dict(
            {**env.observation_space.spaces, "image": new_img}
        )

    def observation(self, obs):
        import torch

        from minigrid_tpu_torch.render.render import render_obs_image

        image = torch.as_tensor(np.asarray(obs["image"]), device=self.env.unwrapped.device)[None]
        return {**obs, "image": render_obs_image(image, self.tile_size)[0].cpu().numpy()}


class FullyObsWrapper(gymnasium.ObservationWrapper):
    """Obs image := the whole map's encoding with the agent cell overwritten
    as (agent=10, red, agent_dir) (`FullyObsWrapper`, wrappers.py:~238-268)."""

    def __init__(self, env):
        super().__init__(env)
        base = env.unwrapped
        h, w = base.fenv.config.height, base.fenv.config.width
        new_img = spaces.Box(0, 255, (w, h, 3), dtype=np.uint8)
        self.observation_space = spaces.Dict(
            {**env.observation_space.spaces, "image": new_img}
        )

    def observation(self, obs):
        from minigrid_tpu_torch.core import constants as C
        from minigrid_tpu_torch.core.grid import encode

        base = self.env.unwrapped
        img = encode(base.state.grid)[0].cpu().numpy()  # (W, H, 3), [x, y]-indexed
        x, y = base.agent_pos
        img[x, y] = (C.AGENT, C.RED, base.agent_dir)
        return {**obs, "image": img}


class ViewSizeWrapper(gymnasium.Wrapper):
    """Change the egocentric view size (`ViewSizeWrapper`,
    wrappers.py:~318-345). Rebuilds the adapter over the functional env
    with the new `agent_view_size`, on the same device, and wraps it."""

    def __init__(self, env, agent_view_size: int = 7):
        from minigrid_tpu_torch.compat.gym_env import MiniGridGymEnv
        from minigrid_tpu_torch.wrappers import view_size

        base = env.unwrapped
        inner = MiniGridGymEnv(
            view_size(base.fenv, agent_view_size), render_mode=base.render_mode, device=base.device
        )
        super().__init__(inner)


class FlatObsWrapper(gymnasium.ObservationWrapper):
    """Flatten the image and one-hot encode the mission string
    (`FlatObsWrapper`, wrappers.py:~271-315): 96 chars × 27 symbols
    (a-z + space), lowercased, cached per mission string."""

    def __init__(self, env, maxStrLen: int = MAX_MISSION_CHARS):
        super().__init__(env)
        self.maxStrLen = maxStrLen
        self.numCharCodes = NUM_CHAR_CODES
        img_space = env.observation_space["image"]
        img_size = int(np.prod(img_space.shape))
        self.observation_space = spaces.Box(
            low=0,
            high=255,
            shape=(img_size + self.numCharCodes * self.maxStrLen,),
            dtype=np.float32,
        )
        self.cachedStr = None
        self.cachedArray = None

    def observation(self, obs):
        image = obs["image"]
        mission = obs["mission"]
        if mission != self.cachedStr:
            self.cachedStr = mission
            self.cachedArray = mission_chars(mission, self.maxStrLen)
        return np.concatenate(
            [np.asarray(image, np.float32).flatten(), self.cachedArray.flatten()]
        )
