"""The gymnasium adapter's per-step path, without gymnasium.

`HostEnv` is the stateful object a reference user drives — `reset()` /
`step()` on one env, host observations (the mission as its string),
`render`, `hash`, ASCII `__str__` and the pose and view members of the
reference's `MiniGridEnv` — over a functional `Env` run on a batch of one
on the card (or on the device the caller names). `compat/gym_env.py::
MiniGridGymEnv` adds gymnasium's spaces and spec to it; this module needs
no gymnasium, so the path also runs where gymnasium is not installed.

`flat_obs` is `FlatObsWrapper`'s observation (the image flattened, then
the mission's characters one-hot), for the same reason.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import view
from minigrid_tpu_torch.core import prng
from minigrid_tpu_torch.core.state import Actions
from minigrid_tpu_torch.envs import missions
from minigrid_tpu_torch.envs.base import Env

MAX_MISSION_CHARS = 96
NUM_CHAR_CODES = 27  # a-z and space


class HostEnv:
    """Stateful adapter over a functional `Env` (the reference
    `MiniGridEnv`'s external API, minigrid.py:~667-1300), one env held as
    a batch of one on `device` (default: the card)."""

    def __init__(self, env: Env, render_mode: Optional[str] = None, device=None):
        self.actions = Actions  # reference `self.actions` (minigrid.py:~700)
        self.fenv = env
        self.render_mode = render_mode
        self.device = prng.default_device(device)
        # DynamicObstacles pays -1 on collision (reference
        # dynamicobstacles.py:~30 sets reward_range = (-1, 1)); every
        # other env rewards in [0, 1].
        self.reward_range = (-1.0, 1.0) if env.config.family == "dynamicobstacles" else (0.0, 1.0)
        self._seed = 0
        self.state = None

    # ------------------------------------------------------------- plumbing
    def _host_obs(self, obs) -> Any:
        """Lane 0 of an observation on the host: numpy arrays, the
        direction as an int and the mission as its string."""
        if isinstance(obs, dict):
            out = {k: v[0].cpu().numpy() for k, v in obs.items()}
            if "mission" in out:
                out["mission"] = missions.detokenize(out["mission"])
            if "direction" in out:
                out["direction"] = int(out["direction"])
            return out
        return obs[0].cpu().numpy()

    # ------------------------------------------------------------------ API
    def seed(self, seed: int = 1337):
        self._seed = int(seed)
        return [self._seed]

    def reset(self, *, seed: Optional[int] = None, options=None):
        """`Env.reset(key(seed))` on a batch of one; without a seed, the
        last seed plus one."""
        if seed is not None:
            self._seed = int(seed)
        else:
            self._seed += 1
        self.state, obs = self.fenv.reset(prng.key(self._seed, device=self.device))
        return self._host_obs(obs), {}

    def step(self, action):
        a = torch.tensor([int(action)], dtype=torch.int32, device=self.device)
        self.state, obs, reward, terminated, truncated = self.fenv.step(self.state, a)
        return self._host_obs(obs), float(reward[0]), bool(terminated[0]), bool(truncated[0]), {}

    def render(self, highlight: bool = True, tile_size: int = 32):
        if self.render_mode == "ansi":
            return self.__str__()
        from minigrid_tpu_torch.render.render import render_state

        return render_state(self.state, self.fenv.config, tile_size, highlight)[0].cpu().numpy()

    def hash(self, size: int = 16) -> str:
        """Deterministic state hash (`MiniGridEnv.hash`, minigrid.py:~758):
        sha256 over (encoded grid, agent_pos, agent_dir)."""
        from minigrid_tpu_torch.core.grid import encode

        to_encode = [
            encode(self.state.grid)[0].cpu().numpy().tolist(),
            self.state.agent_pos[0].cpu().numpy().tolist(),
            int(self.state.agent_dir[0]),
        ]
        sample_hash = hashlib.sha256()
        for item in to_encode:
            sample_hash.update(str(item).encode("utf8"))
        return sample_hash.hexdigest()[:size]

    def __str__(self) -> str:
        from minigrid_tpu_torch.utils.ascii import render_ascii

        return render_ascii(self.state)

    def close(self):
        pass

    def get_obs_render(self, obs_image, tile_size: int = 32):
        """Render an encoded `(V, V, 3)` partial observation
        (`get_obs_render`, minigrid.py:~1217-1240)."""
        from minigrid_tpu_torch.render.render import render_obs_image

        img = torch.as_tensor(np.asarray(obs_image), device=self.device)[None]
        return render_obs_image(img, tile_size)[0].cpu().numpy()

    # --------------------------------------------- pose / view geometry
    # Reference `MiniGridEnv` members (minigrid.py:~972-1085), through the
    # batched transforms of `core/view.py` on the one lane.
    def get_view_coords(self, i: int, j: int):
        vx, vy = view.get_view_coords(
            self.state.agent_pos, self.state.agent_dir, self.fenv.config.agent_view_size, i, j
        )
        return int(vx[0]), int(vy[0])

    def get_view_exts(self):
        exts = view.get_view_exts(self.state.agent_pos, self.state.agent_dir, self.fenv.config.agent_view_size)
        return tuple(int(e[0]) for e in exts)

    def relative_coords(self, x: int, y: int):
        vx, vy, valid = view.relative_coords(
            self.state.agent_pos, self.state.agent_dir, self.fenv.config.agent_view_size, x, y
        )
        return (int(vx[0]), int(vy[0])) if bool(valid[0]) else None

    def in_view(self, x: int, y: int) -> bool:
        return self.relative_coords(x, y) is not None

    def agent_sees(self, x: int, y: int) -> bool:
        return bool(view.agent_sees(self.state, self.fenv.config, x, y)[0])

    # Convenience passthroughs matching reference attribute names.
    @property
    def agent_pos(self):
        return tuple(self.state.agent_pos[0].cpu().numpy())

    @property
    def agent_dir(self):
        return int(self.state.agent_dir[0])

    @property
    def dir_vec(self):
        return view.dir_vec(self.state.agent_dir)[0].cpu().numpy()

    @property
    def right_vec(self):
        return view.right_vec(self.state.agent_dir)[0].cpu().numpy()

    @property
    def front_pos(self):
        return view.front_pos(self.state.agent_pos, self.state.agent_dir)[0].cpu().numpy()

    @property
    def carrying(self):
        """(type_name, color_name) of the held object, or None — the closest
        array analog of the reference's `self.carrying` WorldObj."""
        c = self.state.carrying[0].cpu().numpy()
        if c[0] == 0:
            return None
        return (C.IDX_TO_OBJECT[int(c[0])], C.IDX_TO_COLOR[int(c[1])])

    @property
    def mission(self) -> str:
        return missions.detokenize(self.state.mission[0])

    @property
    def max_steps(self) -> int:
        return self.fenv.config.max_steps

    @property
    def step_count(self) -> int:
        return int(self.state.step_count[0])

    @property
    def steps_remaining(self) -> int:
        return self.max_steps - self.step_count

    @property
    def width(self) -> int:
        return self.fenv.config.width

    @property
    def height(self) -> int:
        return self.fenv.config.height

    @property
    def agent_view_size(self) -> int:
        return self.fenv.config.agent_view_size

    @property
    def see_through_walls(self) -> bool:
        return self.fenv.config.see_through_walls


def mission_chars(mission: str, max_len: int = MAX_MISSION_CHARS) -> np.ndarray:
    """`(max_len, 27)` f32 one-hot of a mission's characters, lowercased:
    a-z and space; any other character is left out, as the reference
    does (`FlatObsWrapper`, wrappers.py:~271-315)."""
    assert len(mission) <= max_len, f"mission too long: {mission!r}"
    out = np.zeros((max_len, NUM_CHAR_CODES), dtype=np.float32)
    for idx, ch in enumerate(mission.lower()):
        if "a" <= ch <= "z":
            out[idx, ord(ch) - ord("a")] = 1.0
        elif ch == " ":
            out[idx, ord("z") - ord("a") + 1] = 1.0
    return out


def flat_obs(obs: Dict[str, Any], max_len: int = MAX_MISSION_CHARS) -> np.ndarray:
    """`FlatObsWrapper`'s observation of a host observation: the image
    flattened to f32, then the mission's one-hot characters."""
    chars = mission_chars(obs["mission"], max_len)
    return np.concatenate([np.asarray(obs["image"], np.float32).flatten(), chars.flatten()])
