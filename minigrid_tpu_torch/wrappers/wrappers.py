"""Functional wrapper combinators (counterpart of
`minigrid_tpu/wrappers/wrappers.py`).

Each wrapper takes an `Env` and returns a new `Env` with a different
observation encoder (or a step transform); the observations stay batched
over the leading B and on the states' device. Host-stateful wrappers
(`ReseedWrapper`, the hash-keyed `ActionBonus`/`StateBonus` tables,
`FlatObsWrapper`'s mission one-hot) live at the gymnasium adapter in
`minigrid_tpu_torch.compat`; this module holds their device equivalents
where those exist.

Reference behaviors: gym_minigrid/wrappers.py:~12-345.
"""

from __future__ import annotations

import dataclasses

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import prng
from minigrid_tpu_torch.core.grid import encode, jax_index
from minigrid_tpu_torch.core.obs import gen_obs_image
from minigrid_tpu_torch.core.state import EnvConfig, EnvState
from minigrid_tpu_torch.core.step import as_actions
from minigrid_tpu_torch.envs.base import Env, step_fn


def _obs(state: EnvState, image: torch.Tensor) -> dict:
    return {"image": image, "direction": state.agent_dir, "mission": state.mission}


def img_obs(env: Env) -> Env:
    """`ImgObsWrapper`: the observation is the raw `(B, V, V, 3)` image."""

    def observe(state: EnvState, config: EnvConfig):
        return gen_obs_image(state, config)

    return dataclasses.replace(env, observe=observe)


def full_obs(env: Env) -> Env:
    """`FullyObsWrapper`: the image is the whole map's `(B, W, H, 3)`
    encoding with each agent's cell overwritten as (agent=10, red, dir);
    an agent position off the grid overwrites nothing, as the JAX
    package's scatter drops it."""

    def observe(state: EnvState, config: EnvConfig):
        img = encode(state.grid)  # (B, W, H, 3), [x, y]-indexed
        b, w, h = img.shape[:3]
        dev = img.device
        ax = jax_index(state.agent_pos[:, 0], w)[:, None, None]
        ay = jax_index(state.agent_pos[:, 1], h)[:, None, None]
        here = (torch.arange(w, device=dev)[None, :, None] == ax) & (torch.arange(h, device=dev)[None, None, :] == ay)
        agent = torch.stack([
            torch.full((b,), C.AGENT, dtype=torch.uint8, device=dev),
            torch.full((b,), C.RED, dtype=torch.uint8, device=dev),
            state.agent_dir.to(torch.uint8),
        ], dim=1)[:, None, None, :]
        return _obs(state, torch.where(here[..., None], agent, img))

    return dataclasses.replace(env, observe=observe)


def one_hot_partial_obs(env: Env) -> Env:
    """`OneHotPartialObsWrapper`: `(B, V, V, 3)` id triples -> `(B, V, V,
    20)` one-hot over 11 types + 6 colours + 3 states."""

    def observe(state: EnvState, config: EnvConfig):
        img = gen_obs_image(state, config).to(torch.int32)
        widths = (C.NUM_OBJECTS, C.NUM_COLORS, C.NUM_STATES)
        feats = [
            (img[..., i : i + 1] == torch.arange(n, device=img.device)).to(torch.uint8)
            for i, n in enumerate(widths)
        ]
        return _obs(state, torch.cat(feats, dim=-1))

    return dataclasses.replace(env, observe=observe)


def rgb_img_obs(env: Env, tile_size: int = 8) -> Env:
    """`RGBImgObsWrapper`: the image is the full-frame RGB render without
    highlight, `(B, H·ts, W·ts, 3)`."""
    from minigrid_tpu_torch.render.render import render_grid

    def observe(state: EnvState, config: EnvConfig):
        img = render_grid(state.grid, tile_size=tile_size, agent_pos=state.agent_pos, agent_dir=state.agent_dir)
        return _obs(state, img)

    return dataclasses.replace(env, observe=observe)


def rgb_img_partial_obs(env: Env, tile_size: int = 8) -> Env:
    """`RGBImgPartialObsWrapper`: the image is the rendered egocentric
    view, `(B, V·ts, V·ts, 3)`."""
    from minigrid_tpu_torch.render.render import render_obs_image

    def observe(state: EnvState, config: EnvConfig):
        return _obs(state, render_obs_image(gen_obs_image(state, config), tile_size=tile_size))

    return dataclasses.replace(env, observe=observe)


def view_size(env: Env, agent_view_size: int = 7) -> Env:
    """`ViewSizeWrapper`: change the egocentric view size (odd, ≥ 3)."""
    assert agent_view_size % 2 == 1 and agent_view_size >= 3
    config = dataclasses.replace(env.config, agent_view_size=agent_view_size)
    return dataclasses.replace(env, config=config)


@dataclasses.dataclass(frozen=True)
class CountedEnv:
    """An env whose step also threads a dense visit-count table, one row
    per lane, and adds `1/sqrt(count)` exploration bonuses to the reward.

    Device equivalents of `StateBonus`/`ActionBonus`: the reference keys an
    unbounded dict on `tuple(agent_pos)` / `(env.hash(), action)`; here a
    lane's row is dense over the position, or position × heading × action.

        cenv = state_bonus(env)
        counts = cenv.init_counts(batch_size)  # (B, size) int32, on the card
        states, obs = cenv.env.reset_batch(key, batch_size)
        counts, states, obs, r, term, trunc = cenv.step(counts, states, actions)
    """

    env: Env
    keyed_on_action: bool

    @property
    def size(self) -> int:
        h, w = self.env.config.height, self.env.config.width
        return h * w * (4 * 7 if self.keyed_on_action else 1)

    def init_counts(self, batch_size: int, device=None) -> torch.Tensor:
        """`(B, size)` int32 zeros on `device` (default: the card)."""
        return torch.zeros((batch_size, self.size), dtype=torch.int32, device=prng.default_device(device))

    def step(self, counts: torch.Tensor, state: EnvState, action):
        """One step of every lane; `counts` is updated in place and
        returned. The bonus is `1.0 / sqrt(count)` in f32, correctly
        rounded (a tensor divided by a tensor).

        The index is read as the JAX package's scatter and gather read it:
        a negative one counts from the end once; one still outside the
        table then adds to no count (the scatter drops it), and its bonus
        reads the nearest edge's count (the gather clamps), so a lane off
        the grid whose edge cell is unvisited pays `inf`."""
        env = self.env
        a = as_actions(state, action)
        res = step_fn(env.transition)(state, a, env.config)
        pos = res.state.agent_pos
        idx = pos[:, 1] * env.config.width + pos[:, 0]
        if self.keyed_on_action:
            idx = (idx * 4 + res.state.agent_dir) * 7 + torch.remainder(a.to(torch.int32), 7)
        idx = jax_index(idx.long(), self.size)
        inside = ((idx >= 0) & (idx < self.size)).to(torch.int32)[:, None]
        idx = idx.clamp(0, self.size - 1)[:, None]
        counts.scatter_add_(1, idx, inside)
        root = torch.sqrt(counts.gather(1, idx)[:, 0].to(torch.float32))
        bonus = torch.ones_like(root) / root
        obs = env.observe(res.state, env.config)
        return counts, res.state, obs, res.reward + bonus, res.terminated, res.truncated


def state_bonus(env: Env) -> CountedEnv:
    """`StateBonus`: the bonus keyed on the agent's position."""
    return CountedEnv(env=env, keyed_on_action=False)


def action_bonus(env: Env) -> CountedEnv:
    """`ActionBonus`: the bonus keyed on (pose, action)."""
    return CountedEnv(env=env, keyed_on_action=True)
