"""Shared inputs of the surface tests (`test_torch_render.py`,
`test_torch_wrappers.py`): `testing.py`'s random states as numpy leaves,
their JAX counterparts, and the states on one canvas of walls, so that one
JAX compile serves every size.

On a canvas padded with walls — the JAX package's out-of-bounds fill of
the view — every cell of the original region renders as at the original
size: the view reads the same cells, and a view cell past the original
edge lights only a canvas cell outside that region (at the original size
it clamps onto the edge with its `ok` false, which lights nothing).
"""

import dataclasses

import numpy as np
import torch

from minigrid_tpu_torch import make
from minigrid_tpu_torch.core.state import EnvConfig
from minigrid_tpu_torch.ops import fused_rollout as tfr
from minigrid_tpu_torch.testing import random_packed_case
from minigrid_tpu_torch.utils.convert import STATE_FIELDS, state_to_numpy

# Ids of five sizes (8x8, 12x6, 7x3, 9x9, 25x25), all with occlusion.
RENDER_IDS = ("MiniGrid-DoorKey-8x8-v0", "MiniGrid-RedBlueDoors-6x6-v0", "MiniGrid-KeyCorridorS3R1-v0",
              "MiniGrid-LavaCrossingS9N1-v0", "MiniGrid-MultiRoom-N2-S4-v0")
CANVAS = 25
WALL = (2, 5, 0, 0, 0)


def random_states(seed: int, env_id: str, b: int) -> dict:
    """`testing.py`'s random packed states at `env_id`'s size, unpacked."""
    cfg = make(env_id).config
    case = random_packed_case(seed, cfg.width, cfg.height, b, cfg.max_steps)
    words, regs = (torch.from_numpy(case[k]) for k in ("words", "regs"))
    return state_to_numpy(tfr._unpack_rolled(cfg, words, regs))


def jax_config(cfg: EnvConfig):
    from minigrid_tpu.core.state import EnvConfig as JConfig

    return JConfig(**dataclasses.asdict(cfg))


def jax_state(s: dict):
    import jax.numpy as jnp

    from minigrid_tpu.core.state import EnvState as JState

    return JState(**{k: jnp.asarray(s[k]) for k in STATE_FIELDS})


def padded(s: dict, canvas: int = CANVAS) -> dict:
    """`s` on a `canvas`-square grid of walls."""
    grid = np.zeros((len(s["grid"]), canvas, canvas, 5), np.uint8)
    grid[...] = WALL
    h, w = s["grid"].shape[1:3]
    grid[:, :h, :w] = s["grid"]
    return dict(s, grid=grid)


def canvas_config(see_through_walls: bool = False, canvas: int = CANVAS, view: int = 7) -> EnvConfig:
    return EnvConfig(family="empty", width=canvas, height=canvas, max_steps=1, agent_view_size=view,
                     see_through_walls=see_through_walls)


def joined(parts) -> dict:
    """The leaves of several state dicts concatenated along the batch."""
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
