"""Placement sampling (counterpart of `minigrid_tpu/core/sampling.py`).

The reference's `place_obj` is rejection sampling; the JAX package draws
uniformly over a validity mask in one shot with `jax.random.categorical`,
and so does the port (`prng.categorical`), batched: every function takes
a `(B, 2)` key tensor and `(B, H, W)` masks.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import prng
from minigrid_tpu_torch.core.state import CH_TYPE


def _col(v, device) -> torch.Tensor:
    """An int or `(B,)` tensor as a `(B|1, 1, 1)` int64 column."""
    return torch.as_tensor(v, dtype=torch.int64, device=device).reshape(-1, 1, 1)


def rect_mask(height: int, width: int, top_x, top_y, size_x, size_y, device="cpu") -> torch.Tensor:
    """`(B|1, H, W)` bool of cells inside `[top, top + size)`, `top`
    clamped at 0 (`place_obj`'s window). Bounds are ints or `(B,)`."""
    ys = torch.arange(height, device=device)[None, :, None]
    xs = torch.arange(width, device=device)[None, None, :]
    tx = _col(top_x, device).clamp(min=0)
    ty = _col(top_y, device).clamp(min=0)
    return (xs >= tx) & (xs < tx + _col(size_x, device)) & (ys >= ty) & (ys < ty + _col(size_y, device))


def free_cell_mask(grid: torch.Tensor, agent_pos=None) -> torch.Tensor:
    """`(B, H, W)` bool: empty cells, without the agent's when `agent_pos`
    (`(B, 2)` x, y) is given."""
    free = grid[..., CH_TYPE] == C.EMPTY
    if agent_pos is not None:
        h, w = grid.shape[1:3]
        ys = torch.arange(h, device=grid.device)[None, :, None]
        xs = torch.arange(w, device=grid.device)[None, None, :]
        free = free & ~((xs == _col(agent_pos[:, 0], grid.device)) & (ys == _col(agent_pos[:, 1], grid.device)))
    return free


def sample_flat(keys: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """A uniform draw over the True entries of each row of `(B, N)` bool,
    as `(B,)` int64 indices; a row with none draws over all N (the JAX
    package's all-False fallback: zero logits everywhere)."""
    logits = torch.zeros(flat.shape, dtype=torch.float32, device=flat.device)
    blocked = ~flat & flat.any(dim=1, keepdim=True)
    return prng.categorical(keys, logits.masked_fill(blocked, float("-inf")))


def sample_cell(keys: torch.Tensor, mask: torch.Tensor):
    """One True cell per lane of a `(B, H, W)` mask -> `(x, y)`, `(B,)`
    int32 each."""
    w = mask.shape[2]
    idx = sample_flat(keys, mask.reshape(mask.shape[0], -1))
    return (idx % w).to(torch.int32), (idx // w).to(torch.int32)


def sample_direction(keys: torch.Tensor) -> torch.Tensor:
    """A random heading in 0..3 per key (`randint(key, (), 0, 4)`)."""
    return prng.randint(keys, 0, 4)
