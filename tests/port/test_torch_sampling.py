"""The port's placement sampling (`core/sampling.py`) against the JAX
package's `core.sampling`, on numpy-made grids, masks and keys, in one
JAX compile: `rect_mask`, `free_cell_mask`, `sample_cell` (with all-False
masks, the fallback) and `sample_direction`."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minigrid_tpu.core import sampling as jsampling
from minigrid_tpu_torch.core import sampling

B, H, W = 256, 7, 9


def _inputs():
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 2**32, size=(B, 2), dtype=np.uint64).astype(np.uint32)
    grid = np.zeros((B, H, W, 5), np.uint8)
    grid[..., 0] = rng.choice([1, 2, 5, 6], size=(B, H, W), p=[0.6, 0.2, 0.1, 0.1])
    agent = np.stack([rng.integers(0, W, B), rng.integers(0, H, B)], axis=1).astype(np.int32)
    top = np.stack([rng.integers(-2, W, B), rng.integers(-2, H, B)], axis=1).astype(np.int32)
    size = rng.integers(1, 6, size=(B, 2)).astype(np.int32)
    mask = rng.random((B, H, W)) < rng.random((B, 1, 1))
    mask[:8] = False
    return keys, grid, agent, top, size, mask


@functools.lru_cache(maxsize=None)
def _jax():
    keys, grid, agent, top, size, mask = _inputs()

    def one(k, g, a, t, s, m):
        rect = jsampling.rect_mask(H, W, t[0], t[1], s[0], s[1])
        return rect, jsampling.free_cell_mask(g, a), jsampling.sample_cell(k, m), jsampling.sample_direction(k)

    out = jax.jit(jax.vmap(one))(*(jnp.asarray(x) for x in (keys, grid, agent, top, size, mask)))
    return jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("what", ["rect_mask", "free_cell_mask", "sample_cell", "sample_direction"])
def test_sampling_matches_jax(what):
    keys, grid, agent, top, size, mask = (torch.from_numpy(x.astype(np.int64) if x.dtype == np.uint32 else x)
                                          for x in _inputs())
    rect, free, (x, y), d = _jax()
    if what == "rect_mask":
        got = sampling.rect_mask(H, W, top[:, 0], top[:, 1], size[:, 0], size[:, 1])
        np.testing.assert_array_equal(got.numpy(), rect)
    elif what == "free_cell_mask":
        np.testing.assert_array_equal(sampling.free_cell_mask(grid, agent).numpy(), free)
    elif what == "sample_cell":
        gx, gy = sampling.sample_cell(keys, mask)
        assert gx.dtype == gy.dtype == torch.int32
        np.testing.assert_array_equal(gx.numpy(), x)
        np.testing.assert_array_equal(gy.numpy(), y)
    else:
        np.testing.assert_array_equal(sampling.sample_direction(keys).numpy(), d)
