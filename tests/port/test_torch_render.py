"""The port's renderer (`render/`) against the JAX package's, on the CPU.

  * The tile atlas at tile sizes 8, 16 and 32, byte for byte (both are
    NumPy builds).
  * `render_state` with and without the view highlight and
    `render_obs_image` of each lane's observation, on `testing.py`'s
    random states of five ids (`surface_cases.RENDER_IDS`), against one
    `jax.jit(jax.vmap(...))` of the JAX functions on the states put on one
    canvas (`surface_cases.py` says why a crop of it is the render at the
    size itself), byte for byte; `render_grid` with a random highlight
    mask the same way. Each JAX reference compiles once.
  * The highlight of view cells that clamp onto one world cell is their
    OR (against the JAX package's sequential loop, replayed in NumPy).
  * Tile ids off the atlas clamp as the JAX gather does.
"""

import dataclasses
import functools

import numpy as np
import pytest
import surface_cases as sc
import torch

from minigrid_tpu_torch import make
from minigrid_tpu_torch.core.obs import gen_obs_grid, gen_obs_image
from minigrid_tpu_torch.render import atlas as tatlas
from minigrid_tpu_torch.render.render import _view_highlight_mask, render_grid, render_obs_image, render_state
from minigrid_tpu_torch.utils.convert import state_from_numpy

CPU = torch.device("cpu")
TILE = 8
B = 12


@pytest.mark.parametrize("tile_size", [8, 16, 32])
def test_atlas_is_the_jax_packages(tile_size):
    from minigrid_tpu.render.atlas import NUM_AGENT_CODES, get_atlas, tile_id

    want = get_atlas(tile_size).tiles
    got = tatlas.get_atlas(tile_size).tiles
    assert got.dtype == np.uint8 and got.shape == want.shape == (tatlas.NUM_TILES, tile_size, tile_size, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tatlas.atlas_tensor(tile_size, CPU).numpy(), want)
    assert tatlas.NUM_AGENT_CODES == NUM_AGENT_CODES and tatlas.tile_id(10, 5, 2, 4) == tile_id(10, 5, 2, 4)


@functools.lru_cache(maxsize=None)
def _jax_renders():
    """The JAX package's renders of the canvas, one compile."""
    import jax

    from minigrid_tpu.core.obs import gen_obs_image as jgen_obs_image
    from minigrid_tpu.render.render import render_grid as jrender_grid
    from minigrid_tpu.render.render import render_obs_image as jrender_obs_image
    from minigrid_tpu.render.render import render_state as jrender_state

    jcfg = sc.jax_config(sc.canvas_config())

    def one(s, mask):
        return (jrender_state(s, jcfg, TILE, True), jrender_state(s, jcfg, TILE, False),
                jrender_obs_image(jgen_obs_image(s, jcfg), TILE),
                jrender_grid(s.grid, TILE, s.agent_pos, s.agent_dir, highlight_mask=mask))

    return jax.jit(jax.vmap(one))


@functools.lru_cache(maxsize=None)
def _cases():
    """Each id's states, a random highlight mask per lane, and the JAX
    renders of all of them on the canvas (one call)."""
    rng = np.random.default_rng(5)
    states = [sc.random_states(40 + i, e, B) for i, e in enumerate(sc.RENDER_IDS)]
    masks = [rng.random((B,) + s["grid"].shape[1:3]) < 0.4 for s in states]
    canvas_masks = np.zeros((len(states) * B, sc.CANVAS, sc.CANVAS), bool)
    for i, m in enumerate(masks):
        canvas_masks[i * B:(i + 1) * B, : m.shape[1], : m.shape[2]] = m
    out = _jax_renders()(sc.jax_state(sc.joined([sc.padded(s) for s in states])), canvas_masks)
    return states, masks, [np.asarray(o) for o in out]


@pytest.mark.parametrize("env_id", sc.RENDER_IDS)
def test_renders_match_jax_on_random_states(env_id):
    i = sc.RENDER_IDS.index(env_id)
    states, masks, want = _cases()
    cfg = make(env_id).config
    h, w = cfg.height, cfg.width
    state = state_from_numpy(states[i], device=CPU)
    lanes = slice(i * B, (i + 1) * B)
    crop = (lanes, slice(0, h * TILE), slice(0, w * TILE))
    hl = render_state(state, cfg, TILE, highlight=True)
    assert hl.shape == (B, h * TILE, w * TILE, 3) and hl.dtype == torch.uint8
    np.testing.assert_array_equal(hl.numpy(), want[0][crop])
    np.testing.assert_array_equal(render_state(state, cfg, TILE, highlight=False).numpy(), want[1][crop])
    obs = render_obs_image(gen_obs_image(state, cfg), TILE)
    np.testing.assert_array_equal(obs.numpy(), want[2][lanes])
    grid = render_grid(state.grid, TILE, state.agent_pos, state.agent_dir, torch.from_numpy(masks[i]))
    np.testing.assert_array_equal(grid.numpy(), want[3][crop])
    assert (hl != render_state(state, cfg, TILE, highlight=False)).any()


def _sequential_mask(state, cfg, lane, assign):
    """The JAX package's `_view_highlight_mask` loop for one lane, in
    NumPy: `mask[py, px] = mask[py, px] | ok` (or, with `assign`, a plain
    `mask[py, px] = ok`)."""
    v, h, w = cfg.agent_view_size, cfg.height, cfg.width
    vis = gen_obs_grid(state, cfg)[1][lane].numpy()
    f = np.array([(1, 0), (0, 1), (-1, 0), (0, -1)][int(state.agent_dir[lane])])
    r = np.array([-f[1], f[0]])
    top_left = state.agent_pos[lane].numpy() + f * (v - 1) - r * (v // 2)
    mask = np.zeros((h, w), bool)
    for j in range(v):
        for i in range(v):
            pos = top_left - f * j + r * i
            ok = vis[j, i] and 0 <= pos[0] < w and 0 <= pos[1] < h
            px, py = np.clip(pos[0], 0, w - 1), np.clip(pos[1], 0, h - 1)
            mask[py, px] = ok if assign else (mask[py, px] | ok)
    return mask


@pytest.mark.parametrize("see_through_walls", [True, False])
def test_highlight_of_overlapping_view_cells_is_their_or(see_through_walls):
    """Agents in the corners of a 5x5 room facing the walls: most view
    cells clamp onto the border, where a visible cell and invisible ones
    meet. The mask is the OR of the JAX package's loop; a plain assignment
    would differ on these states."""
    cfg = dataclasses.replace(make("MiniGrid-Empty-5x5-v0").config, see_through_walls=see_through_walls)
    b = 8
    s = sc.random_states(3, "MiniGrid-Empty-5x5-v0", b)
    s["agent_pos"] = np.array([[1, 1], [3, 3], [1, 3], [3, 1]] * 2, np.int32)
    s["agent_dir"] = np.array([2, 0, 1, 3, 3, 1, 2, 0], np.int32)
    state = state_from_numpy(s, device=CPU)
    got = _view_highlight_mask(state, cfg).numpy()
    differs = 0
    for lane in range(b):
        np.testing.assert_array_equal(got[lane], _sequential_mask(state, cfg, lane, assign=False), err_msg=str(lane))
        differs += not np.array_equal(got[lane], _sequential_mask(state, cfg, lane, assign=True))
    assert differs > 0


def test_tile_ids_off_the_atlas_clamp_as_jax_does():
    """Type ids past the table and headings far negative give tile ids off
    both ends of the atlas; the render reads its clamped ends, as the JAX
    gather does (CUDA indexing would assert instead)."""
    import jax
    import jax.numpy as jnp

    from minigrid_tpu.render.render import render_grid as jrender_grid

    rng = np.random.default_rng(11)
    grid = rng.integers(0, 256, size=(4, 5, 6, 5)).astype(np.uint8)
    pos = np.array([[0, 0], [5, 4], [2, 3], [-1, -1]], np.int32)
    dirs = np.array([-5000, 3, 900, -1], np.int32)
    got = render_grid(torch.from_numpy(grid), TILE, torch.from_numpy(pos), torch.from_numpy(dirs))
    want = jax.vmap(lambda g, p, d: jrender_grid(g, TILE, p, d))(jnp.asarray(grid), jnp.asarray(pos), jnp.asarray(dirs))
    ids = tatlas.tile_id(grid[..., 0].astype(np.int64), grid[..., 1], grid[..., 2])
    assert (ids >= tatlas.NUM_TILES).any() and (1 + dirs < -tatlas.NUM_TILES).any()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.gpu
def test_renders_on_the_card_match_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    for env_id in sc.RENDER_IDS[:3]:
        cfg = make(env_id).config
        s = sc.random_states(7, env_id, 64)
        cpu, card = state_from_numpy(s, device=CPU), state_from_numpy(s, device=dev)
        for hl in (True, False):
            assert torch.equal(render_state(card, cfg, TILE, hl).cpu(), render_state(cpu, cfg, TILE, hl))
        assert torch.equal(render_obs_image(gen_obs_image(card, cfg)).cpu(), render_obs_image(gen_obs_image(cpu, cfg)))
