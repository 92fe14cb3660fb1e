"""Lane-major layout generation: paint straight into the packed `(HW, B)`
int32 word layout (counterpart of `minigrid_tpu/ops/packed_gen.py`).

A family's `generate_packed(keys (B, 2), cfg) -> (rolled words, regs)`
draws its plan with the JAX package's exact `jax.random` call tree
(`core/prng.py`) and paints with the masked selects below, each one
elementwise op over `(HW, B)` words. `get_packed_generator` finds it. A
family without one takes the JAX package's own route, its batched
`generate` then packed and agent-centred (`packed_generator`).
`packed_init`'s template build and the chunked-regen template refresh
(`ops/chunked_regen.py`) use whichever `packed_generator` returns.

Cell words follow `ops/packing.py::pack_states`:
`type | color<<4 | state<<8 | extra0<<12 | extra1<<16`.
"""

from __future__ import annotations

import functools
import importlib
from typing import Optional, Tuple

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import sampling
from minigrid_tpu_torch.core.state import AUX_LEN, MISSION_LEN
from minigrid_tpu_torch.ops.packing import EMPTY_WORD, R_X, R_Y, _roll_to_base, key_rows, pack_states


def cell_word(typ: int, color=0, state: int = 0):
    """A cell's packed int32 word (`pack_states` encoding); `color` is an
    int or a `(B,)` tensor."""
    return typ | (color << 4) | (state << 8)


GOAL_WORD = cell_word(C.GOAL, C.GREEN)


def xy_iota(height: int, width: int, device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat-cell coordinate columns: `(HW, 1)` int32 xs and ys (cell k is
    `(y, x) = (k // W, k % W)`, `pack_states`' flattening)."""
    k = torch.arange(height * width, dtype=torch.int32, device=device)[:, None]
    return k % width, k // width


def _row(v):
    """A `(B,)` tensor as a `(1, B)` row; ints stay ints."""
    return v[None, :] if isinstance(v, torch.Tensor) and v.ndim else v


def empty_words(height: int, width: int, b: int, device="cpu") -> torch.Tensor:
    """All-empty `(HW, B)` int32 words (`core.state.empty_state`'s grid)."""
    return torch.full((height * width, b), EMPTY_WORD, dtype=torch.int32, device=device)


def paint_rect_words(words, xs, ys, x0, y0, x1, y1, word) -> torch.Tensor:
    """Fill `x0 <= x < x1` and `y0 <= y < y1` with `word` per lane (the
    packed `core.grid.paint_rect`); bounds are ints or `(B,)`, and a range
    that reaches past the grid paints only the cells inside it."""
    mask = (xs >= _row(x0)) & (xs < _row(x1)) & (ys >= _row(y0)) & (ys < _row(y1))
    return torch.where(mask, _row(word), words)


def outline_rect_words(words, xs, ys, tx, ty, sx, sy, word, active=None) -> torch.Tensor:
    """Paint the outline of the rectangle `[t, t + s)` (a room's four wall
    strips) in one mask: the cells inside it on its border. `active` (B,)
    bool masks whole lanes."""
    tx, ty, sx, sy = (_row(v) for v in (tx, ty, sx, sy))
    inside = (xs >= tx) & (xs < tx + sx) & (ys >= ty) & (ys < ty + sy)
    border = (xs == tx) | (xs == tx + sx - 1) | (ys == ty) | (ys == ty + sy - 1)
    mask = inside & border
    if active is not None:
        mask = mask & active[None, :]
    return torch.where(mask, _row(word), words)


def set_cell_words(words, xs, ys, x, y, word, active=None) -> torch.Tensor:
    """Write one cell per lane (`core.grid.set_cell` as a masked select);
    `word` is an int or `(B,)`, `active` an optional `(B,)` lane mask."""
    mask = (xs == _row(x)) & (ys == _row(y))
    if active is not None:
        mask = mask & active[None, :]
    return torch.where(mask, _row(word), words)


def rect_mask_words(xs, ys, top_x, top_y, size_x, size_y) -> torch.Tensor:
    """`(HW, B)` bool of the cells inside `[top, top + size)` per lane
    (`core.sampling.rect_mask`, with its clamp of `top` at 0)."""
    tx = _row(torch.as_tensor(top_x, device=xs.device).clamp(min=0))
    ty = _row(torch.as_tensor(top_y, device=xs.device).clamp(min=0))
    sx, sy = _row(size_x), _row(size_y)
    return (xs >= tx) & (xs < tx + sx) & (ys >= ty) & (ys < ty + sy)


def free_mask_words(words, xs, ys, agent_x=None, agent_y=None) -> torch.Tensor:
    """`(HW, B)` bool: empty cells, without the agent's when given
    (`core.sampling.free_cell_mask`)."""
    free = (words & 15) == C.EMPTY
    if agent_x is not None:
        free = free & ~((xs == _row(agent_x)) & (ys == _row(agent_y)))
    return free


def sample_cell_words(keys, mask, width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A uniform draw per lane over the True cells of an `(HW, B)` mask ->
    `(x, y)`, `(B,)` int32 each: `core.sampling.sample_cell` on the
    lane's flat mask (same order, same all-False fallback)."""
    idx = sampling.sample_flat(keys, mask.T)
    return (idx % width).to(torch.int32), (idx // width).to(torch.int32)


def place_agent_words(keys, words, xs, ys, interior_mask, width: int):
    """Packed `roomgrid.place_agent`: `(pos, dir)` drawn jointly and
    uniformly over the free interior cells whose front cell is empty or a
    wall, in the `(y·W + x)·4 + d` flat order. Returns `(x, y, dir)`,
    `(B,)` int32 each."""
    hw, b = words.shape
    t = words & 15
    ok_cell = ((t == C.EMPTY) | (t == C.WALL)).T  # (B, HW)
    free = (free_mask_words(words, xs, ys) & interior_mask).T
    xrow = xs[:, 0][None, :]
    zrow = torch.zeros((b, 1), dtype=torch.bool, device=words.device)
    zcol = torch.zeros((b, width), dtype=torch.bool, device=words.device)
    # The front cell as flat-row shifts; wraps across rows are masked by
    # the x-bound tests.
    right = torch.cat([ok_cell[:, 1:], zrow], 1) & (xrow < width - 1)
    down = torch.cat([ok_cell[:, width:], zcol], 1)
    left = torch.cat([zrow, ok_cell[:, :-1]], 1) & (xrow > 0)
    up = torch.cat([zcol, ok_cell[:, :-width]], 1)
    valid = torch.stack([right & free, down & free, left & free, up & free], dim=-1)  # (B, HW, 4)
    idx = sampling.sample_flat(keys, valid.reshape(b, hw * 4))
    return (
        ((idx // 4) % width).to(torch.int32),
        (idx // (4 * width)).to(torch.int32),
        (idx % 4).to(torch.int32),
    )


def reject_next_to_words(xs, ys, agent_x, agent_y) -> torch.Tensor:
    """Packed `roomgrid.reject_next_to_mask`: Manhattan distance >= 2 from
    the agent (ints or `(B,)`)."""
    return ((xs - _row(agent_x)).abs() + (ys - _row(agent_y)).abs()) >= 2


def build_regs(b: int, agent_x, agent_y, agent_dir, rng, mission, aux) -> torch.Tensor:
    """`(NUM_REGS, B)` int32 registers in `pack_states`' row layout for a
    fresh (step count 0, hands empty) generated state; `mission` is
    `(B, MISSION_LEN)`, `aux` `(B, AUX_LEN)`, `rng` `(B, 2)` key words."""
    zeros = torch.zeros((5, b), dtype=torch.int32, device=rng.device)  # carrying, step count
    assert mission.shape == (b, MISSION_LEN) and aux.shape == (b, AUX_LEN)
    return torch.cat(
        [
            torch.stack([agent_x, agent_y, agent_dir]).to(torch.int32),
            zeros,
            aux.to(torch.int32).T,
            mission.to(torch.int32).T,
            key_rows(rng),
        ]
    ).contiguous()


def finish_packed(words, regs, width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The one-time agent-centring roll: row 0 becomes the agent's cell."""
    base = regs[R_Y : R_Y + 1] * width + regs[R_X : R_X + 1]
    return _roll_to_base(words, base).contiguous(), regs


def get_packed_generator(env) -> Optional[object]:
    """The family's `generate_packed(keys, cfg)` from the port's own
    `envs/<family>.py`, or None where the family has none."""
    try:
        mod = importlib.import_module(f"minigrid_tpu_torch.envs.{env.config.family}")
    except ImportError:
        return None
    return getattr(mod, "generate_packed", None)


def _pack_generated(generate, keys: torch.Tensor, cfg, plain: bool = False):
    """`_pack_rolled(cfg, generate(keys, cfg))`: the JAX package's route
    for a family without a packed generator
    (`minigrid_tpu/ops/chunked_regen.py:105-111`). It runs on the keys'
    device; `plain` is accepted and ignored, since no kernel runs inside."""
    words, regs = pack_states(generate(keys, cfg))
    return finish_packed(words, regs, cfg.width)


def packed_generator(env) -> Optional[object]:
    """`generate_packed(keys, cfg, plain=False) -> (rolled words, regs)`
    for `env`: the family's packed generator, else its batched `generate`
    packed (`_pack_generated`); None for an env without a generator."""
    gp = get_packed_generator(env)
    if gp is not None or env.generate is None:
        return gp
    return functools.partial(_pack_generated, env.generate)
