"""State <-> packed-lane layout (counterpart of `minigrid_tpu/ops/packing.py`).

One int32 word per grid cell (`type | color<<4 | state<<8 |
cont_type<<12 | cont_color<<16`), the grid as `(H*W, B)`, every per-env
scalar, the aux and mission vectors and the two rng words as rows of a
`(NUM_REGS, B)` int32 register file, and the grid kept AGENT-CENTERED
(lane b's rows rolled so the agent's cell is row 0). The layout is the
JAX package's, so packed carries compare byte for byte.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core.prng import MASK32
from minigrid_tpu_torch.core.state import AUX_LEN, MISSION_LEN, EnvConfig, EnvState

R_X, R_Y, R_DIR, R_CT, R_CC, R_CCT, R_CCC, R_SC = range(8)
R_AUX = 8
R_MISSION = R_AUX + AUX_LEN
R_RNG = R_MISSION + MISSION_LEN
NUM_REGS = R_RNG + 2  # 42

WALL_WORD = C.WALL | (C.GREY << 4)  # out-of-bounds view cells read as grey walls
EMPTY_WORD = C.EMPTY

# The rollout kernel's 16-bit cells (csrc/rollout_kernel.cuh), the plain
# codec: a word keeps type (4 bits), colour (3), state (2), contained type
# (4) and contained colour (3); it fits where no other bit is set.
CELL16_BITS = 0x7F37F


def fits_cell16(words: torch.Tensor) -> torch.Tensor:
    """True where a packed word fits a 16-bit cell."""
    return (words & ~CELL16_BITS) == 0


def pack_cell16(words: torch.Tensor) -> torch.Tensor:
    """Packed words (that fit) -> their 16-bit cells, as int32."""
    return (words & 0x7F) | ((words >> 1) & 0x180) | ((words >> 3) & 0xFE00)


def unpack_cell16(cells: torch.Tensor) -> torch.Tensor:
    """16-bit cells (int32) -> the packed words."""
    return (cells & 0x7F) | ((cells & 0x180) << 1) | ((cells & 0xFE00) << 3)


def pack_states(states: EnvState) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched `EnvState` -> (`(H·W, B)` grid words, `(NUM_REGS, B)` regs)."""
    g = states.grid.to(torch.int32)  # (B, H, W, 5)
    words = g[..., 0] | (g[..., 1] << 4) | (g[..., 2] << 8) | (g[..., 3] << 12) | (
        g[..., 4] << 16
    )
    b = words.shape[0]
    words = words.reshape(b, -1).T.contiguous()
    carry = states.carrying.to(torch.int32)
    regs = torch.cat(
        [
            torch.stack(
                [
                    states.agent_pos[:, 0].to(torch.int32),
                    states.agent_pos[:, 1].to(torch.int32),
                    states.agent_dir.to(torch.int32),
                    carry[:, 0],
                    carry[:, 1],
                    carry[:, 2],
                    carry[:, 3],
                    states.step_count.to(torch.int32),
                ]
            ),
            states.aux.to(torch.int32).T,
            states.mission.to(torch.int32).T,
            key_rows(states.rng),
        ]
    )
    return words, regs


def key_rows(rng: torch.Tensor) -> torch.Tensor:
    """`(B, 2)` uint32-valued keys -> `(2, B)` int32 rows (bit cast)."""
    r = rng.to(torch.int64).T
    return torch.where(r >= 2**31, r - 2**32, r).to(torch.int32).contiguous()


def rows_key(rows: torch.Tensor) -> torch.Tensor:
    """Inverse of `key_rows`: `(2, B)` int32 rows -> `(B, 2)` int64 keys."""
    return (rows.to(torch.int64) & MASK32).T.contiguous()


def unpack_states(words: torch.Tensor, regs: torch.Tensor, config: EnvConfig) -> EnvState:
    """Inverse of `pack_states`."""
    hw, b = words.shape
    w = words.T.reshape(b, config.height, config.width)
    grid = torch.stack(
        [w & 15, (w >> 4) & 15, (w >> 8) & 15, (w >> 12) & 15, (w >> 16) & 15], dim=-1
    ).to(torch.uint8)
    return EnvState(
        grid=grid,
        agent_pos=torch.stack([regs[R_X], regs[R_Y]], dim=-1),
        agent_dir=regs[R_DIR].clone(),
        carrying=torch.stack(
            [regs[R_CT], regs[R_CC], regs[R_CCT], regs[R_CCC]], dim=-1
        ).to(torch.uint8),
        step_count=regs[R_SC].clone(),
        rng=rows_key(regs[R_RNG : R_RNG + 2]),
        mission=regs[R_MISSION : R_MISSION + MISSION_LEN].T.contiguous(),
        aux=regs[R_AUX : R_AUX + AUX_LEN].T.contiguous(),
    )


def visibility_bitmask(trans_rows: torch.Tensor, view: int) -> torch.Tensor:
    """The occlusion flood (`Grid.process_vis`) on V-bit row bitmasks.

    `trans_rows` is `(V, N)` int32: bit i of row j is 1 iff view cell
    (j, i) is transparent. Returns `(V, N)` int32: bit i of row j is 1 iff
    view cell (j, i) is visible. The agent sits at (row V-1, col V//2)."""
    half = view // 2
    all_bits = (1 << view) - 1
    last_clear = all_bits >> 1  # clears bit view-1
    first_clear = all_bits & ~1  # clears bit 0

    carry = torch.zeros_like(trans_rows[0])
    vis_rows = [None] * view
    for j in range(view - 1, -1, -1):
        seed = carry
        if j == view - 1:
            seed = seed | (1 << half)
        trow = trans_rows[j]
        row = seed
        for _ in range(view - 1):  # left-to-right pass
            row = row | ((row & trow) << 1)
        row = row & all_bits
        q_l = row & trow & last_clear
        for _ in range(view - 1):  # right-to-left pass
            row = row | ((row & trow) >> 1)
        q_r = row & trow & first_clear
        carry = (q_l | (q_l << 1) | q_r | (q_r >> 1)) & all_bits
        vis_rows[j] = row
    return torch.stack(vis_rows, dim=0)


def _dir_tables(width: int, height: int, view: int):
    """Per-direction offset tables (numpy), as in the JAX package:
      off_fwd[d]  — rolled row of the forward cell;
      off_view[d] — (V²,) rolled rows of the egocentric view cells;
      dxk/dyk[d]  — (V²,) world-frame view offsets."""
    hw = width * height
    half = view // 2
    kv = np.arange(view * view)
    rd = (view - 1) - kv // view  # forward distance per view cell
    co = kv % view - half  # lateral offset per view cell
    off_fwd, off_view, dxk, dyk = [], [], [], []
    for f0, f1 in C.DIR_TO_VEC:
        r0, r1 = -f1, f0  # right-perpendicular
        dx = f0 * rd + r0 * co
        dy = f1 * rd + r1 * co
        dxk.append(dx.astype(np.int32))
        dyk.append(dy.astype(np.int32))
        off_view.append(((dy * width + dx) % hw).astype(np.int32))
        off_fwd.append(int((f1 * width + f0) % hw))
    return off_fwd, off_view, dxk, dyk


def _sel4(d: torch.Tensor, vals) -> torch.Tensor:
    """4-way select by direction."""
    return torch.where(
        d == 0, vals[0], torch.where(d == 1, vals[1], torch.where(d == 2, vals[2], vals[3]))
    )


def _roll_static(x: torch.Tensor, k: int) -> torch.Tensor:
    """`out[s] = x[(s + k) % n]` for a constant k."""
    k %= x.shape[0]
    if k == 0:
        return x
    return torch.cat([x[k:], x[:k]], dim=0)


def _roll_to_base(words: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """Per-lane roll: `out[s, b] = words[(base[b] + s) % HW, b]`; `base` is
    `(1, B)` or `(B,)` with values in `[0, HW)`."""
    hw = words.shape[0]
    rows = torch.arange(hw, device=words.device, dtype=torch.int64)[:, None]
    idx = (rows + base.reshape(1, -1).to(torch.int64)) % hw
    return torch.gather(words, 0, idx)
