"""Packed-lane multi-step rollout: one CUDA kernel, plus its plain twin
(counterpart of `minigrid_tpu/ops/fused_rollout.py`).

The state lives in the JAX package's packed layout (`ops/packing.py`):
`(H·W, B)` int32 cell words kept agent-centred, and a `(NUM_REGS, B)`
int32 register file. Two backends run the same step semantics:

  * `build_fused_rollout` — the whole T-step loop in one launch of the
    hand-written CUDA kernel `csrc/rollout_kernel.cu` (one thread per
    lane, the lane's grid in shared memory). Which code runs is decided
    by where the tensors lie: on a CUDA device the kernel launches (or
    the call raises); on the CPU the plain twin runs. Nothing falls back.
  * `build_packed_plain_rollout` — the same layout under a plain Python
    loop of torch ops over `(rows, B)` tensors (`step_core`/`obs_core`),
    on any device. It is the reference the kernel is held against, the
    role `build_packed_xla_rollout` plays in the JAX package.

Semantics are the JAX package's `_step_core`/`_obs_core`: the family's
action remap and pre-hook, the 7-action base transition, the family's
post-hook (`ops/packed_hooks.py`; all of the JAX package's), forward-cell
write-back, the re-centring roll
on a forward move, template auto-reset, the V² egocentric view with
out-of-bounds wall fill and the carried-object overlay, the occlusion
flood, and the per-step obs checksum. Modes: "cached" (every reset
replays the lane's pinned layout) and "regen". In regen mode the
static-layout families (Empty, DistShift) keep the template as the fresh
layout and only advance each lane's rng reset chain after the call
(`_replay_rng_chain`); a random-layout family runs exact chunked regen
(`ops/chunked_regen.py`), whose commit rows `step_core` and the kernel
take as `chunk_ctl`, with fresh templates from the family's packed
generator (KeyCorridor, MultiRoom) or its batched `generate`, packed
(`packed_gen.packed_generator`).

Integer results are byte-exact against the JAX package. `total_reward`
is a batch sum of per-lane sums, taken in another order than the JAX
package's, so it agrees to float tolerance; per-lane reward sums are
bit-identical between the kernel and the plain twin.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import prng
from minigrid_tpu_torch.core.rollout import RolloutMetrics, generator_policy, totals_metrics
from minigrid_tpu_torch.core.state import AUX_LEN, EnvConfig, EnvState
from minigrid_tpu_torch.envs.base import BASE_STEP, Env
from minigrid_tpu_torch.ops.chunked_regen import _no_mark, build_chunked_regen
from minigrid_tpu_torch.ops.packed_gen import get_packed_generator, packed_generator  # noqa: F401  (re-exported)
from minigrid_tpu_torch.ops.packed_hooks import KERNEL_HOOK_IDS, HookVals, packed_hook
from minigrid_tpu_torch.ops.packing import (
    EMPTY_WORD,
    NUM_REGS,
    R_AUX,
    R_CC,
    R_CCC,
    R_CCT,
    R_CT,
    R_DIR,
    R_RNG,
    R_SC,
    R_X,
    R_Y,
    WALL_WORD,
    _dir_tables,
    _roll_static,
    _roll_to_base,
    _sel4,
    key_rows,
    pack_states,
    unpack_states,
    visibility_bitmask,
)

# Launches of the CUDA rollout kernel in this process (plain integer; the
# wrapper adds one per launch and nowhere else).
rollout_kernel_launches = 0


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def step_core(
    words: torch.Tensor,  # (HW, B) int32, agent-centred
    regs: torch.Tensor,  # (NUM_REGS, B) int32
    a: torch.Tensor,  # (1, B) int32
    tmpl_words: torch.Tensor,  # (HW, B), rolled to the template agent
    tmpl_regs: torch.Tensor,
    *,
    width: int,
    height: int,
    view: int,
    max_steps: int,
    see_through_walls: bool,
    with_obs: bool = False,
    hook=None,
    remap_action=None,
    pre_hook=None,
    chunk_ctl=None,
    chunk_len=None,
):
    """One packed transition + family hooks + auto-reset + obs checksum:
    the JAX package's `_step_core`.

    Returns `(words2, regs2, reward (1,B) f32, done (1,B) bool,
    obs_sum (1,B) int32)`. `hook`, `remap_action` and `pre_hook` are what
    `ops/packed_hooks.py::packed_hook` gives the transition (None for the
    base step): the remapped action drives the base transition and the
    hook sees the original; the pre-hook mutates the grid and registers
    before the base transition and hands its stash to the hook, and a step
    that does not reset keeps its registers (the aux rows included). With
    `chunk_ctl`, the `(3, B)` int32 commit
    rows of exact chunked regen (`consumed`, `steps_done`, `frozen`;
    `ops/chunked_regen.py` I2-I3) and the chunk length `chunk_len`: a lane
    that has committed `chunk_len` steps or is frozen does nothing, and a
    step that ends an episode while the lane's template is already consumed
    freezes the lane and is discarded whole (state, reward, done, obs
    checksum; the pre-hook's writes too); the updated rows follow
    `obs_sum`. With `with_obs`, the
    post-step view `(vw, vis)` (`obs_core`) comes last."""
    hw = width * height
    off_fwd, _, _, _ = _dir_tables(width, height, view)
    dev = words.device
    iota_hw = torch.arange(hw, dtype=torch.int32, device=dev)[:, None]

    words_in, regs_in = words, regs  # what a step that is not committed leaves
    a_orig = a
    if remap_action is not None:
        a = remap_action(a)
    stash = None
    if pre_hook is not None:
        words, regs, stash = pre_hook(words, regs)

    x = regs[R_X : R_X + 1]
    y = regs[R_Y : R_Y + 1]
    d = regs[R_DIR : R_DIR + 1]
    ct = regs[R_CT : R_CT + 1]
    cc = regs[R_CC : R_CC + 1]
    cct = regs[R_CCT : R_CCT + 1]
    ccc = regs[R_CCC : R_CCC + 1]
    sc = regs[R_SC : R_SC + 1]

    # ---- transition -------------------------------------------------------
    dirx = _i32(d == 0) - _i32(d == 2)
    diry = _i32(d == 1) - _i32(d == 3)
    fwd4 = words[off_fwd]  # (4, B)
    fwdw = _sel4(d, [fwd4[i : i + 1] for i in range(4)])
    ft = fwdw & 15
    fc = (fwdw >> 4) & 15
    fs = (fwdw >> 8) & 15
    fct = (fwdw >> 12) & 15
    fcc = (fwdw >> 16) & 15

    is_left = a == 0
    is_right = a == 1
    is_fwd = a == 2
    is_pickup = a == 3
    is_drop = a == 4
    is_toggle = a == 5

    d1 = torch.where(is_right, d + 1, torch.where(is_left, d + 3, d)) % 4

    can_overlap = (
        (ft == C.EMPTY)
        | (ft == C.FLOOR)
        | (ft == C.GOAL)
        | (ft == C.LAVA)
        | ((ft == C.DOOR) & (fs == C.STATE_OPEN))
    )
    moves = is_fwd & can_overlap
    x1 = torch.where(moves, x + dirx, x)
    y1 = torch.where(moves, y + diry, y)

    sc1 = sc + 1
    hit_goal = is_fwd & (ft == C.GOAL)
    hit_lava = is_fwd & (ft == C.LAVA)
    terminated = hit_goal | hit_lava
    # Separate f32 ops in the reference's order, no fused multiply-add. The
    # divisor is a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not correctly rounded.
    sc1f = sc1.to(torch.float32)
    success = 1.0 - 0.9 * (sc1f / torch.full_like(sc1f, float(max_steps)))
    reward = torch.where(hit_goal, success, torch.zeros_like(success))
    assert (chunk_ctl is None) == (chunk_len is None)

    hands_empty = ct == 0
    can_pickup = (ft == C.KEY) | (ft == C.BALL) | (ft == C.BOX)
    do_pickup = is_pickup & can_pickup & hands_empty
    do_drop = is_drop & (ft == C.EMPTY) & ~hands_empty

    zero = torch.zeros_like(ct)
    ct1 = torch.where(do_pickup, ft, torch.where(do_drop, zero, ct))
    cc1 = torch.where(do_pickup, fc, torch.where(do_drop, zero, cc))
    cct1 = torch.where(do_pickup, fct, torch.where(do_drop, zero, cct))
    ccc1 = torch.where(do_pickup, fcc, torch.where(do_drop, zero, ccc))

    # Door toggle: a locked door opens iff the agent holds the matching key.
    has_key = (ct == C.KEY) & (cc == fc)
    new_door_state = torch.where(
        fs == C.STATE_LOCKED,
        _i32(torch.where(has_key, C.STATE_OPEN, C.STATE_LOCKED)),
        1 - fs,
    )
    toggled_door = (fwdw & ~(15 << 8)) | (new_door_state << 8)
    # Box toggle: replaced by its contents (or an empty cell).
    toggled_box = torch.where(fct > 0, fct, EMPTY_WORD) | (fcc << 4)

    dropped = ct | (cc << 4) | (cct << 12) | (ccc << 16)
    new_fwd = torch.where(do_pickup, EMPTY_WORD, fwdw)
    new_fwd = torch.where(do_drop, dropped, new_fwd)
    new_fwd = torch.where(is_toggle & (ft == C.DOOR), toggled_door, new_fwd)
    new_fwd = torch.where(is_toggle & (ft == C.BOX), toggled_box, new_fwd)
    off_f = _sel4(d, [torch.full_like(d, o) for o in off_fwd])  # (1, B)
    words1 = torch.where(iota_hw == off_f, new_fwd, words)

    if hook is not None:
        # Absolute cells resolve in the pre-step agent frame, which both
        # `words` and `words1` are rolled to.
        base = y * width + x

        def read_abs(grid, ax, ay):
            return torch.gather(grid, 0, (((ay * width + ax) - base) % hw).long())

        reward, terminated = hook(
            HookVals(a=a_orig, x=x, y=y, ct=ct, cc=cc, x1=x1, y1=y1, ct1=ct1, cc1=cc1, fwd_x=x + dirx, fwd_y=y + diry,
                     reward=reward, terminated=terminated, success=success, aux=regs[R_AUX : R_AUX + AUX_LEN],
                     read_pre=functools.partial(read_abs, words), read_post=functools.partial(read_abs, words1),
                     stash=stash)
        )

    # Re-centre the grid on the agent after a forward move.
    words_m = words1
    for i, o in enumerate(off_fwd):
        words_m = torch.where(moves & (d == i), _roll_static(words1, o), words_m)

    truncated = sc1 >= max_steps
    done = terminated | truncated

    # ---- template auto-reset ---------------------------------------------
    words2 = torch.where(done, tmpl_words, words_m)
    new_scalars = [
        torch.where(done, tmpl_regs[r : r + 1], v)
        for r, v in ((R_X, x1), (R_Y, y1), (R_DIR, d1), (R_CT, ct1), (R_CC, cc1), (R_CCT, cct1), (R_CCC, ccc1))
    ]
    sc2 = torch.where(done, zero, sc1)
    tail2 = torch.where(done, tmpl_regs[R_AUX:], regs[R_AUX:])
    regs2 = torch.cat(new_scalars + [sc2, tail2], dim=0)

    # ---- the exact-chunked-regen commit protocol --------------------------
    if chunk_ctl is not None:
        consumed, steps_done, frozen = chunk_ctl[0:1], chunk_ctl[1:2], chunk_ctl[2:3]
        active = (steps_done < chunk_len) & (frozen == 0)
        freeze_now = active & done & (consumed == 1)
        commit = active & ~freeze_now
        words2 = torch.where(commit, words2, words_in)
        regs2 = torch.where(commit, regs2, regs_in)
        done = done & commit
        reward = torch.where(commit, reward, torch.zeros_like(reward))
        ctl2 = torch.cat([torch.where(done, torch.ones_like(consumed), consumed), steps_done + _i32(commit),
                          frozen | _i32(freeze_now)])

    # ---- post-step observation and its checksum --------------------------
    vw, vis = obs_core(
        words2, regs2, width=width, height=height, view=view, see_through_walls=see_through_walls
    )
    tcs = (vw & 15) + ((vw >> 4) & 15) + ((vw >> 8) & 15)
    obs_sum = (tcs * vis).sum(dim=0, keepdim=True, dtype=torch.int32)
    out = (words2, regs2, reward, done)
    if chunk_ctl is not None:
        out += (torch.where(commit, obs_sum, torch.zeros_like(obs_sum)), ctl2)
    else:
        out += (obs_sum,)
    if with_obs:
        out += (vw, vis)
    return out


def obs_core(
    words: torch.Tensor,  # (HW, B) int32, agent-centred
    regs: torch.Tensor,  # (NUM_REGS, B) int32
    *,
    width: int,
    height: int,
    view: int,
    see_through_walls: bool,
):
    """Egocentric view of a packed state: `(vw, vis)`, both `(V², B)` int32.

    `vw[j·V + i]` is the packed word of view cell (row j, col i), agent at
    (V-1, V//2), walls out of bounds, carried object overlaid on the
    agent's cell; `vis` is the occlusion mask (1 = visible)."""
    half = view // 2
    agent_k = (view - 1) * view + half
    _, off_view, _, _ = _dir_tables(width, height, view)
    dev = words.device
    kvec = torch.arange(view * view, dtype=torch.int32, device=dev)[:, None]

    x2 = regs[R_X : R_X + 1]
    y2 = regs[R_Y : R_Y + 1]
    d2 = regs[R_DIR : R_DIR + 1]
    ct2 = regs[R_CT : R_CT + 1]
    cc2 = regs[R_CC : R_CC + 1]

    v2 = view * view
    rows = torch.as_tensor(np.concatenate(off_view), dtype=torch.int64, device=dev)
    vw_all = words[rows]  # (4·V², B)
    vw = _sel4(d2, [vw_all[i * v2 : (i + 1) * v2] for i in range(4)])
    rdv = (view - 1) - kvec // view  # forward distance per view cell
    cov = kvec % view - half  # lateral offset per view cell
    f0 = _i32(d2 == 0) - _i32(d2 == 2)
    f1 = _i32(d2 == 1) - _i32(d2 == 3)
    wx = x2 + f0 * rdv - f1 * cov
    wy = y2 + f1 * rdv + f0 * cov
    inb = (wx >= 0) & (wx < width) & (wy >= 0) & (wy < height)
    vw = torch.where(inb, vw, WALL_WORD)
    agent_word = torch.where(ct2 > 0, ct2 | (cc2 << 4), EMPTY_WORD)
    vw = torch.where(kvec == agent_k, agent_word, vw)

    if see_through_walls:
        return vw, torch.ones_like(vw)
    vt = vw & 15
    vs = (vw >> 8) & 15
    trans = _i32(~((vt == C.WALL) | ((vt == C.DOOR) & (vs != C.STATE_OPEN))))
    pow_i = 1 << (kvec % view)
    trans_rows = (trans * pow_i).reshape(view, view, -1).sum(dim=1, dtype=torch.int32)
    vis_rows = visibility_bitmask(trans_rows, view)  # (V, B)
    vis = (vis_rows.repeat_interleave(view, dim=0) >> (kvec % view)) & 1
    return vw, vis


def hook_kwargs(transition: str, config: EnvConfig) -> dict:
    """`step_core`'s `hook`, `remap_action` and `pre_hook` for `transition`
    under `config` (`packed_hook`)."""
    hook, remap_action, pre_hook = packed_hook(transition, config)
    return dict(hook=hook, remap_action=remap_action, pre_hook=pre_hook)


def plain_rollout(words, regs, tmpl_words, tmpl_regs, actions, config: EnvConfig, transition=BASE_STEP, ctl=None):
    """`T = actions.shape[0]` packed steps as a loop of torch ops, on any
    device, under `transition`'s hook. Returns `(words', regs', rsum,
    episodes, checksum)` with `(1, B)` per-lane accumulators (f32, int32,
    int32). With `ctl`, the `(3, B)` int32 commit rows of exact chunked
    regen, the T steps are one chunk under the commit protocol, and the
    updated rows come last."""
    b = words.shape[1]
    dev = words.device
    rsum = torch.zeros((1, b), dtype=torch.float32, device=dev)
    epi = torch.zeros((1, b), dtype=torch.int32, device=dev)
    csum = torch.zeros((1, b), dtype=torch.int32, device=dev)
    step = functools.partial(
        step_core,
        width=config.width,
        height=config.height,
        view=config.agent_view_size,
        max_steps=config.max_steps,
        see_through_walls=config.see_through_walls,
        **hook_kwargs(transition, config),
    )
    if ctl is not None:
        step = functools.partial(step, chunk_len=actions.shape[0])
    for t in range(actions.shape[0]):
        if ctl is None:
            words, regs, reward, done, obs_sum = step(words, regs, actions[t : t + 1], tmpl_words, tmpl_regs)
        else:
            words, regs, reward, done, obs_sum, ctl = step(
                words, regs, actions[t : t + 1], tmpl_words, tmpl_regs, chunk_ctl=ctl
            )
        rsum = rsum + reward
        epi = epi + _i32(done)
        csum = csum + obs_sum
    if ctl is not None:
        return words, regs, rsum, epi, csum, ctl
    return words, regs, rsum, epi, csum


# --------------------------------------------------------------------------
# The CUDA kernel's wrapper
# --------------------------------------------------------------------------

_SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on sm_90
_SMEM_PER_SM = 233_472  # an SM's shared memory; each resident block also takes _SMEM_RESERVED
_SMEM_RESERVED = 1024
_MAX_VIEW = 31  # the flood keeps one view row in the bits of a uint32
SM_COUNT = 132  # an H100 SXM's SMs: the plan's mirror on a machine without the card

# The rollout kernel's 16-bit cells (csrc/rollout_kernel.cuh) are built for
# this view size, and taken by the families whose every word fits them
# (`fits_cell16`; tests/port/test_torch_rollout_plan.py checks each ported
# family's words). Any other configuration runs the generic kernel on
# int32 cells.
CELL16_VIEW = 7
CELL16_FAMILIES = frozenset({
    "blockedunlockpickup", "crossing", "distshift", "doorkey", "dynamicobstacles", "empty", "fetch", "fourrooms",
    "gotodoor", "gotoobject", "keycorridor", "lavagap", "lockedroom", "memory", "multiroom", "obstructedmaze",
    "playground", "putnear", "redbluedoors", "unlock", "unlockpickup",
})
# Threads a lane of the 16-bit kernel, and the warps an SM one thread a
# lane must reach for the plan to take it (it does the least work) over
# four threads a lane. Measured (tools/b1_plan_sweep.py, PERF.md §6): four
# threads a lane won only where one held under 4 warps an SM
# (MultiRoom-N4-S5, 25x25, B = 32,768), and lost by a third at 7.8
# (KeyCorridorS6R3, B = 32,768).
THREADS_PER_LANE = (1, 4)
ENOUGH_WARPS = 6
_MIRROR_REGISTERS = 80  # registers a thread, for the plan's mirror: the 16-bit kernel's cap
# Lanes a block by (cell bits, threads a lane). With one thread a lane the
# 16-bit cells interleave the columns of two warps (whole 64-lane pairs).
# The blocks stay within the kernels' launch bounds: 128 threads, 256 with
# four threads a lane (csrc/rollout_kernel.cuh::kCells16MaxThreads).
LANE_BLOCKS = {(16, 1): (128, 64), (16, 4): (64, 32), (32, 1): (128, 64, 32)}

# The plan of the last launch of the rollout kernel in this process (for
# the chip run's report).
last_rollout_plan = None


def obstacle_rows(config: EnvConfig) -> int:
    """Shared-memory int32 rows per lane that the kernels keep for the
    DynamicObstacles walk: the obstacles' committed coordinates and the
    walk's new ones, `2·n` each (0 for any other family)."""
    return 4 * (config.n_obstacles or 0)


def _check_view(config: EnvConfig) -> None:
    v = config.agent_view_size
    if v < 3 or v % 2 == 0 or v > _MAX_VIEW:
        raise ValueError(f"rollout kernel: view size {v} must be odd and in [3, {_MAX_VIEW}]")


def kernel_lane_block(config: EnvConfig) -> int:
    """The most lanes a block of the generic (int32-cell) rollout kernel
    takes: the largest of 128, 64, 32 whose `[HW][bt]` int32 grid (plus the
    obstacle rows and the offset tables) fits one block's shared memory.
    Raises on a configuration the kernel does not take."""
    _check_view(config)
    for bt in (128, 64, 32):
        if rollout_smem_bytes(config, bt, 1, 32) <= _SMEM_LIMIT:
            return bt
    raise ValueError(
        f"rollout kernel: a {config.width}x{config.height} grid needs "
        f"{rollout_smem_bytes(config, 32, 1, 32)} B of shared memory for 32 lanes; the limit is {_SMEM_LIMIT}"
    )


def rollout_cell_bits(config: EnvConfig) -> int:
    """The rollout kernel's cell width for `config`: 16 at view 7 for the
    families in `CELL16_FAMILIES`, else 32."""
    return 16 if config.agent_view_size == CELL16_VIEW and config.family in CELL16_FAMILIES else 32


def rollout_smem_bytes(config: EnvConfig, lanes: int, threads_per_lane: int, cell_bits: int) -> int:
    """Shared memory of a rollout-kernel block of `lanes` lanes, as
    `csrc/rollout_kernel.cuh` carves it: the offset tables `4 + 4·V²` int32,
    the obstacle rows `[4n][lanes]` int32, then the cells: `[HW][lanes]`
    int32, or `[HW][stride]` 16-bit with `stride = lanes` (one thread a
    lane) or `lanes + 2` (several), rounded up to 4 bytes."""
    v = config.agent_view_size
    hw = config.width * config.height
    fixed = 4 * (4 + 4 * v * v) + 4 * obstacle_rows(config) * lanes
    if cell_bits == 32:
        return fixed + 4 * hw * lanes
    stride = lanes if threads_per_lane == 1 else lanes + 2
    return fixed + -(-2 * hw * stride // 4) * 4


def mirror_blocks_per_sm(threads: int, smem: int, registers: int = _MIRROR_REGISTERS) -> int:
    """Blocks of `threads` threads and `smem` bytes one SM of an H100 holds,
    as `cudaOccupancyMaxActiveBlocksPerMultiprocessor` counts them (2,048
    threads, 32 blocks, 65,536 registers in 256-register units a warp, 228
    KB of shared memory with 1 KB reserved a block), at `registers` a
    thread."""
    warps = -(-threads // 32)
    regs_per_warp = -(-registers * 32 // 256) * 256
    return min(2048 // threads, 32, 65536 // (regs_per_warp * warps), _SMEM_PER_SM // (smem + _SMEM_RESERVED))


class RolloutPlan(NamedTuple):
    """A launch plan of the rollout kernel: lanes a block, threads a lane,
    cell bits, shared memory a block, blocks an SM holds, and the warps an
    SM runs on average over the launch's waves."""

    lanes: int
    threads_per_lane: int
    cell_bits: int
    smem: int
    blocks_per_sm: int
    warps_per_sm: float


def rollout_plan(config: EnvConfig, b: int, blocks_per_sm=None, sms: int = SM_COUNT) -> RolloutPlan:
    """The rollout kernel's plan for `b` lanes of `config`: of the threads a
    lane that the cell width allows and their lane blocks (`LANE_BLOCKS`, at
    most `_SMEM_LIMIT` bytes a block), the plan with the most warps an SM
    runs on average over the launch's waves (`ceil(blocks / (blocks an SM
    holds * sms))`); one thread a lane wherever that reaches `ENOUGH_WARPS`
    (it does the least work), ties to fewer threads a lane and larger
    blocks. `blocks_per_sm(lanes, threads_per_lane, cell_bits, smem)` is the
    card's occupancy (the wrapper's), by default `mirror_blocks_per_sm`.
    Raises where no block fits."""
    _check_view(config)
    cell_bits = rollout_cell_bits(config)
    if blocks_per_sm is None:
        def blocks_per_sm(lanes, tpl, _bits, smem):
            return mirror_blocks_per_sm(lanes * tpl, smem)
    plans = []
    for tpl in THREADS_PER_LANE if cell_bits == 16 else (1,):
        for lanes in LANE_BLOCKS[cell_bits, tpl]:
            smem = rollout_smem_bytes(config, lanes, tpl, cell_bits)
            if smem > _SMEM_LIMIT:
                continue
            held = blocks_per_sm(lanes, tpl, cell_bits, smem)
            if held <= 0:
                continue
            blocks = -(-b // lanes)
            warps = blocks * lanes * tpl / 32 / (sms * -(-blocks // (held * sms)))
            plans.append(RolloutPlan(lanes, tpl, cell_bits, smem, held, warps))
    if not plans:
        raise ValueError(
            f"rollout kernel: a {config.width}x{config.height} grid needs "
            f"{rollout_smem_bytes(config, 32, 1, cell_bits)} B of shared memory for 32 lanes; the limit is "
            f"{_SMEM_LIMIT}"
        )
    one = [p for p in plans if p.threads_per_lane == 1]
    if one and max(p.warps_per_sm for p in one) >= ENOUGH_WARPS:
        plans = one
    return max(plans, key=lambda p: (p.warps_per_sm, -p.threads_per_lane, p.lanes))


@functools.lru_cache(maxsize=256)
def _card_plan(lib, device: torch.device, config: EnvConfig, hook_id: int, ctl: bool, b: int) -> RolloutPlan:
    """`rollout_plan` with the card's occupancy (`mg_rollout_occupancy`)
    and SM count, once per shape."""

    def held(lanes, tpl, bits, smem):
        n = lib.mg_rollout_occupancy(hook_id, int(ctl), config.agent_view_size, lanes, tpl, bits, smem)
        if n < 0:
            raise RuntimeError(f"rollout kernel occupancy failed: CUDA error {-n} "
                               f"({lib.mg_error_string(-n).decode()})")
        return n

    return rollout_plan(config, b, held, torch.cuda.get_device_properties(device).multi_processor_count)


@functools.lru_cache(maxsize=None)
def _kernel_tables(width: int, height: int, view: int, device: torch.device) -> torch.Tensor:
    """`[off_fwd (4); off_view (4·V²)]` int32 on `device`, made once per
    grid shape and device (the kernel only reads it)."""
    off_fwd, off_view, _, _ = _dir_tables(width, height, view)
    tab = np.concatenate([np.asarray(off_fwd, np.int32)] + off_view).astype(np.int32)
    return torch.from_numpy(tab).to(device)


def _check_operand(name, t, rows, b, dtype=torch.int32):
    if t.device.type != "cuda":
        raise ValueError(f"rollout kernel: {name} is on {t.device}, expected a CUDA device")
    if t.dtype != dtype:
        raise TypeError(f"rollout kernel: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != (rows, b):
        raise ValueError(f"rollout kernel: {name} has shape {tuple(t.shape)}, expected {(rows, b)}")
    if not t.is_contiguous():
        raise ValueError(f"rollout kernel: {name} is not contiguous")


def run_rollout_kernel(words, regs, tmpl_words, tmpl_regs, actions, config: EnvConfig, transition=BASE_STEP, ctl=None):
    """The rollout kernel's wrapper: same arguments and results as
    `plain_rollout`.

    CPU tensors run `plain_rollout`; CUDA tensors launch the kernel on the
    current stream under `rollout_plan`, and any other device, a
    transition whose hook the kernel lacks, a failed build or a failed
    launch raises. On 16-bit cells a word that does not fit them (colour
    or contained colour 8 or more, state 4 or more, bits above 19) traps
    the launch: the caller's next synchronization raises."""
    if words.device.type == "cpu":
        return plain_rollout(words, regs, tmpl_words, tmpl_regs, actions, config, transition, ctl)
    from minigrid_tpu_torch.ops import _build

    packed_hook(transition, config)  # raises for a transition without hooks
    hook_id = KERNEL_HOOK_IDS[transition]

    hw = config.width * config.height
    b = words.shape[1]
    t = actions.shape[0]
    for name, x, rows in (
        ("words", words, hw),
        ("regs", regs, NUM_REGS),
        ("tmpl_words", tmpl_words, hw),
        ("tmpl_regs", tmpl_regs, NUM_REGS),
        ("actions", actions, t),
        *((("ctl", ctl, 3),) if ctl is not None else ()),
    ):
        _check_operand(name, x, rows, b)
        if x.device != words.device:
            raise ValueError(f"rollout kernel: {name} is on {x.device}, words on {words.device}")
    if b == 0 or t == 0:
        raise ValueError(f"rollout kernel: empty batch or step count ({b}, {t})")
    dev = words.device
    lib = _build.load_library(dev)
    plan = _card_plan(lib, dev, config, hook_id, ctl is not None, b)

    words_out = torch.empty_like(words)
    regs_out = torch.empty_like(regs)
    rsum = torch.empty((1, b), dtype=torch.float32, device=dev)
    counts = torch.empty((2, b), dtype=torch.int32, device=dev)
    ctl_out = torch.empty((3, b), dtype=torch.int32, device=dev) if ctl is not None else None
    tables = _kernel_tables(config.width, config.height, config.agent_view_size, dev)

    def ptr(x):
        return ctypes.c_void_p(x.data_ptr() if x is not None else None)

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mg_rollout_launch(
            *map(ptr, (words, regs, tmpl_words, tmpl_regs, actions, tables, ctl,
                       words_out, regs_out, rsum, counts, ctl_out)),
            b, t, config.width, config.height, config.agent_view_size,
            config.max_steps, int(config.see_through_walls), NUM_REGS, hook_id,
            config.n_obstacles or 0, plan.lanes, plan.threads_per_lane, plan.cell_bits, plan.smem,
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(
            f"rollout kernel launch failed: CUDA error {err} "
            f"({lib.mg_error_string(err).decode()})"
        )
    global rollout_kernel_launches, last_rollout_plan
    last_rollout_plan = plan
    rollout_kernel_launches += 1
    if ctl is not None:
        return words_out, regs_out, rsum, counts[0:1], counts[1:2], ctl_out
    return words_out, regs_out, rsum, counts[0:1], counts[1:2]


# --------------------------------------------------------------------------
# The steady carry surface
# --------------------------------------------------------------------------

_DETERMINISTIC_LAYOUT = ("empty", "distshift")


class PackedCarry(NamedTuple):
    """Device state threaded between carry-surface rollout calls:
    `words`/`regs` the live packed state (agent-centred), `tmpl_*` the
    auto-reset template, `rng` the `(B, 2)` int64 regen reset-chain
    position (`EnvState.rng` semantics)."""

    words: torch.Tensor
    regs: torch.Tensor
    tmpl_words: torch.Tensor
    tmpl_regs: torch.Tensor
    rng: torch.Tensor


def _regen_is_static(env: Env) -> bool:
    """True iff template auto-reset alone reproduces regen semantics for
    `env` (a key-independent layout)."""
    cfg = env.config
    return (
        env.transition == BASE_STEP
        and cfg.family in _DETERMINISTIC_LAYOUT
        and (cfg.family != "empty" or cfg.agent_start_pos is not None)
    )


def _unsupported(env: Env, mode: str) -> Optional[Exception]:
    """Why the packed step does not run `env` under `mode`, or None when it
    does: the base step or a ported hook; cached mode, or regen (the static
    template, or chunked regen on the family's generator)."""
    try:
        packed_hook(env.transition, env.config)
    except NotImplementedError as e:
        return NotImplementedError(f"{env.env_id}: {e}")
    if mode not in ("regen", "cached"):
        return ValueError(f"unknown auto-reset mode {mode!r}")
    if mode == "regen" and not _regen_is_static(env) and packed_generator(env) is None:
        return NotImplementedError(
            f"{env.env_id}: regen mode generates a fresh layout at every reset, and this env "
            "has no generator (see ROADMAP.md); use mode='cached'"
        )
    return None


def _check_supported(env: Env, mode: str) -> None:
    """Raise unless the packed step runs `env` under `mode`."""
    error = _unsupported(env, mode)
    if error is not None:
        raise error


def packed_step_supported(env: Env, mode: str) -> bool:
    """True iff the packed step runs `env` under `mode`."""
    return _unsupported(env, mode) is None


def fused_rollout_supported(env: Env, mode: str = "regen") -> bool:
    """True iff the packed rollouts (`build_fused_rollout`,
    `build_packed_plain_rollout`) run `env` under `mode`: the JAX package's
    `fused_rollout_supported` without its batch size, since the kernel
    takes any batch width."""
    if not packed_step_supported(env, mode):
        return False
    try:
        kernel_lane_block(env.config)
    except ValueError:
        return False
    return True


def _agent_base(regs: torch.Tensor, width: int) -> torch.Tensor:
    return regs[R_Y : R_Y + 1] * width + regs[R_X : R_X + 1]  # (1, B)


def _pack_rolled(cfg: EnvConfig, states: EnvState):
    """`pack_states` + the one-time agent-centring roll."""
    words, regs = pack_states(states)
    return _roll_to_base(words, _agent_base(regs, cfg.width)), regs


def _unpack_rolled(cfg: EnvConfig, words_f: torch.Tensor, regs_f: torch.Tensor) -> EnvState:
    """Undo the agent-centred roll, then unpack."""
    hw = cfg.width * cfg.height
    base_f = _agent_base(regs_f, cfg.width)
    return unpack_states(_roll_to_base(words_f, (hw - base_f) % hw), regs_f, cfg)


def _prepare_packed(env: Env, states: EnvState, mode: str = "regen"):
    """Packed, agent-centred live state and reset template. The template
    is each lane's layout regenerated from its rng leaf (`packed_generator`:
    the family's packed generator, else its batched `generate`, packed); in
    cached mode its rng rows are pinned back to the live key."""
    cfg = env.config
    words0, regs0 = _pack_rolled(cfg, states)
    gp = packed_generator(env)
    if gp is None:
        raise NotImplementedError(
            f"{env.env_id}: the port cannot generate this family yet; build the "
            "carry from the JAX package's (utils/convert.py)"
        )
    tmpl_words, tmpl_regs = gp(states.rng, cfg)
    if mode == "cached":
        tmpl_regs[R_RNG : R_RNG + 2] = key_rows(states.rng)
    return words0, regs0, tmpl_words, tmpl_regs


def packed_init(env: Env, states: EnvState, mode: str = "regen") -> PackedCarry:
    """Pack a batched `EnvState` into a `PackedCarry` (one-time cost)."""
    _check_supported(env, mode)
    words0, regs0, tmpl_words, tmpl_regs = _prepare_packed(env, states, mode)
    return PackedCarry(words0, regs0, tmpl_words, tmpl_regs, states.rng)


def packed_finish(env: Env, carry: PackedCarry) -> EnvState:
    """Unpack a `PackedCarry` back into a batched `EnvState`."""
    return _unpack_rolled(env.config, carry.words, carry.regs).replace(rng=carry.rng)


def _replay_rng_chain(env: Env, rng0: torch.Tensor, n_resets: torch.Tensor) -> torch.Tensor:
    """Apply the regen reset chain `rng <- generate(rng).rng` `n_resets[b]`
    times to lane b: a loop of `max(n_resets)` batched iterations."""
    rng, rem = rng0, n_resets.to(torch.int64)
    for _ in range(int(rem.max().item()) if rem.numel() else 0):
        nxt = env.generate(rng, env.config).rng
        rng = torch.where((rem > 0)[:, None], nxt, rng)
        rem = rem - 1
    return rng


def _action_stream(env: Env, num_steps: int, source, b: int, device, override=None):
    """The `(T, B)` int32 action stream: `override` (a `(T, B)` or `(T,)`
    array) if given, else the random policy drawn from `source`: a
    `torch.Generator` (`torch.randint`), or a `(2,)` key for the JAX
    package's own actions (`prng.randint_stream`, Threefry in plain torch;
    its cost beside the Generator's is in PERF.md §5)."""
    if override is not None:
        actions = torch.as_tensor(np.asarray(override), dtype=torch.int32, device=device)
        if actions.ndim == 1:
            actions = actions[:, None].expand(num_steps, b)
        if tuple(actions.shape) != (num_steps, b):
            raise ValueError(f"actions_override has shape {tuple(actions.shape)}, expected {(num_steps, b)}")
        return actions.contiguous()
    if source is None:
        raise ValueError("a torch.Generator or a key is needed to sample the random policy")
    if isinstance(source, torch.Tensor):
        return prng.randint_stream(source.to(device), num_steps, b, 0, env.config.num_actions)
    gd = torch.device(source.device)
    if gd.type != device.type or gd.index not in (None, device.index):
        raise ValueError(f"the generator is on {gd}, the carry on {device}")
    return generator_policy(env.config.num_actions)(source, num_steps, b)


def _make_plain_carry_step(env: Env, num_steps: int, mode: str, run_core, stream_fn):
    """`step(source, carry, mark) -> (carry, RolloutMetrics)` for the
    static-template paths (cached mode, or regen on static layouts).
    `stream_fn(source, b, device)` makes the `(T, B)` per-step input (the
    actions, or the policy's sampling seeds) and `run_core(words, regs,
    tmpl_words, tmpl_regs, stream, config)` runs the whole `num_steps`.
    `mark(piece)` is called at the end of each piece ("actions", "kernel",
    "rng" in regen mode, "sums"), as chunked regen's step does."""

    def step_carry(source, carry: PackedCarry, mark=_no_mark):
        b = carry.words.shape[1]
        dev = carry.words.device
        stream = stream_fn(source, b, dev)
        mark("actions")
        words_f, regs_f, rsum, epi, csum = run_core(
            carry.words, carry.regs, carry.tmpl_words, carry.tmpl_regs, stream, env.config
        )
        mark("kernel")
        rng = carry.rng
        if mode == "regen":
            rng = _replay_rng_chain(env, rng, epi[0])
            mark("rng")
        metrics = rollout_metrics(rsum, epi, csum, num_steps)
        mark("sums")
        return PackedCarry(words_f, regs_f, carry.tmpl_words, carry.tmpl_regs, rng), metrics

    return step_carry


def rollout_metrics(rsum, epi, csum, num_steps: int) -> RolloutMetrics:
    """A static-template call's batch totals from its `(1, B)` per-lane
    reward sums, episode counts and obs checksums."""
    b = rsum.shape[1]
    return totals_metrics(epi.sum(dtype=torch.int64), rsum.sum(), csum.sum(dtype=torch.int64), b * num_steps)


def _fit_chunk(num_steps: int, chunk: int) -> int:
    """The largest divisor of `num_steps` that is at most `chunk`."""
    tc = min(chunk, num_steps)
    while num_steps % tc:
        tc -= 1
    return tc


def build_carry_surface(env: Env, num_steps: int, mode: str, as_carry: bool, run_core, stream_fn):
    """The carry step of `_make_plain_carry_step`, or with `as_carry=False`
    `rollout(source, states) -> (states, RolloutMetrics)` around it."""
    _check_supported(env, mode)
    return _surface(env, mode, as_carry, _make_plain_carry_step(env, num_steps, mode, run_core, stream_fn))


def _surface(env: Env, mode: str, as_carry: bool, step_carry):
    if as_carry:
        return step_carry

    def rollout(source, states: EnvState, mark=_no_mark):
        carry, metrics = step_carry(source, packed_init(env, states, mode), mark=mark)
        return packed_finish(env, carry), metrics

    return rollout


def _actions_for(env: Env, num_steps: int, actions_override):
    return lambda source, b, dev: _action_stream(env, num_steps, source, b, dev, actions_override)


def _build_rollout(env, num_steps, mode, as_carry, actions_override, regen_chunk, refresh_block, run):
    """The surfaces of `build_fused_rollout` and `build_packed_plain_rollout`
    over `run` (`run_rollout_kernel` or `plain_rollout`): chunked regen for
    a random-layout family in regen mode, else the static-template step.
    With `plain_rollout` the template refresh generates with the plain
    versions of the generation kernels too."""
    _check_supported(env, mode)
    run_core = functools.partial(run, transition=env.transition)
    stream_fn = _actions_for(env, num_steps, actions_override)
    if mode == "regen" and not _regen_is_static(env):
        tc = _fit_chunk(num_steps, regen_chunk)

        def chunk_fn(words, regs, tmpl_words, tmpl_regs, actions, ctl):
            return run_core(words, regs, tmpl_words, tmpl_regs, actions, env.config, ctl=ctl)

        generate = functools.partial(packed_generator(env), plain=run is plain_rollout)
        step_carry = build_chunked_regen(env, num_steps, tc, chunk_fn, stream_fn, generate, refresh_block)
    else:
        step_carry = _make_plain_carry_step(env, num_steps, mode, run_core, stream_fn)
    return _surface(env, mode, as_carry, step_carry)


def build_fused_rollout(
    env: Env,
    num_steps: int,
    mode: str = "regen",
    as_carry: bool = False,
    actions_override=None,
    regen_chunk: int = 32,
    refresh_block=None,
    row_reader: str = "auto",
):
    """`rollout(source, states) -> (states, RolloutMetrics)`, or with
    `as_carry=True` the steady surface `step(source, carry) -> (carry,
    RolloutMetrics)` (see `packed_init`/`packed_finish`). The step loop
    runs in the CUDA kernel for CUDA tensors and in the plain twin for CPU
    tensors. The random policy draws from `source`: a `torch.Generator`,
    or a `(2,)` key, which gives the JAX package's `random_policy` actions
    at the cost of a Threefry stream in plain torch (PERF.md §5 times
    both); `actions_override` (`(T, B)` or `(T,)`) replaces it.

    `row_reader` takes the JAX package's values, "auto", "slices" and
    "matmul", and raises on any other. They choose how the TPU kernel
    reads its forward and view rows, a layout choice of that chip: the
    CUDA kernel and the plain twin read each row by its address under
    every value, with the same results.

    In regen mode a random-layout family runs exact chunked regen
    (`ops/chunked_regen.py`): kernel passes of `regen_chunk` steps (the
    largest divisor of `num_steps` up to it), with the templates of the
    lanes that reset regenerated between passes in slices of
    `refresh_block` lanes (default `chunked_regen.refresh_block_size`);
    `reset_overlaps` counts the steps deferred to a re-entry pass."""
    if row_reader not in ("auto", "slices", "matmul"):
        raise ValueError(f"unknown row_reader {row_reader!r}")
    return _build_rollout(
        env, num_steps, mode, as_carry, actions_override, regen_chunk, refresh_block, run_rollout_kernel
    )


def build_packed_plain_rollout(
    env: Env,
    num_steps: int,
    mode: str = "regen",
    as_carry: bool = False,
    actions_override=None,
    regen_chunk: int = 32,
    refresh_block=None,
):
    """The plain-torch twin of `build_fused_rollout` (same surfaces and
    results), on any device."""
    return _build_rollout(
        env, num_steps, mode, as_carry, actions_override, regen_chunk, refresh_block, plain_rollout
    )
