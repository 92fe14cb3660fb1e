"""Multi-room (counterpart of `minigrid_tpu/envs/multiroom.py`).

A chain of `min_num_rooms..max_num_rooms` rooms of random size at most
`max_room_size`, each joined to the one before by a closed door whose
colour differs from the previous door's; the agent starts in the first
room and the goal lies in the last. The reference's recursive
`_placeRoom` is a linear chain in the JAX package: for each next room up
to 8 draws of (exit wall, exit position, size, offset), the first that
fits wins; whole attempts are retried from fresh keys, keeping the
longest chain, until the chain has the lane's room count
(`MAX_ATTEMPTS` at most).

`generate_packed` is the generator: `_plan_batched` draws with the JAX
package's exact `jax.random` call tree (the retry loop in the room-chain
kernel, `ops/gen_kernel.py`), then the rooms, doors, agent and goal are
painted into the packed `(HW, B)` words. `generate` unpacks its result;
the JAX package asserts that its own `generate_packed` equals
`_pack_rolled(vmap(generate))` byte for byte, so the port has no scalar
generator. MultiRoom runs the base transition.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import prng, sampling
from minigrid_tpu_torch.core.state import AUX_LEN, MISSION_LEN, EnvConfig, EnvState
from minigrid_tpu_torch.envs import missions
from minigrid_tpu_torch.envs.roomgrid import COLOR_ORDER
from minigrid_tpu_torch.ops import gen_kernel
from minigrid_tpu_torch.ops import packed_gen as PG
from minigrid_tpu_torch.ops.packing import WALL_WORD

MISSION = missions.register_template("traverse the rooms to get to the goal")

MAX_ATTEMPTS = 200  # the retry bound (the reference loops without one)
_MIN_ROOM = 4
_TRIES = 8  # draws per room before the attempt gives up on it


class Chain(NamedTuple):
    tops: torch.Tensor  # (B, nmax, 2) int32
    sizes: torch.Tensor  # (B, nmax, 2) int32
    entry: torch.Tensor  # (B, nmax, 2) int32: the entry door of rooms 1..count-1
    count: torch.Tensor  # (B,) int32


class Plan(NamedTuple):
    """What `generate_packed` decides before it paints: the room chain,
    the door colours and the grid-dependent sampling keys (the JAX
    package's `Plan`, batched)."""

    k_reset: torch.Tensor  # (B, 2) int64: the state's reset-chain key
    chain: Chain
    door_colors: torch.Tensor  # (B, nmax) uint8 (slot i valid for 1 <= i < count)
    k_agent: torch.Tensor  # (B, 2) int64
    agent_dir: torch.Tensor  # (B,) int32
    k_goal: torch.Tensor  # (B, 2) int64


def _select4(sel, v0, v1, v2, v3):
    return torch.where(sel == 0, v0, torch.where(sel == 1, v1, torch.where(sel == 2, v2, v3)))


def _try_chain(keys: torch.Tensor, config: EnvConfig, num_rooms: torch.Tensor):
    """One attempt at a room chain per row of the `(B, 2)` key tensor,
    draw for draw the JAX package's `_try_chain`: `split(key, 3 + 40·nmax)`,
    rows 0-3 the first room's entry point and size, then per room i and
    try t the five rows from `4 + 5·(8·(i − 1) + t)`: exit wall, exit
    position (x and y from the same key), child size x, y and offset.
    Returns `(Chain, rows (B,) int32)`: `rows` counts the rows the
    attempt needs, those of the first room and of each try up to the
    first that fits in each room the chain tries to place.

    The tries of a room all see the entry wall from before the room, so
    they are drawn together, `(8, B)` at a time, and the first that fits
    wins: the reference's sequential tries change nothing before then."""
    w, h = config.width, config.height
    nmax, max_sz = config.max_num_rooms, config.max_room_size
    b, dev = keys.shape[0], keys.device
    rows = 4 + 5 * _TRIES * (nmax - 1)
    r = torch.arange(rows, dtype=torch.int64, device=dev)[:, None]
    y0, y1 = prng.threefry2x32(keys[:, 0][None, :], keys[:, 1][None, :], 0, r)
    hi_bits, lo_bits = prng.randint_bits(torch.stack([y0, y1], dim=-1))  # (rows, B)

    def draw(row, lo, hi):
        return prng.randint_from_bits(hi_bits[row], lo_bits[row], lo, hi)

    ex, ey = draw(0, 0, w - 2), draw(1, 0, w - 2)  # ey over w - 2, as the reference draws it
    sx, sy = draw(2, _MIN_ROOM, max_sz + 1), draw(3, _MIN_ROOM, max_sz + 1)
    zero = torch.zeros(b, dtype=torch.int32, device=dev)
    tx, ty, sxs, sys_, exs, eys = ([v] + [zero] * (nmax - 1) for v in (ex, ey, sx, sy, ex, ey))
    count = torch.where((ex + sx <= w) & (ey + sy < h), 1, 0).to(torch.int32)
    entry_wall = torch.full((b,), 2, dtype=torch.int32, device=dev)
    tries = torch.arange(_TRIES, device=dev)
    used = torch.full((b,), 4, dtype=torch.int32, device=dev)
    for i in range(1, nmax):
        ptx, pty, psx, psy = tx[i - 1], ty[i - 1], sxs[i - 1], sys_[i - 1]
        need = (count == i) & (i < num_rooms)
        base = 4 + 5 * (_TRIES * (i - 1) + tries)  # (8,) first row of each try
        rr = draw(base, 0, 3)
        exit_wall = torch.where(rr >= entry_wall, rr + 1, rr)
        rx = draw(base + 1, 1, torch.clamp(psx - 1, min=2))
        ry = draw(base + 1, 1, torch.clamp(psy - 1, min=2))
        exit_x = _select4(exit_wall, ptx + psx - 1, ptx + rx, ptx, ptx + rx)
        exit_y = _select4(exit_wall, pty + ry, pty + psy - 1, pty + ry, pty)
        new_wall = (exit_wall + 2) % 4
        csx = draw(base + 2, _MIN_ROOM, max_sz + 1)
        csy = draw(base + 3, _MIN_ROOM, max_sz + 1)
        off_hi = torch.clamp(torch.where((new_wall == 0) | (new_wall == 2), csy - 2, csx - 2), min=1)
        off = draw(base + 4, 0, off_hi)
        ctx = _select4(new_wall, exit_x - csx + 1, exit_x - csx + 2 + off, exit_x, exit_x - csx + 2 + off)
        cty = _select4(new_wall, exit_y - csy + 2 + off, exit_y - csy + 1, exit_y - csy + 2 + off, exit_y)
        ok = need & (ctx >= 0) & (cty >= 0) & (ctx + csx <= w) & (cty + csy < h)
        for j in range(i - 1):  # strict overlap with every room but the parent
            apart = (ctx + csx < tx[j]) | (tx[j] + sxs[j] <= ctx) | (cty + csy < ty[j]) | (ty[j] + sys_[j] <= cty)
            ok = ok & apart
        placed = ok.any(dim=0)
        first = ok.to(torch.int32).argmax(dim=0, keepdim=True)  # the first try that fits

        def pick(v):
            return torch.where(placed, v.gather(0, first)[0], zero)

        tx[i], ty[i], sxs[i], sys_[i], exs[i], eys[i] = (pick(v) for v in (ctx, cty, csx, csy, exit_x, exit_y))
        entry_wall = torch.where(placed, new_wall.gather(0, first)[0], entry_wall)
        used = used + torch.where(need, 5 * torch.where(placed, first[0].to(torch.int32) + 1, _TRIES), 0)
        count = torch.where(placed, i + 1, count).to(torch.int32)
    stack = lambda a, c: torch.stack([torch.stack(a, 1), torch.stack(c, 1)], 2)  # noqa: E731
    return Chain(stack(tx, ty), stack(sxs, sys_), stack(exs, eys), count), used.to(torch.int32)


def _door_colors(keys: torch.Tensor, n: torch.Tensor, nmax: int) -> torch.Tensor:
    """Entry-door colours `(B, nmax)` uint8, each distinct from the one
    before, drawn in sorted-colour-name coordinates: the JAX package's
    `_door_colors` (slot i is written for every i, valid for i < n)."""
    b, dev = keys.shape[0], keys.device
    door_keys = prng.split(keys, nmax)
    order = torch.tensor(COLOR_ORDER, dtype=torch.uint8, device=dev)
    prev = torch.full((b,), -1, dtype=torch.int32, device=dev)
    colors = torch.zeros((b, nmax), dtype=torch.uint8, device=dev)
    for i in range(1, nmax):
        hi_bits, lo_bits = prng.randint_bits(door_keys[:, i])
        r6 = prng.randint_from_bits(hi_bits, lo_bits, 0, 6)
        r5 = prng.randint_from_bits(hi_bits, lo_bits, 0, 5)
        pick = torch.where(prev >= 0, torch.where(r5 >= prev, r5 + 1, r5), r6)
        colors[:, i] = order[pick.long()]
        prev = torch.where(i < n, pick, prev)
    return colors


def _plan_batched(keys: torch.Tensor, config: EnvConfig, plain: bool = False) -> Plan:
    """The batched `_plan` on `(B, 2)` keys: the JAX package's outer draws
    around the room-chain retry loop, which runs in the kernel for CUDA
    tensors and in its plain version for CPU tensors or with `plain=True`."""
    key, k_reset = prng.split(keys, 2).unbind(1)
    ks = prng.split(key, 6).unbind(1)
    num_rooms = prng.randint(ks[0], config.min_num_rooms, config.max_num_rooms + 1)
    tops, sizes, entry, count = gen_kernel.multiroom_chain_batched(ks[1], num_rooms, config, MAX_ATTEMPTS, plain=plain)
    return Plan(
        k_reset=k_reset,
        chain=Chain(tops, sizes, entry, count),
        door_colors=_door_colors(ks[2], count, config.max_num_rooms),
        k_agent=ks[3],
        agent_dir=sampling.sample_direction(ks[4]),
        k_goal=ks[5],
    )


def generate_packed(keys: torch.Tensor, config: EnvConfig, plain: bool = False):
    """One layout per row of the `(B, 2)` key tensor, as `(agent-centred
    words (HW, B), regs (NUM_REGS, B))` int32, on `keys.device`."""
    w, h = config.width, config.height
    nmax = config.max_num_rooms
    b, dev = keys.shape[0], keys.device
    plan = _plan_batched(keys, config, plain)
    tops, sizes, entry, n = plan.chain

    xs, ys = PG.xy_iota(h, w, dev)
    words = PG.empty_words(h, w, b, dev)
    for i in range(nmax):  # the rooms' walls
        words = PG.outline_rect_words(
            words, xs, ys, tops[:, i, 0], tops[:, i, 1], sizes[:, i, 0], sizes[:, i, 1], WALL_WORD, active=i < n
        )
    for i in range(1, nmax):  # the entry doors
        word = PG.cell_word(C.DOOR, plan.door_colors[:, i].to(torch.int32), C.STATE_CLOSED)
        words = PG.set_cell_words(words, xs, ys, entry[:, i, 0], entry[:, i, 1], word, active=i < n)

    # The agent in the first room, the goal in the last.
    mask0 = PG.rect_mask_words(xs, ys, tops[:, 0, 0], tops[:, 0, 1], sizes[:, 0, 0], sizes[:, 0, 1])
    ax, ay = PG.sample_cell_words(plan.k_agent, PG.free_mask_words(words, xs, ys) & mask0, w)
    lanes = torch.arange(b, device=dev)
    last = torch.clamp(n - 1, min=0).long()
    tl, sl = tops[lanes, last], sizes[lanes, last]
    maskl = PG.rect_mask_words(xs, ys, tl[:, 0], tl[:, 1], sl[:, 0], sl[:, 1])
    gx, gy = PG.sample_cell_words(plan.k_goal, PG.free_mask_words(words, xs, ys, ax, ay) & maskl, w)
    words = PG.set_cell_words(words, xs, ys, gx, gy, PG.GOAL_WORD)

    mission = torch.zeros((b, MISSION_LEN), dtype=torch.int32, device=dev)
    mission[:, 0] = MISSION
    aux = torch.zeros((b, AUX_LEN), dtype=torch.int32, device=dev)
    regs = PG.build_regs(b, ax, ay, plan.agent_dir, plan.k_reset, mission=mission, aux=aux)
    return PG.finish_packed(words, regs, w)


def generate(keys: torch.Tensor, config: EnvConfig) -> EnvState:
    """One state per row of the `(B, 2)` key tensor: `generate_packed`,
    unrolled and unpacked."""
    from minigrid_tpu_torch.ops.fused_rollout import _unpack_rolled

    return _unpack_rolled(config, *generate_packed(keys, config))
