"""The layout generators' plan loops, each one CUDA kernel plus its plain
version (counterpart of `minigrid_tpu/ops/gen_kernel.py`): RoomGrid's
`connect_all` door loop (`connect_plan_batched`, Pallas kernel
`_connect_kernel`) and MultiRoom's room-chain retry loop
(`multiroom_chain_batched`, Pallas kernel `_mr_chain_kernel`).

The connect loop.

Per lane, random unlocked doors are added until every room is reachable
from the start room, or `max_itrs` draws were made. The loop state is
bit-packed as in the JAX package: bit `j·cols + i` of one int32 per wall
slot direction (right, down, left, up) says that room `(i, j)` has a door
there, and reachability is a `rows·cols`-step shift-OR flood over those
masks. Every draw is jax.random's stream (`core/prng.py`), so the doors,
their colours and the draw count are byte-exact against the JAX package.

  * `run_connect_kernel` — the wrapper of the CUDA kernel
    `csrc/gen_kernel.cu::connect_kernel` (a group of threads a lane, one
    draw each in a window of draws, launched as `connect_plan` says). A
    CUDA tensor launches it (or the call raises); a CPU tensor runs
    `plain_connect_plan`. Nothing falls back.
  * `plain_connect_plan` — the same loop as torch ops over all lanes, one
    draw an iteration with every update gated on the lane's own
    convergence; each draw's Threefry blocks run as a few `(k, B)` calls.
    A lane that cannot connect (every slot that could still take a door
    has one, or is locked) would draw on to `max_itrs` without changing
    anything; the plain version and the kernel set its count to
    `max_itrs` at once, so such lanes cost no thousands of draws.

The JAX package switches to `vmap(connect_plan)` when `rows·cols > 30`
(the masks no longer fit an int32); no registered family gets there, and
the port raises instead.

The room-chain loop (`envs/multiroom.py::_plan`'s retry loop). Per lane,
`key, sub = split(key)` and one `_try_chain(sub)` attempt, keeping the
candidate chain when it has more rooms than the best so far, until the
best has the lane's room count or `max_attempts` attempts were made.

  * `run_mr_chain_kernel` — the wrapper of the CUDA kernel
    `csrc/gen_kernel.cu::mr_chain_kernel` (eight threads an attempt, one
    per try, one attempt in flight a lane at the start, launched as
    `mr_chain_plan` says). A CUDA tensor launches it (or the call raises);
    a CPU tensor runs `plain_mr_chain`.
  * `plain_mr_chain` — the loop as torch ops: each attempt is
    `envs/multiroom.py::_try_chain` over the lanes that have not
    converged, which is the gating `vmap`'s while-batching applies.

Both kernels' launch plans (`connect_plan`, `mr_chain_plan`: threads a
lane, lanes a block, blocks, and a refusal where no block fits an SM) are
pure Python above the card's occupancy (`mg_gen_occupancy`), so the CPU
tests check them with the occupancy given as numbers.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from minigrid_tpu_torch.core import prng
from minigrid_tpu_torch.core.state import EnvConfig
from minigrid_tpu_torch.envs import multiroom
from minigrid_tpu_torch.envs.roomgrid import COLOR_ORDER, _neighbor_idx, neighbor_exists
from minigrid_tpu_torch.ops.packing import key_rows

# Launches of the CUDA connect and room-chain kernels in this process
# (plain integers; each wrapper adds one per launch and nowhere else).
connect_kernel_launches = 0
mr_chain_kernel_launches = 0

_MAX_ROOMS = 30  # room bitmasks live in the low bits of an int32
_CHECK_EVERY = 8  # plain version: draws between host checks of "all done"

# ---------------------------------------------------------------------------
# The kernels' launch plans
# ---------------------------------------------------------------------------

GEN_BLOCK_THREADS = 256  # threads a block of both kernels (csrc/gen_kernel.cu::kGenBlockThreads)
SM_COUNT = 132  # an H100 SXM's SMs
# Threads a lane at the start of a launch: the connect kernel's two, one
# draw each a window (csrc/gen_kernel.cu::kConnectThreads); the room-chain
# kernel's eight, one attempt in flight, a thread per try (kTries). As a
# warp's lanes stop, the others take their threads. Measured
# (tools/gen_kernel_sweep.py --traffic, PERF.md §6): on phases 8's and
# 10's own launches, and at 32,768 lanes, no other start was faster beyond
# the launches' spread.
CONNECT_THREADS = 2
MR_THREADS = 8


class GenPlan(NamedTuple):
    """A launch of the connect or room-chain kernel: threads a lane at the
    start, lanes a block, blocks, blocks an SM holds at once, and the warps
    an SM runs on average over the launch's waves."""

    threads_per_lane: int
    lanes: int
    blocks: int
    blocks_per_sm: int
    warps_per_sm: float


def _gen_plan(kernel: str, b: int, threads: int, blocks_per_sm: int, sms: int) -> GenPlan:
    if b <= 0:
        raise ValueError(f"{kernel}: empty batch")
    if blocks_per_sm <= 0:
        raise ValueError(f"{kernel}: no block of {GEN_BLOCK_THREADS} threads fits an SM")
    lanes = GEN_BLOCK_THREADS // threads
    blocks = -(-b // lanes)
    warps = -(-b * threads // 32) / (sms * -(-blocks // (blocks_per_sm * sms)))
    return GenPlan(threads, lanes, blocks, blocks_per_sm, warps)


def connect_plan(rows: int, cols: int, b: int, blocks_per_sm: int, sms: int = SM_COUNT) -> GenPlan:
    """The connect kernel's launch for `b` lanes of a `rows` x `cols` room
    grid; `blocks_per_sm` is the card's occupancy (the wrapper's
    `mg_gen_occupancy`). Raises on a room grid the masks do not hold, an
    empty batch, or where no block fits an SM."""
    if rows * cols > _MAX_ROOMS:
        raise ValueError(f"connect loop: {rows}x{cols} rooms do not fit the int32 room masks")
    return _gen_plan("connect kernel", b, CONNECT_THREADS, blocks_per_sm, sms)


def mr_chain_plan(nmax: int, b: int, blocks_per_sm: int, sms: int = SM_COUNT) -> GenPlan:
    """The room-chain kernel's launch for `b` lanes of chains of at most
    `nmax` rooms, as `connect_plan`. Raises on a chain longer than the
    kernel keeps, an empty batch, or where no block fits an SM."""
    if not 1 <= nmax <= _MAX_CHAIN_ROOMS:
        raise ValueError(f"room-chain kernel: max_num_rooms {nmax} not in [1, {_MAX_CHAIN_ROOMS}]")
    return _gen_plan("room-chain kernel", b, MR_THREADS, blocks_per_sm, sms)


@functools.lru_cache(maxsize=None)
def _card_blocks_per_sm(lib, kernel: int) -> int:
    """Blocks an SM holds of the connect (`kernel` 0) or room-chain (1)
    kernel, from the card (`mg_gen_occupancy`)."""
    n = lib.mg_gen_occupancy(kernel)
    if n < 0:
        raise RuntimeError(f"generator kernel occupancy failed: CUDA error {-n} ({lib.mg_error_string(-n).decode()})")
    return n


def card_plan(kernel: int, b: int, device: torch.device, rows: int = 0, cols: int = 0, nmax: int = 0) -> GenPlan:
    """The plan the wrapper launches on `device`: the connect kernel's
    (`kernel` 0, for a `rows` x `cols` room grid) or the room-chain
    kernel's (1, for chains of at most `nmax` rooms), for `b` lanes."""
    from minigrid_tpu_torch.ops import _build

    held = _card_blocks_per_sm(_build.load_library(device), kernel)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    if kernel == 0:
        return connect_plan(rows, cols, b, held, sms)
    return mr_chain_plan(nmax, b, held, sms)


def _edges(rows: int, cols: int):
    right = sum(1 << (j * cols + cols - 1) for j in range(rows))
    left = sum(1 << (j * cols) for j in range(rows))
    return right, left


def _connected(hd, start_bit, rows: int, cols: int) -> torch.Tensor:
    """`(B,)` bool: the flood from `start_bit` over the `(4, B)` door masks
    reaches every room."""
    rc = rows * cols
    full = (1 << rc) - 1
    right, left = _edges(rows, cols)
    reach = start_bit
    for _ in range(rc):
        r = reach
        reach = (
            r
            | ((r & hd[0] & ~right) << 1)
            | ((r & hd[2] & ~left) >> 1)
            | ((r & hd[1]) << cols)
            | ((r & hd[3]) >> cols)
        ) & full
    return reach == full


def _saturated(hd, locked, rows: int, cols: int) -> torch.Tensor:
    """`(B,)` bool: no draw can add a door any more (every slot with a
    neighbour has a door, or one of its two rooms is locked)."""
    right, left = _edges(rows, cols)
    full = (1 << rows * cols) - 1
    bottom = sum(1 << ((rows - 1) * cols + i) for i in range(cols))
    top = sum(1 << i for i in range(cols))
    # Per slot: the rooms that have that neighbour, and the neighbour's lock.
    slots = (
        (full & ~right, locked >> 1),
        (full & ~bottom, locked >> cols),
        (full & ~left, locked << 1),
        (full & ~top, locked << cols),
    )
    free = torch.zeros_like(locked)
    for d, (exists, n_locked) in enumerate(slots):
        free = free | (exists & ~hd[d] & ~locked & ~n_locked)
    return (free & full) == 0


def plain_connect_plan(keys, start_i, start_j, locked_bits, hd0, rows: int, cols: int, max_itrs: int):
    """The plain version of the kernel, same arguments and results as
    `run_connect_kernel`: `keys` `(2, B)` int32 key words (bit patterns),
    `start_i`, `start_j`, `locked_bits` `(1, B)` int32, `hd0` `(4, B)`
    int32 door masks. Returns `(hd (4, B), colors (rows·cols·4, B), draws
    (1, B))`, all int32; `colors[(j·cols + i)·4 + k]` is the colour of an
    accepted door on slot k of room (i, j), else 0."""
    rc = rows * cols
    b, dev = keys.shape[1], keys.device
    key = (keys.T.to(torch.int64) & prng.MASK32).contiguous()  # (B, 2)
    hd = hd0.to(torch.int64).clone()
    locked = locked_bits[0].to(torch.int64)
    start_bit = 1 << (start_j[0].to(torch.int64) * cols + start_i[0].to(torch.int64))
    colors = torch.zeros((rc * 4, b), dtype=torch.int64, device=dev)
    draws = torch.zeros(b, dtype=torch.int64, device=dev)
    spans = torch.tensor([cols, rows, 4, 6], dtype=torch.int64, device=dev)[:, None]  # i, j, k, colour
    order = torch.tensor(COLOR_ORDER, dtype=torch.int64, device=dev)
    dirs = torch.arange(4, device=dev)[:, None]
    slots = torch.arange(rc * 4, device=dev)[:, None]
    while True:
        for _ in range(_CHECK_EVERY):
            done = _connected(hd, start_bit, rows, cols) | (draws >= max_itrs)
            children = prng.split(key, 5)  # (B, 5, 2)
            key = children[:, 0]
            i, j, k, cidx = prng.randint(children[:, 1:].transpose(0, 1), 0, spans).to(torch.int64)
            ni, nj = _neighbor_idx(i, j, k)
            nim, njm = ni % cols, nj % rows
            bit = 1 << (j * cols + i)
            nbit = 1 << (njm * cols + nim)
            nexist = neighbor_exists(rows, cols, i, j, k)
            hd_at_k = hd.gather(0, k[None])[0]
            ok = ~done & nexist & ((hd_at_k & bit) == 0) & ((locked & bit) == 0) & ((locked & nbit) == 0)
            ksym = (k + 2) % 4
            hd = hd | torch.where(ok & (dirs == k), bit, 0) | torch.where(ok & (dirs == ksym), nbit, 0)
            slot = (j * cols + i) * 4 + k
            nslot = (njm * cols + nim) * 4 + ksym
            colors = torch.where(ok & ((slots == slot) | (slots == nslot)), order[cidx], colors)
            draws = draws + (~done).long()
        stuck = ~_connected(hd, start_bit, rows, cols) & (draws < max_itrs)
        draws = torch.where(stuck & _saturated(hd, locked, rows, cols), max_itrs, draws)
        if not bool((stuck & (draws < max_itrs)).any()):
            break
    return hd.to(torch.int32), colors.to(torch.int32), draws[None].to(torch.int32)


def run_connect_kernel(keys, start_i, start_j, locked_bits, hd0, rows: int, cols: int, max_itrs: int):
    """The connect kernel's wrapper: same arguments and results as
    `plain_connect_plan`. CPU tensors run the plain version; CUDA tensors
    launch the kernel on the current stream under `connect_plan`, and any
    other device, a plan that does not fit, a failed build or a failed
    launch raises."""
    if rows * cols > _MAX_ROOMS:
        raise ValueError(f"connect loop: {rows}x{cols} rooms do not fit the int32 room masks")
    if keys.device.type == "cpu":
        return plain_connect_plan(keys, start_i, start_j, locked_bits, hd0, rows, cols, max_itrs)
    from minigrid_tpu_torch.ops import _build

    b = keys.shape[1]
    for name, x, n in (("keys", keys, 2), ("start_i", start_i, 1), ("start_j", start_j, 1),
                       ("locked_bits", locked_bits, 1), ("hd0", hd0, 4)):
        if x.device != keys.device or x.device.type != "cuda":
            raise ValueError(f"connect kernel: {name} is on {x.device}, expected {keys.device} (CUDA)")
        if x.dtype != torch.int32 or tuple(x.shape) != (n, b) or not x.is_contiguous():
            raise ValueError(f"connect kernel: {name} must be contiguous int32 {(n, b)}, got {x.dtype}{tuple(x.shape)}")
    if b == 0:
        raise ValueError("connect kernel: empty batch")
    dev = keys.device
    lib = _build.load_library(dev)
    card_plan(0, b, dev, rows=rows, cols=cols)  # raises where the launch does not fit
    hd = torch.empty((4, b), dtype=torch.int32, device=dev)
    colors = torch.empty((rows * cols * 4, b), dtype=torch.int32, device=dev)
    draws = torch.empty((1, b), dtype=torch.int32, device=dev)
    order = (ctypes.c_int * 6)(*COLOR_ORDER)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mg_connect_launch(
            *(ctypes.c_void_p(x.data_ptr()) for x in (keys, start_i, start_j, locked_bits, hd0, hd, colors, draws)),
            order, b, rows, cols, max_itrs, ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"connect kernel launch failed: CUDA error {err} ({lib.mg_error_string(err).decode()})")
    global connect_kernel_launches
    connect_kernel_launches += 1
    return hd, colors, draws


def _pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """`(B, R·C)` bool -> `(1, B)` int32 with bit r set where `mask[:, r]`."""
    bits = 1 << torch.arange(mask.shape[1], dtype=torch.int64, device=mask.device)
    return (mask.to(torch.int64) * bits).sum(dim=1, dtype=torch.int64).to(torch.int32)[None]


def connect_plan_batched(
    keys, config: EnvConfig, start_i, start_j, locked_2d, has_door0, max_itrs: int = 5000, plain: bool = False
):
    """Batched `connect_plan`, with the JAX package's arguments and results:
    `keys` `(B, 2)` key words, `start_i`/`start_j` `(B,)`, `locked_2d`
    `(B, R, C)` bool, `has_door0` `(B, R, C, 4)` bool -> `(has_door
    (B, R, C, 4) bool, colors (B, R, C, 4) uint8)`. The loop runs in the
    kernel for CUDA tensors and in the plain version for CPU tensors, or
    with `plain=True` in the plain version on any device (the plain path
    that the kernel path is held against)."""
    rows, cols = config.num_rows, config.num_cols
    b, rc = keys.shape[0], rows * cols
    hd0 = torch.cat([_pack_bits(has_door0[..., d].reshape(b, rc)) for d in range(4)])
    hd, colors, _ = (plain_connect_plan if plain else run_connect_kernel)(
        key_rows(keys),
        start_i.to(torch.int32).reshape(1, b).contiguous(),
        start_j.to(torch.int32).reshape(1, b).contiguous(),
        _pack_bits(locked_2d.reshape(b, rc)),
        hd0.contiguous(),
        rows, cols, max_itrs,
    )
    room = torch.arange(rc, dtype=torch.int32, device=hd.device)
    has_door = ((hd.T[:, :, None] >> room[None, None, :]) & 1).bool()  # (B, 4, RC)
    has_door = has_door.transpose(1, 2).reshape(b, rows, cols, 4)
    return has_door, colors.T.reshape(b, rows, cols, 4).to(torch.uint8)


# ---------------------------------------------------------------------------
# MultiRoom's room-chain retry loop
# ---------------------------------------------------------------------------

_MAX_CHAIN_ROOMS = 8  # the kernel keeps room slot r in thread r of a group of eight
_CHAIN_FIELDS = 6  # top x, top y, size x, size y, entry x, entry y


def plain_mr_chain(keys, num_rooms, config: EnvConfig, max_attempts: int):
    """The plain version of the kernel, same arguments and results as
    `run_mr_chain_kernel`: `keys` `(2, B)` int32 key words (bit patterns,
    `_plan`'s retry key), `num_rooms` `(1, B)` int32. Returns `(rooms
    (6, nmax, B), count (1, B), attempts (1, B), rows (1, B))`, all
    int32: per room slot its top x, top y, size x, size y, entry x and
    entry y (zeros past the chain's count), the best chain's room count,
    the attempts the lane made, and the key rows its attempts needed
    (`envs/multiroom.py::_try_chain`; the kernel counts just those)."""
    nmax = config.max_num_rooms
    b, dev = keys.shape[1], keys.device
    key = (keys.T.to(torch.int64) & prng.MASK32).contiguous()  # (B, 2)
    nr = num_rooms[0].to(torch.int64)
    rooms = torch.zeros((_CHAIN_FIELDS, nmax, b), dtype=torch.int32, device=dev)
    count = torch.zeros(b, dtype=torch.int64, device=dev)
    attempts = torch.zeros(b, dtype=torch.int64, device=dev)
    rows = torch.zeros(b, dtype=torch.int64, device=dev)
    while True:
        idx = torch.nonzero((count < nr) & (attempts < max_attempts)).flatten()
        if idx.numel() == 0:  # reading the count waits on the device
            break
        children = prng.split(key[idx], 2)
        key[idx] = children[:, 0]
        cand, used = multiroom._try_chain(children[:, 1], config, nr[idx])
        better = cand.count.to(torch.int64) > count[idx]
        fields = torch.cat([cand.tops, cand.sizes, cand.entry], dim=2).permute(2, 1, 0)  # (6, nmax, n)
        rooms[:, :, idx] = torch.where(better, fields, rooms[:, :, idx])
        count[idx] = torch.where(better, cand.count.to(torch.int64), count[idx])
        attempts[idx] += 1
        rows[idx] += used
    return rooms, count[None].to(torch.int32), attempts[None].to(torch.int32), rows[None].to(torch.int32)


def run_mr_chain_kernel(keys, num_rooms, config: EnvConfig, max_attempts: int):
    """The room-chain kernel's wrapper: same arguments and results as
    `plain_mr_chain`. CPU tensors run the plain version; CUDA tensors
    launch the kernel on the current stream under `mr_chain_plan`, and any
    other device, a chain longer than the kernel keeps, a plan that does
    not fit, a failed build or a failed launch raises."""
    if keys.device.type == "cpu":
        return plain_mr_chain(keys, num_rooms, config, max_attempts)
    from minigrid_tpu_torch.ops import _build

    if not 1 <= config.max_num_rooms <= _MAX_CHAIN_ROOMS:
        raise ValueError(f"room-chain kernel: max_num_rooms {config.max_num_rooms} not in [1, {_MAX_CHAIN_ROOMS}]")
    b = keys.shape[1]
    for name, x, n in (("keys", keys, 2), ("num_rooms", num_rooms, 1)):
        if x.device != keys.device or x.device.type != "cuda":
            raise ValueError(f"room-chain kernel: {name} is on {x.device}, expected {keys.device} (CUDA)")
        if x.dtype != torch.int32 or tuple(x.shape) != (n, b) or not x.is_contiguous():
            raise ValueError(f"room-chain kernel: {name} must be contiguous int32 {(n, b)}, got {x.dtype}{tuple(x.shape)}")
    if b == 0:
        raise ValueError("room-chain kernel: empty batch")
    dev = keys.device
    lib = _build.load_library(dev)
    nmax = config.max_num_rooms
    card_plan(1, b, dev, nmax=nmax)  # raises where the launch does not fit
    rooms = torch.empty((_CHAIN_FIELDS, nmax, b), dtype=torch.int32, device=dev)
    count = torch.empty((1, b), dtype=torch.int32, device=dev)
    attempts = torch.empty((1, b), dtype=torch.int32, device=dev)
    rows = torch.empty((1, b), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mg_mr_chain_launch(
            *(ctypes.c_void_p(x.data_ptr()) for x in (keys, num_rooms, rooms, count, attempts, rows)),
            b, config.width, config.height, nmax, config.max_room_size, max_attempts, ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"room-chain kernel launch failed: CUDA error {err} ({lib.mg_error_string(err).decode()})")
    global mr_chain_kernel_launches
    mr_chain_kernel_launches += 1
    return rooms, count, attempts, rows


def multiroom_chain_batched(retry_keys, num_rooms, config: EnvConfig, max_attempts: int, plain: bool = False):
    """The room-chain loop with the JAX package's arguments and results:
    `retry_keys` `(B, 2)` key words (`_plan`'s `ks[1]`), `num_rooms`
    `(B,)` -> `(tops (B, nmax, 2), sizes, entry, count (B,))` int32. The
    loop runs in the kernel for CUDA tensors and in the plain version for
    CPU tensors, or with `plain=True` in the plain version on any device."""
    b = retry_keys.shape[0]
    rooms, count, _, _ = (plain_mr_chain if plain else run_mr_chain_kernel)(
        key_rows(retry_keys), num_rooms.to(torch.int32).reshape(1, b).contiguous(), config, max_attempts
    )
    rooms = rooms.permute(2, 1, 0)  # (B, nmax, 6)
    return rooms[..., 0:2], rooms[..., 2:4], rooms[..., 4:6], count[0]
