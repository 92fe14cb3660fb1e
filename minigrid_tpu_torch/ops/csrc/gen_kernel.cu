// The layout generators' plan loops for Hopper (sm_90a): RoomGrid's
// connect_all door loop (connect_kernel) and MultiRoom's room-chain retry
// loop (mr_chain_kernel). Both draw jax.random's exact streams: a split
// child is both words of threefry2x32(k0, k1, 0, c); randint(key, lo, hi)
// is lo + ((bits(k1) mod n) * ((2^16 mod n)^2 mod n) + bits(k2) mod n)
// mod n for the span n = hi - lo (1 where hi <= lo), with (k1, k2) =
// split(key) and bits(k) = x0 ^ x1 of threefry2x32(k, 0, 0). All of it is
// uint32 arithmetic, so unsigned `%` and `>>` need no sign fix-up.
//
// Both kernels give each lane a group of threads; a group never straddles
// a warp, so its votes and shuffles take the group's own lane mask. A
// warp keeps its lanes' loop state in shared memory between steps, and as
// its lanes stop, the threads of the stopped ones join the others: with n
// lanes still running each takes 32 / p threads, p the least power of two
// at least n. A warp so runs until its lanes' work is done, not as long as
// its slowest lane alone at its first width. Each kernel starts at one
// width, the one measured fastest on the main path's own launches and at
// 32,768 lanes (tools/gen_kernel_sweep.py --traffic). The wrappers' plans
// (ops/gen_kernel.py::connect_plan, mr_chain_plan) check that a block fits
// an SM (mg_gen_occupancy).
//
// connect_kernel replaces the TPU kernel
// minigrid_tpu/ops/gen_kernel.py::_connect_kernel. Per lane it runs
// `connect_all`'s randomized loop on bit-packed room state: while the
// rooms reachable from the start room (a shift-OR flood over the four door
// bitmasks) are not all rooms and fewer than max_itrs draws were made, one
// draw: `key, k_i, k_j, k_k, k_c = split(key, 5)`, four randints (room
// column i, row j, wall slot k, colour index), and an unlocked door on
// slot k of room (i, j) (registered on both rooms) if that neighbour
// exists, the slot has no door yet and neither room is locked. Outputs are
// the final door bitmasks, the colour of each accepted door slot, and the
// lane's draw count. The neighbour index wraps as (ni + cols) % cols,
// whose operand is never negative.
//
// What bounds it on the card: integer operations. A draw is 21 Threefry
// blocks (about 80 operations each) plus the randint reductions, the door
// test and the flood (chip_smoke.py's CONNECT_OPS_* count that work),
// against 48 bytes of lane state in and out. The draw counts are
// data-dependent (KeyCorridorS6R3's generator at B = 32,768: a mean of
// 24.1, a max of 160), and a warp runs until its slowest lane has stopped.
//
// Design: of a draw's 21 blocks only one is serial. The chain key (child 0
// of split(key, 5)) advances on every draw whatever the draw does; i, j, k
// and the colour depend on that draw's key alone; only the door test
// depends on the loop's state. So a lane's group of W threads takes its
// draws W at a time, a window: every thread walks the chain W steps, one
// block a step, and keeps the key of its own draw, then draws that draw's
// four randints (20 blocks of independent work). The group scans the
// window in draw order on the door masks, which each of its threads holds
// alike: a vote keeps the draws that could take a door on the masks at the
// window's start (a slot with a door keeps it), and each of those is
// tested again in order, since an earlier one may have taken its slot.
// Reachability changes only when a door is added, so the flood (to its
// fixed point, from the rooms already reached) runs only after an
// accepted door. A lane stops at connection, at max_itrs, or when no slot
// can take a door any more (ops/gen_kernel.py::_saturated: the loop would
// draw on to max_itrs and change nothing, so it reports max_itrs); draws of
// the window past the stop are not counted. A lane starts with W = 2
// threads and takes more as the warp's other lanes stop, up to 32 (a
// window of 32 draws). The slowest lane's serial path falls from 21 blocks
// a draw to about one (the walk) and 20 / W.
//
// mr_chain_kernel replaces the TPU kernel
// minigrid_tpu/ops/gen_kernel.py::_mr_chain_kernel: envs/multiroom.py's
// `_plan` retry loop. Per attempt `key, sub = split(key)`; row r of the
// attempt's keys is threefry2x32(sub, 0, r). Rows 0-3 draw the first
// room's entry point (x and y both over width - 2, as the reference draws
// them) and size; then for each room i that the chain still needs, up to
// 8 tries of five rows from 4 + 5 * (8 * (i - 1) + t): the exit wall over
// the three walls other than the entry wall, the exit position (x and y
// from the same row, over the parent's own spans), the child's size and
// its offset along the entry wall. The first try that lies inside the
// grid and overlaps no room but its parent places the room. A candidate
// chain replaces the best only when it has more rooms; the loop stops at
// the lane's room count or max_attempts. Outputs: the best chain's six
// fields per room slot (zeros past its count), its count, the attempts
// and the key rows a lazy loop draws (byte-exact against
// ops/gen_kernel.py::plain_mr_chain, which counts the same rows).
//
// What bounds it: integer operations, about 400 a key row (5 Threefry
// blocks and the reduction) plus the tests (chip_smoke.py's MR_OPS_*),
// against 12 bytes in and 4 * (6 * nmax + 3) out a lane. Attempts a lane
// are data-dependent (MultiRoom-N4-S5: mean 1.49, max 9; N6: mean 4.61,
// max 40), and a warp runs until its slowest lane has stopped.
//
// Design: a key row is a pure function of the attempt's key and a row
// index that (room, try) fixes, so the tries of a room are independent
// once the parent room is placed, and attempts are independent once their
// keys are known. An attempt is a group of eight threads: thread t draws
// try t's five rows (25 blocks) and tests it, against the rooms but the
// parent, which thread j holds as room j and shares by shuffle; the group
// takes the lowest try that fits by a vote. Threads 0-3 draw the first
// room's four rows, one each. The rows are counted as the lazy loop draws
// them: 4 for the first room, 5 (t + 1) for a room whose first fitting try
// is t, 40 where none fits (the attempt ends there). A lane runs A groups
// at once (A = 1 at the start, more as the warp's other lanes stop, up to
// the warp's four), attempts n .. n + A - 1, their keys from a
// walk of the retry chain (two blocks an attempt: the only serial part
// across attempts); it then takes the round's attempts in order: the first
// that reaches the lane's count stops it and later ones are dropped, and
// until then the best chain is the first with the most rooms. The group
// whose chain is the best writes it to the lane's slot in shared memory.
// The slowest lane's serial path falls from up to 8 * 25 blocks a room to
// about 25, and its attempts run A at a time.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

// The threads a connect lane starts with (ops/gen_kernel.py::CONNECT_THREADS)
// and the attempts a room-chain lane starts with in flight, eight threads
// each (MR_THREADS). tools/gen_kernel_sweep.py builds this file alone with
// others (-DMG_CONNECT_THREADS=W, -DMG_CHAIN_ATTEMPTS=A) to time them.
#ifndef MG_CONNECT_THREADS
#define MG_CONNECT_THREADS 2
#endif
#ifndef MG_CHAIN_ATTEMPTS
#define MG_CHAIN_ATTEMPTS 1
#endif

constexpr int kGenBlockThreads = 256;  // ops/gen_kernel.py::GEN_BLOCK_THREADS
constexpr int kConnectThreads = MG_CONNECT_THREADS;
constexpr int kChainAttempts = MG_CHAIN_ATTEMPTS;
static_assert(kConnectThreads == 1 || kConnectThreads == 2 || kConnectThreads == 4 || kConnectThreads == 8,
              "a connect lane starts with 1, 2, 4 or 8 threads");
static_assert(kChainAttempts == 1 || kChainAttempts == 2 || kChainAttempts == 4,
              "a room-chain lane starts with 1, 2 or 4 attempts in flight");

__device__ __forceinline__ uint32_t bits_of(uint2 k) {
  const uint2 r = threefry2x32(k.x, k.y, 0u, 0u);
  return r.x ^ r.y;
}

// The two words randint reduces: bits of the two children of split(key).
struct RandBits {
  uint32_t higher, lower;
};

__device__ __forceinline__ RandBits randint_bits(uint2 key) {
  return {bits_of(threefry2x32(key.x, key.y, 0u, 0u)), bits_of(threefry2x32(key.x, key.y, 0u, 1u))};
}

// randint's reduction to [0, n) for a small span n >= 1.
__device__ __forceinline__ uint32_t reduce_span(RandBits r, uint32_t n) {
  const uint32_t m = (65536u % n) * (65536u % n) % n;
  return ((r.higher % n) * m + r.lower % n) % n;
}

// jax.random.randint(key, (), 0, n) for a small span n >= 1.
__device__ __forceinline__ uint32_t randint_span(uint2 key, uint32_t n) {
  return reduce_span(randint_bits(key), n);
}

// randint(key, (), lo, hi) from the key's two words (span 1 where hi <= lo).
__device__ __forceinline__ int randint_range(RandBits r, int lo, int hi) {
  return lo + static_cast<int>(reduce_span(r, hi <= lo ? 1u : static_cast<uint32_t>(hi - lo)));
}

// The `width` threads of a warp from thread `base` (width a power of two).
__device__ __forceinline__ unsigned span_mask(int width, int base) {
  return width == 32 ? 0xffffffffu : ((1u << width) - 1u) << base;
}

// The least power of two at least n, for 1 <= n <= 32.
__device__ __forceinline__ int pow2_ceil(int n) { return n <= 1 ? 1 : 1 << (32 - __clz(n - 1)); }

// The index of set bit i (from 0) of `mask`.
__device__ __forceinline__ int nth_bit(unsigned mask, int i) {
  for (int q = 0; q < i; ++q) mask &= mask - 1;
  return __ffs(mask) - 1;
}

// ---------------------------------------------------------------------------
// connect_kernel
// ---------------------------------------------------------------------------

// The room grid's masks: all rooms, and those on each edge.
struct RoomGrid {
  uint32_t full, right, left, bottom, top;
  int cols;
};

// The door mask of slot direction k (0 right, 1 down, 2 left, 3 up),
// selected without indexing, so the masks stay in registers.
__device__ __forceinline__ uint32_t dir_mask(const uint32_t (&hd)[4], uint32_t k) {
  return k == 0 ? hd[0] : k == 1 ? hd[1] : k == 2 ? hd[2] : hd[3];
}

// The flood from `reach` over the door masks to its fixed point: the rooms
// reachable from it. From any subset of the start room's component that
// holds the start room it ends where the rows*cols-step flood from the
// start room does.
__device__ __forceinline__ uint32_t flood(uint32_t reach, const uint32_t (&hd)[4], const RoomGrid& g) {
  uint32_t prev;
  do {
    prev = reach;
    reach = (reach | ((reach & hd[0] & ~g.right) << 1) | ((reach & hd[2] & ~g.left) >> 1) |
             ((reach & hd[1]) << g.cols) | ((reach & hd[3]) >> g.cols)) &
            g.full;
  } while (reach != prev);
  return reach;
}

// No draw can add a door any more: every slot that has a neighbour has a
// door, or one of its two rooms is locked (ops/gen_kernel.py::_saturated).
__device__ __forceinline__ bool saturated(const uint32_t (&hd)[4], uint32_t locked, const RoomGrid& g) {
  const uint32_t open = ~locked;
  const uint32_t free = (~g.right & ~hd[0] & open & ~(locked >> 1)) |
                        (~g.bottom & ~hd[1] & open & ~(locked >> g.cols)) |
                        (~g.left & ~hd[2] & open & ~(locked << 1)) | (~g.top & ~hd[3] & open & ~(locked << g.cols));
  return (free & g.full) == 0;
}

// One draw's four randints from its key (children 1-4 of split(key, 5)):
// room column i, row j, slot k and colour index c, packed as
// i | j << 5 | k << 10 | c << 12 (rows and cols are at most 30).
__device__ __forceinline__ uint32_t draw_of(uint2 key, uint32_t rows, uint32_t cols) {
  const uint32_t i = randint_span(threefry2x32(key.x, key.y, 0u, 1u), cols);
  const uint32_t j = randint_span(threefry2x32(key.x, key.y, 0u, 2u), rows);
  const uint32_t k = randint_span(threefry2x32(key.x, key.y, 0u, 3u), 4u);
  const uint32_t c = randint_span(threefry2x32(key.x, key.y, 0u, 4u), 6u);
  return i | j << 5 | k << 10 | c << 12;
}

// A draw's door: its room's bit and slot, its neighbour's, and whether the
// neighbour exists.
struct Door {
  uint32_t bit, nbit, k, ksym;
  int slot, nslot;
  bool nexist;
};

__device__ __forceinline__ Door door_of(uint32_t draw, int rows, int cols) {
  const int i = static_cast<int>(draw & 31u), j = static_cast<int>((draw >> 5) & 31u);
  const int k = static_cast<int>((draw >> 10) & 3u);
  const int ni = i + (k == 0) - (k == 2);
  const int nj = j + (k == 1) - (k == 3);
  const int nim = (ni + cols) % cols;
  const int njm = (nj + rows) % rows;
  Door d;
  d.nexist = (k == 0 && i < cols - 1) || (k == 1 && j < rows - 1) || (k == 2 && i > 0) || (k == 3 && j > 0);
  d.bit = 1u << (j * cols + i);
  d.nbit = 1u << (njm * cols + nim);
  d.k = static_cast<uint32_t>(k);
  d.ksym = static_cast<uint32_t>((k + 2) % 4);
  d.slot = (j * cols + i) * 4 + k;
  d.nslot = (njm * cols + nim) * 4 + static_cast<int>(d.ksym);
  return d;
}

// A lane of the connect loop between windows, in shared memory, so that
// whichever group of the warp takes it next finds it there.
struct ConnectLane {
  uint32_t key0, key1;  // the chain key of the lane's next draw
  uint32_t hd[4];
  uint32_t reach, locked;
  int itrs, done;
};

__global__ void __launch_bounds__(kGenBlockThreads)
    connect_kernel(const int32_t* __restrict__ key, const int32_t* __restrict__ start_i,
                   const int32_t* __restrict__ start_j, const int32_t* __restrict__ locked_bits,
                   const int32_t* __restrict__ hd0, int32_t* __restrict__ hd_out, int32_t* __restrict__ colors_out,
                   int32_t* __restrict__ draws_out, int B, int rows, int cols, int max_itrs, uint32_t order) {
  constexpr int L = 32 / kConnectThreads;  // lanes a warp
  __shared__ ConnectLane lanes[kGenBlockThreads / 32][L];
  const int wl = static_cast<int>(threadIdx.x) & 31;
  ConnectLane* st = lanes[threadIdx.x / 32];
  const int first = static_cast<int>((blockIdx.x * kGenBlockThreads + threadIdx.x) / 32) * L;  // the warp's lanes
  const size_t Bs = static_cast<size_t>(B);
  const int rc = rows * cols;
  RoomGrid g{(1u << rc) - 1u, 0u, 0u, 0u, 0u, cols};
  for (int j = 0; j < rows; ++j) {
    g.right |= 1u << (j * cols + cols - 1);
    g.left |= 1u << (j * cols);
  }
  for (int i = 0; i < cols; ++i) {
    g.top |= 1u << i;
    g.bottom |= 1u << ((rows - 1) * cols + i);
  }
  {  // set-up: group s of kConnectThreads threads takes lane first + s
    const int s = wl / kConnectThreads, r = wl % kConnectThreads, lane = first + s;
    if (lane < B) {
      const uint32_t locked = static_cast<uint32_t>(locked_bits[lane]);
      uint32_t hd[4];
#pragma unroll
      for (int d = 0; d < 4; ++d) hd[d] = static_cast<uint32_t>(hd0[d * Bs + lane]);
      for (int q = r; q < rc * 4; q += kConnectThreads) colors_out[q * Bs + lane] = 0;
      const uint32_t reach = flood(1u << (start_j[lane] * cols + start_i[lane]), hd, g);
      int itrs = 0;
      bool done = reach == g.full || max_itrs <= 0;
      if (!done && saturated(hd, locked, g)) {
        itrs = max_itrs;
        done = true;
      }
      if (r == 0) {
        st[s] = ConnectLane{static_cast<uint32_t>(key[lane]), static_cast<uint32_t>(key[Bs + lane]),
                            {hd[0], hd[1], hd[2], hd[3]}, reach, locked, itrs, done};
      }
    } else if (r == 0) {
      st[s].done = 1;
    }
  }
  __syncwarp();
  for (;;) {
    unsigned active = 0;
#pragma unroll
    for (int s = 0; s < L; ++s) active |= st[s].done ? 0u : 1u << s;
    if (active == 0) break;
    const int n = __popc(active);
    const int width = 32 / pow2_ceil(n);  // the threads, and draws, each lane takes this window
    const int grp = wl / width, r = wl % width, base = grp * width;
    const bool owner = grp < n;  // the groups past the n-th shadow the last lane and write nothing
    const int s = nth_bit(active, min(grp, n - 1));
    const int lane = first + s;
    const ConnectLane me = st[s];
    uint32_t hd[4] = {me.hd[0], me.hd[1], me.hd[2], me.hd[3]};
    uint2 k = make_uint2(me.key0, me.key1), mine = k;
    for (int d = 0; d < width; ++d) {  // the chain: one block a draw, the key of draw r kept
      mine = d == r ? k : mine;
      k = threefry2x32(k.x, k.y, 0u, 0u);
    }
    const uint32_t draw = draw_of(mine, static_cast<uint32_t>(rows), static_cast<uint32_t>(cols));
    const int span = min(width, max_itrs - me.itrs);
    const Door own = door_of(draw, rows, cols);
    const bool could = r < span && own.nexist && (me.locked & own.bit) == 0 && (me.locked & own.nbit) == 0 &&
                       (dir_mask(hd, own.k) & own.bit) == 0;
    const unsigned gmask = span_mask(width, base);
    unsigned cand = (__ballot_sync(0xffffffffu, could) & gmask) >> base;
    uint32_t reach = me.reach;
    int stop = -1;  // the window's draw after which the lane stops
    bool stuck = false;
    while (cand != 0) {
      const int d = __ffs(cand) - 1;
      cand &= cand - 1;
      const uint32_t dd = __shfl_sync(gmask, draw, base + d);
      const Door door = door_of(dd, rows, cols);
      if ((dir_mask(hd, door.k) & door.bit) != 0) continue;  // an earlier draw took the slot
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hd[e] |= (door.k == static_cast<uint32_t>(e) ? door.bit : 0u) |
                 (door.ksym == static_cast<uint32_t>(e) ? door.nbit : 0u);
      }
      if (owner && r == 0) {
        const int32_t color = static_cast<int32_t>((order >> (4u * ((dd >> 12) & 7u))) & 15u);
        colors_out[static_cast<size_t>(door.slot) * Bs + lane] = color;
        colors_out[static_cast<size_t>(door.nslot) * Bs + lane] = color;
      }
      reach = flood(reach, hd, g);
      if (reach == g.full) {
        stop = d;
        break;
      }
      if (saturated(hd, me.locked, g)) {  // no later draw changes anything: the loop runs to max_itrs
        stuck = true;
        break;
      }
    }
    const int itrs = stuck ? max_itrs : stop >= 0 ? me.itrs + stop + 1 : me.itrs + span;
    __syncwarp();  // every group has read its lane
    if (owner && r == 0) {
      st[s] = ConnectLane{k.x, k.y, {hd[0], hd[1], hd[2], hd[3]}, reach, me.locked, itrs,
                          stuck || stop >= 0 || itrs >= max_itrs};
    }
    __syncwarp();
  }
  if (wl < L && first + wl < B) {
    const int lane = first + wl;
#pragma unroll
    for (int d = 0; d < 4; ++d) hd_out[d * Bs + lane] = static_cast<int32_t>(st[wl].hd[d]);
    draws_out[lane] = st[wl].itrs;
  }
}

// ---------------------------------------------------------------------------
// mr_chain_kernel
// ---------------------------------------------------------------------------

constexpr int kMaxChainRooms = 8;  // ops/gen_kernel.py::_MAX_CHAIN_ROOMS
constexpr int kTries = 8;          // tries a room; also an attempt's threads
constexpr int kMinRoom = 4;

struct ChainShape {
  int width, height, nmax, max_sz;
};

// One room slot of a chain: top x, top y, size x, size y, entry x, entry y.
struct Room {
  int tx, ty, sx, sy, ex, ey;
};

// The randint words of row `row` of an attempt's keys.
__device__ __forceinline__ RandBits row_bits(uint2 sub, int row) {
  return randint_bits(threefry2x32(sub.x, sub.y, 0u, static_cast<uint32_t>(row)));
}

__device__ __forceinline__ int shfl_group(unsigned gmask, int v, int src) {
  return __shfl_sync(gmask, v, src, kTries);
}

// One `_try_chain(sub)` by a group of kTries threads, thread r trying try r
// of each room. Thread r ends holding room r of the candidate (zeros past
// its count). Returns the count, the same in each thread of the group;
// `used` gets the key rows the lazy loop draws.
__device__ __forceinline__ int try_chain(uint2 sub, int num_rooms, const ChainShape& c, int r, unsigned gmask,
                                         int wl, Room& mine, int& used) {
  const int q = r & 3;  // threads 0-3 draw the first room's rows 0-3
  const bool size_row = q >= 2;
  const int v = randint_range(row_bits(sub, q), size_row ? kMinRoom : 0, size_row ? c.max_sz + 1 : c.width - 2);
  int ptx = shfl_group(gmask, v, 0), pty = shfl_group(gmask, v, 1);
  int psx = shfl_group(gmask, v, 2), psy = shfl_group(gmask, v, 3);
  mine = r == 0 ? Room{ptx, pty, psx, psy, ptx, pty} : Room{0, 0, 0, 0, 0, 0};
  used = 4;
  int count = (ptx + psx <= c.width && pty + psy < c.height) ? 1 : 0;
  int entry_wall = 2;
  for (int i = 1; i < c.nmax; ++i) {
    if (count != i || i >= num_rooms) break;
    const int base = 4 + 5 * (kTries * (i - 1) + r);
    const int rr = randint_range(row_bits(sub, base), 0, 3);
    const int exit_wall = rr >= entry_wall ? rr + 1 : rr;
    const RandBits pos = row_bits(sub, base + 1);
    const int rx = randint_range(pos, 1, max(2, psx - 1));
    const int ry = randint_range(pos, 1, max(2, psy - 1));
    int exit_x, exit_y;
    switch (exit_wall) {
      case 0: exit_x = ptx + psx - 1; exit_y = pty + ry; break;
      case 1: exit_x = ptx + rx; exit_y = pty + psy - 1; break;
      case 2: exit_x = ptx; exit_y = pty + ry; break;
      default: exit_x = ptx + rx; exit_y = pty; break;
    }
    const int wall = (exit_wall + 2) % 4;  // the child's entry wall
    const int csx = randint_range(row_bits(sub, base + 2), kMinRoom, c.max_sz + 1);
    const int csy = randint_range(row_bits(sub, base + 3), kMinRoom, c.max_sz + 1);
    const int off = randint_range(row_bits(sub, base + 4), 0, max(1, (wall == 0 || wall == 2) ? csy - 2 : csx - 2));
    int ctx, cty;
    switch (wall) {
      case 0: ctx = exit_x - csx + 1; cty = exit_y - csy + 2 + off; break;
      case 1: ctx = exit_x - csx + 2 + off; cty = exit_y - csy + 1; break;
      case 2: ctx = exit_x; cty = exit_y - csy + 2 + off; break;
      default: ctx = exit_x - csx + 2 + off; cty = exit_y; break;
    }
    bool ok = ctx >= 0 && cty >= 0 && ctx + csx <= c.width && cty + csy < c.height;
    for (int j = 0; j + 1 < i; ++j) {  // strict overlap with every room but the parent
      const int jtx = shfl_group(gmask, mine.tx, j), jty = shfl_group(gmask, mine.ty, j);
      const int jsx = shfl_group(gmask, mine.sx, j), jsy = shfl_group(gmask, mine.sy, j);
      ok = ok && (ctx + csx < jtx || jtx + jsx <= ctx || cty + csy < jty || jty + jsy <= cty);
    }
    const unsigned fit = (__ballot_sync(gmask, ok) & gmask) >> (wl & ~(kTries - 1));
    if (fit == 0) {
      used += 5 * kTries;
      break;
    }
    const int w = __ffs(fit) - 1;  // the first try that fits
    used += 5 * (w + 1);
    ptx = shfl_group(gmask, ctx, w);
    pty = shfl_group(gmask, cty, w);
    psx = shfl_group(gmask, csx, w);
    psy = shfl_group(gmask, csy, w);
    const int wx = shfl_group(gmask, exit_x, w), wy = shfl_group(gmask, exit_y, w);
    entry_wall = shfl_group(gmask, wall, w);
    if (r == i) mine = Room{ptx, pty, psx, psy, wx, wy};
    count = i + 1;
  }
  return count;
}

// A lane of the retry loop between rounds, in shared memory, so that
// whichever groups of the warp take it next find it there.
struct ChainLane {
  uint32_t key0, key1;  // the retry key of the lane's next attempt
  int nr, best, attempts, rows, done;
  Room kept[kMaxChainRooms];  // the best chain (read only where best > 0)
};

__global__ void __launch_bounds__(kGenBlockThreads)
    mr_chain_kernel(const int32_t* __restrict__ key, const int32_t* __restrict__ num_rooms,
                    int32_t* __restrict__ rooms_out, int32_t* __restrict__ count_out,
                    int32_t* __restrict__ attempts_out, int32_t* __restrict__ rows_out, int B, ChainShape c,
                    int max_attempts) {
  constexpr int kGroups = 32 / kTries;  // groups of eight a warp
  constexpr int L = kGroups / kChainAttempts;  // lanes a warp
  __shared__ ChainLane lanes[kGenBlockThreads / 32][L];
  const int wl = static_cast<int>(threadIdx.x) & 31;
  const int q = wl / kTries, r = wl % kTries;  // the group, and the try (and room slot) of this thread
  ChainLane* st = lanes[threadIdx.x / 32];
  const int first = static_cast<int>((blockIdx.x * kGenBlockThreads + threadIdx.x) / 32) * L;  // the warp's lanes
  const size_t Bs = static_cast<size_t>(B);
  if (wl < L) {
    const int lane = first + wl;
    ChainLane& me = st[wl];
    me.done = 1;
    if (lane < B) {
      me.key0 = static_cast<uint32_t>(key[lane]);
      me.key1 = static_cast<uint32_t>(key[Bs + lane]);
      me.nr = num_rooms[lane];
      me.best = me.attempts = me.rows = 0;
      me.done = !(0 < me.nr && 0 < max_attempts);
    }
  }
  __syncwarp();
  const unsigned gmask = 0xffu << (wl & ~(kTries - 1));  // this thread's group of eight
  for (;;) {
    unsigned active = 0;
#pragma unroll
    for (int s = 0; s < L; ++s) active |= st[s].done ? 0u : 1u << s;
    if (active == 0) break;
    const int n = __popc(active);
    const int per = kGroups / pow2_ceil(n);  // the groups, and attempts, each lane takes this round
    const int blk = q / per, a = q % per;    // the lane's groups, and this group's attempt among them
    const bool owner = blk < n;              // the groups past the n-th shadow the last lane and write nothing
    const int s = nth_bit(active, min(blk, n - 1));
    const int nr = st[s].nr;
    int best = st[s].best, attempts = st[s].attempts, rows = st[s].rows;
    uint2 k = make_uint2(st[s].key0, st[s].key1), kg = k;
    for (int i = 0; i < per; ++i) {  // the retry chain: the key of this group's attempt, and the next round's
      kg = i == a ? k : kg;
      k = threefry2x32(k.x, k.y, 0u, 0u);
    }
    const uint2 sub = threefry2x32(kg.x, kg.y, 0u, 1u);
    Room mine;
    int used;
    const int count = try_chain(sub, nr, c, r, gmask, wl, mine, used);
    const unsigned lmask = span_mask(per * kTries, blk * per * kTries);
    int from = -1;  // the attempt of the round whose chain is now the best
    for (int i = 0; i < per; ++i) {
      const int src = (blk * per + i) * kTries;
      const int ci = __shfl_sync(lmask, count, src), ui = __shfl_sync(lmask, used, src);
      if (best < nr && attempts < max_attempts) {
        ++attempts;
        rows += ui;
        if (ci > best) {
          best = ci;
          from = i;
        }
      }
    }
    __syncwarp();  // every group has read its lane
    if (owner && from == a && r < c.nmax) st[s].kept[r] = mine;
    if (owner && a == 0 && r == 0) {
      ChainLane& me = st[s];
      me.key0 = k.x;
      me.key1 = k.y;
      me.best = best;
      me.attempts = attempts;
      me.rows = rows;
      me.done = !(best < nr && attempts < max_attempts);
    }
    __syncwarp();
  }
  // rooms_out is (6, nmax, B): field f of room slot i at (f * nmax + i) * B + lane.
  if (q < L && first + q < B) {
    const int lane = first + q;
    const ChainLane& me = st[q];
    if (r < c.nmax) {
      const Room v = me.best > 0 ? me.kept[r] : Room{0, 0, 0, 0, 0, 0};
      const int32_t vals[6] = {v.tx, v.ty, v.sx, v.sy, v.ex, v.ey};
#pragma unroll
      for (int f = 0; f < 6; ++f) rooms_out[(static_cast<size_t>(f) * c.nmax + r) * Bs + lane] = vals[f];
    }
    if (r == 0) {
      count_out[lane] = me.best;
      attempts_out[lane] = me.attempts;
      rows_out[lane] = me.rows;
    }
  }
}

int grid_blocks(int B, int threads_per_lane) {
  const long long threads = static_cast<long long>(B) * threads_per_lane;
  return static_cast<int>((threads + kGenBlockThreads - 1) / kGenBlockThreads);
}

}  // namespace

extern "C" {

// Launch the connect loop on `stream` over B lanes; `color_order` holds the
// six colour ids. Returns the cudaError_t of the launch.
int mg_connect_launch(const void* key, const void* start_i, const void* start_j, const void* locked_bits,
                      const void* hd0, void* hd_out, void* colors_out, void* draws_out, const int* color_order,
                      int B, int rows, int cols, int max_itrs, void* stream) {
  if (rows * cols > 30) return static_cast<int>(cudaErrorInvalidValue);
  uint32_t order = 0;  // colour id c at bits 4c..4c+3
  for (int c = 0; c < 6; ++c) order |= (static_cast<uint32_t>(color_order[c]) & 15u) << (4 * c);
  connect_kernel<<<grid_blocks(B, kConnectThreads), kGenBlockThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(key), static_cast<const int32_t*>(start_i), static_cast<const int32_t*>(start_j),
      static_cast<const int32_t*>(locked_bits), static_cast<const int32_t*>(hd0), static_cast<int32_t*>(hd_out),
      static_cast<int32_t*>(colors_out), static_cast<int32_t*>(draws_out), B, rows, cols, max_itrs, order);
  return static_cast<int>(cudaGetLastError());
}

// Launch the room-chain retry loop on `stream` over B lanes (nmax <=
// kMaxChainRooms, checked by the wrapper). Returns the cudaError_t of the
// launch.
int mg_mr_chain_launch(const void* key, const void* num_rooms, void* rooms_out, void* count_out, void* attempts_out,
                       void* rows_out, int B, int width, int height, int nmax, int max_room_size, int max_attempts,
                       void* stream) {
  if (nmax < 1 || nmax > kMaxChainRooms) return static_cast<int>(cudaErrorInvalidValue);
  mr_chain_kernel<<<grid_blocks(B, kTries * kChainAttempts), kGenBlockThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(key), static_cast<const int32_t*>(num_rooms), static_cast<int32_t*>(rooms_out),
      static_cast<int32_t*>(count_out), static_cast<int32_t*>(attempts_out), static_cast<int32_t*>(rows_out), B,
      ChainShape{width, height, nmax, max_room_size}, max_attempts);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of kGenBlockThreads threads of the connect kernel (`kernel` 0) or
// the room-chain kernel (1) that one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); a negative value is the
// negated cudaError_t.
int mg_gen_occupancy(int kernel) {
  int blocks = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (kernel == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, connect_kernel, kGenBlockThreads, 0);
  } else if (kernel == 1) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, mr_chain_kernel, kGenBlockThreads, 0);
  }
  return err != cudaSuccess ? -static_cast<int>(err) : blocks;
}

}  // extern "C"
