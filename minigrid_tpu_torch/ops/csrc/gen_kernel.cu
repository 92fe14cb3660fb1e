// The layout generators' plan loops for Hopper (sm_90a): RoomGrid's
// connect_all door loop (connect_kernel) and MultiRoom's room-chain retry
// loop (mr_chain_kernel). Both draw jax.random's exact streams: a split
// child is both words of threefry2x32(k0, k1, 0, c); randint(key, lo, hi)
// is lo + ((bits(k1) mod n) * ((2^16 mod n)^2 mod n) + bits(k2) mod n)
// mod n for the span n = hi - lo (1 where hi <= lo), with (k1, k2) =
// split(key) and bits(k) = x0 ^ x1 of threefry2x32(k, 0, 0). All of it is
// uint32 arithmetic, so unsigned `%` and `>>` need no sign fix-up.
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
// blocks (about 80 operations each) plus the flood and the randint
// reductions, against 48 bytes of lane state in and out. A lane stops at
// its own convergence, but a warp runs until its slowest lane has: the
// draw counts are data-dependent (on KeyCorridorS6R3 a median of about 20
// and a tail past 130).
//
// Design (simple and right first): one thread per lane; the key, the four
// door bitmasks and the draw count live in registers. The colour of an
// accepted door is written straight to the output, which is zeroed first:
// a lane accepts at most a few doors, so that costs fewer stores than
// keeping rows * cols * 4 colours in registers.
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
// and the key rows drawn (byte-exact against ops/gen_kernel.py::
// plain_mr_chain, which counts the same rows).
//
// What bounds it: integer operations, about 400 a row (5 Threefry blocks
// and the reduction), against 12 bytes in and 4 * (6 * nmax + 3) out per
// lane. Attempts per lane are data-dependent (MultiRoom-N4-S5: mean about
// 1.5, max 6; N6: mean about 4.8, max about 33), and a warp runs to its
// slowest lane.
//
// Design (simple and right first): one thread per lane, the rows drawn
// lazily: a room's tries stop at the first that fits, and rooms past the
// first that fails or past the lane's count are not drawn, which leaves
// every result as it is, since each row is a pure function of its key.
// The candidate chain lives in registers (the room loop is unrolled over
// kMaxChainRooms); the best chain is stored to the output when it
// improves, which happens at most nmax times a lane.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

// The colour ids in the order _rand_color draws them (sorted colour names);
// envs/roomgrid.py::COLOR_ORDER, passed by the wrapper.
struct ColorOrder {
  int32_t id[6];
};

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

__global__ void connect_kernel(const int32_t* __restrict__ key, const int32_t* __restrict__ start_i,
                               const int32_t* __restrict__ start_j,
                               const int32_t* __restrict__ locked_bits,
                               const int32_t* __restrict__ hd0, int32_t* __restrict__ hd_out,
                               int32_t* __restrict__ colors_out, int32_t* __restrict__ draws_out,
                               int B, int rows, int cols, int max_itrs, ColorOrder order) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const size_t Bs = static_cast<size_t>(B);
  const int rc = rows * cols;
  const uint32_t full = (1u << rc) - 1u;
  uint32_t right_edge = 0, left_edge = 0;
  for (int j = 0; j < rows; ++j) {
    right_edge |= 1u << (j * cols + cols - 1);
    left_edge |= 1u << (j * cols);
  }
  const uint32_t start_bit = 1u << (start_j[lane] * cols + start_i[lane]);
  const uint32_t locked = static_cast<uint32_t>(locked_bits[lane]);
  uint32_t hd[4];
  for (int d = 0; d < 4; ++d) hd[d] = static_cast<uint32_t>(hd0[d * Bs + lane]);
  for (int s = 0; s < rc * 4; ++s) colors_out[s * Bs + lane] = 0;
  uint2 k = make_uint2(static_cast<uint32_t>(key[lane]), static_cast<uint32_t>(key[Bs + lane]));

  int itrs = 0;
  while (itrs < max_itrs) {
    uint32_t reach = start_bit;
    for (int s = 0; s < rc; ++s) {
      reach = (reach | ((reach & hd[0] & ~right_edge) << 1) | ((reach & hd[2] & ~left_edge) >> 1) |
               ((reach & hd[1]) << cols) | ((reach & hd[3]) >> cols)) &
              full;
    }
    if (reach == full) break;

    // split(key, 5): child 0 is the next chain key, 1..4 draw i, j, k, colour.
    uint2 child[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) child[c] = threefry2x32(k.x, k.y, 0u, static_cast<uint32_t>(c));
    k = child[0];
    const int i = static_cast<int>(randint_span(child[1], static_cast<uint32_t>(cols)));
    const int j = static_cast<int>(randint_span(child[2], static_cast<uint32_t>(rows)));
    const int kk = static_cast<int>(randint_span(child[3], 4u));
    const int color = order.id[randint_span(child[4], 6u)];

    const bool nexist = (kk == 0 && i < cols - 1) || (kk == 1 && j < rows - 1) ||
                        (kk == 2 && i > 0) || (kk == 3 && j > 0);
    const int ni = i + (kk == 0) - (kk == 2);
    const int nj = j + (kk == 1) - (kk == 3);
    const int nim = (ni + cols) % cols;
    const int njm = (nj + rows) % rows;
    const uint32_t bit = 1u << (j * cols + i);
    const uint32_t nbit = 1u << (njm * cols + nim);
    const int ksym = (kk + 2) % 4;
    if (nexist && (hd[kk] & bit) == 0 && (locked & bit) == 0 && (locked & nbit) == 0) {
      hd[kk] |= bit;
      hd[ksym] |= nbit;
      colors_out[static_cast<size_t>((j * cols + i) * 4 + kk) * Bs + lane] = color;
      colors_out[static_cast<size_t>((njm * cols + nim) * 4 + ksym) * Bs + lane] = color;
    }
    ++itrs;
  }
  for (int d = 0; d < 4; ++d) hd_out[d * Bs + lane] = static_cast<int32_t>(hd[d]);
  draws_out[lane] = itrs;
}

constexpr int kMaxChainRooms = 8;  // ops/gen_kernel.py::_MAX_CHAIN_ROOMS
constexpr int kTries = 8;
constexpr int kMinRoom = 4;

struct ChainShape {
  int width, height, nmax, max_sz;
};

// The randint words of row `row` of an attempt's keys.
__device__ __forceinline__ RandBits row_bits(uint2 sub, int row) {
  return randint_bits(threefry2x32(sub.x, sub.y, 0u, static_cast<uint32_t>(row)));
}

// One `_try_chain(sub)`: fills rooms 0..count-1 of the candidate (the
// other slots of rooms 1.. stay zero) and returns its count; `rows` gains
// the key rows drawn.
__device__ __forceinline__ int try_chain(uint2 sub, int num_rooms, const ChainShape& c,
                                         int (&tx)[kMaxChainRooms], int (&ty)[kMaxChainRooms],
                                         int (&sx)[kMaxChainRooms], int (&sy)[kMaxChainRooms],
                                         int (&ex)[kMaxChainRooms], int (&ey)[kMaxChainRooms],
                                         int& rows) {
#pragma unroll
  for (int i = 1; i < kMaxChainRooms; ++i) tx[i] = ty[i] = sx[i] = sy[i] = ex[i] = ey[i] = 0;
  ex[0] = tx[0] = randint_range(row_bits(sub, 0), 0, c.width - 2);
  ey[0] = ty[0] = randint_range(row_bits(sub, 1), 0, c.width - 2);
  sx[0] = randint_range(row_bits(sub, 2), kMinRoom, c.max_sz + 1);
  sy[0] = randint_range(row_bits(sub, 3), kMinRoom, c.max_sz + 1);
  rows += 4;
  int count = (tx[0] + sx[0] <= c.width && ty[0] + sy[0] < c.height) ? 1 : 0;
  int entry_wall = 2;
#pragma unroll
  for (int i = 1; i < kMaxChainRooms; ++i) {
    if (i >= c.nmax || count != i || i >= num_rooms) break;
    const int ptx = tx[i - 1], pty = ty[i - 1], psx = sx[i - 1], psy = sy[i - 1];
    for (int t = 0; t < kTries; ++t) {
      const int base = 4 + 5 * (kTries * (i - 1) + t);
      rows += 5;
      const int r = randint_range(row_bits(sub, base), 0, 3);
      const int exit_wall = r >= entry_wall ? r + 1 : r;
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
#pragma unroll
      for (int j = 0; j < i - 1; ++j) {  // strict overlap with every room but the parent
        const bool apart = ctx + csx < tx[j] || tx[j] + sx[j] <= ctx || cty + csy < ty[j] || ty[j] + sy[j] <= cty;
        ok = ok && apart;
      }
      if (ok) {
        tx[i] = ctx;
        ty[i] = cty;
        sx[i] = csx;
        sy[i] = csy;
        ex[i] = exit_x;
        ey[i] = exit_y;
        entry_wall = wall;
        count = i + 1;
        break;
      }
    }
  }
  return count;
}

__global__ void mr_chain_kernel(const int32_t* __restrict__ key, const int32_t* __restrict__ num_rooms,
                                int32_t* __restrict__ rooms_out, int32_t* __restrict__ count_out,
                                int32_t* __restrict__ attempts_out, int32_t* __restrict__ rows_out, int B,
                                ChainShape c, int max_attempts) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const size_t Bs = static_cast<size_t>(B);
  // rooms_out is (6, nmax, B): field f of room slot i at (f * nmax + i) * B + lane.
  for (int s = 0; s < 6 * c.nmax; ++s) rooms_out[s * Bs + lane] = 0;
  uint2 k = make_uint2(static_cast<uint32_t>(key[lane]), static_cast<uint32_t>(key[Bs + lane]));
  const int nr = num_rooms[lane];
  int best = 0, attempts = 0, rows = 0;
  int tx[kMaxChainRooms], ty[kMaxChainRooms], sx[kMaxChainRooms], sy[kMaxChainRooms];
  int ex[kMaxChainRooms], ey[kMaxChainRooms];
  while (best < nr && attempts < max_attempts) {
    const uint2 sub = threefry2x32(k.x, k.y, 0u, 1u);
    k = threefry2x32(k.x, k.y, 0u, 0u);
    ++attempts;
    const int count = try_chain(sub, nr, c, tx, ty, sx, sy, ex, ey, rows);
    if (count > best) {
      best = count;
#pragma unroll
      for (int i = 0; i < kMaxChainRooms; ++i) {
        if (i >= c.nmax) break;
        const int32_t vals[6] = {tx[i], ty[i], sx[i], sy[i], ex[i], ey[i]};
#pragma unroll
        for (int f = 0; f < 6; ++f) rooms_out[(static_cast<size_t>(f) * c.nmax + i) * Bs + lane] = vals[f];
      }
    }
  }
  count_out[lane] = best;
  attempts_out[lane] = attempts;
  rows_out[lane] = rows;
}

}  // namespace

extern "C" {

// Launch the connect loop on `stream` over B lanes; `color_order` holds the
// six colour ids. Returns the cudaError_t of the launch.
int mg_connect_launch(const void* key, const void* start_i, const void* start_j,
                      const void* locked_bits, const void* hd0, void* hd_out, void* colors_out,
                      void* draws_out, const int* color_order, int B, int rows, int cols,
                      int max_itrs, void* stream) {
  ColorOrder order;
  for (int c = 0; c < 6; ++c) order.id[c] = color_order[c];
  constexpr int kThreads = 128;
  connect_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(key), static_cast<const int32_t*>(start_i),
      static_cast<const int32_t*>(start_j), static_cast<const int32_t*>(locked_bits),
      static_cast<const int32_t*>(hd0), static_cast<int32_t*>(hd_out),
      static_cast<int32_t*>(colors_out), static_cast<int32_t*>(draws_out), B, rows, cols, max_itrs,
      order);
  return static_cast<int>(cudaGetLastError());
}

// Launch the room-chain retry loop on `stream` over B lanes (nmax <=
// kMaxChainRooms, checked by the wrapper). Returns the cudaError_t of the
// launch.
int mg_mr_chain_launch(const void* key, const void* num_rooms, void* rooms_out, void* count_out,
                       void* attempts_out, void* rows_out, int B, int width, int height, int nmax,
                       int max_room_size, int max_attempts, void* stream) {
  if (nmax < 1 || nmax > kMaxChainRooms) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kThreads = 128;
  mr_chain_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(key), static_cast<const int32_t*>(num_rooms), static_cast<int32_t*>(rooms_out),
      static_cast<int32_t*>(count_out), static_cast<int32_t*>(attempts_out), static_cast<int32_t*>(rows_out), B,
      ChainShape{width, height, nmax, max_room_size}, max_attempts);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
