// RoomGrid connect_all door loop for Hopper (sm_90a).
//
// Replaces the TPU kernel minigrid_tpu/ops/gen_kernel.py::_connect_kernel.
// Per lane it runs `connect_all`'s randomized loop on bit-packed room
// state: while the rooms reachable from the start room (a shift-OR flood
// over the four door bitmasks) are not all rooms and fewer than max_itrs
// draws were made, one draw: `key, k_i, k_j, k_k, k_c = split(key, 5)`,
// four randints (room column i, row j, wall slot k, colour index), and an
// unlocked door on slot k of room (i, j) (registered on both rooms) if
// that neighbour exists, the slot has no door yet and neither room is
// locked. Outputs are the final door bitmasks, the colour of each accepted
// door slot, and the lane's draw count.
//
// Draw for draw it is jax.random's stream (core/prng.py): a split child
// is both words of threefry2x32(k0, k1, 0, c); randint(key, 0, n) is
// ((bits(k1) mod n) * ((2^16 mod n)^2 mod n) + bits(k2) mod n) mod n with
// (k1, k2) = split(key) and bits(k) = x0 ^ x1 of threefry2x32(k, 0, 0).
// All of it is uint32 arithmetic, so unsigned `%` and `>>` need no
// sign fix-up; the neighbour index wraps as (ni + cols) % cols, whose
// operand is never negative.
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

// jax.random.randint(key, (), 0, n) for a small span n >= 1.
__device__ __forceinline__ uint32_t randint_span(uint2 key, uint32_t n) {
  const uint2 k1 = threefry2x32(key.x, key.y, 0u, 0u);
  const uint2 k2 = threefry2x32(key.x, key.y, 0u, 1u);
  const uint32_t m = (65536u % n) * (65536u % n) % n;
  return ((bits_of(k1) % n) * m + bits_of(k2) % n) % n;
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

}  // extern "C"
