// The rollout kernel (rollout_kernel.cu describes it) as templates, shared
// by the translation units that instantiate it: rollout_kernel.cu (the
// generic int32 cells, with the C entry points), rollout_cells16_t1.cu and
// rollout_cells16_t4.cu (16-bit cells at view 7, one and four threads a
// lane), compiled in parallel.

#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "step_device.cuh"

namespace mg_rollout {

struct Params {
  const int32_t* words_in;    // (HW, B), agent-centred
  const int32_t* regs_in;     // (num_regs, B)
  const int32_t* tmpl_words;  // (HW, B), centred on the template agent
  const int32_t* tmpl_regs;   // (num_regs, B)
  const int32_t* actions;     // (T, B)
  const int32_t* tables;      // [off_fwd (4); off_view (4 * V * V)]
  const int32_t* ctl_in;      // (3, B) commit rows, or null
  int32_t* words_out;
  int32_t* regs_out;
  float* rsum_out;      // (B,)
  int32_t* counts_out;  // (2, B): episodes; obs checksum
  int32_t* ctl_out;     // (3, B), when ctl_in is not null
  int B, T, width, height, view, max_steps, see_through_walls, num_regs, n_obst;
};

// Launch one plan variant with `lane_block` lanes a block and `smem` bytes
// of dynamic shared memory; with a non-null `blocks_per_sm`, launch nothing
// and write how many such blocks an SM holds at once. Returns a cudaError_t.
int launch_generic(const Params& p, int hook, bool ctl, int lane_block, int smem, cudaStream_t stream,
                   int* blocks_per_sm);
int launch_cells16_t1(const Params& p, int hook, bool ctl, int lane_block, int smem, cudaStream_t stream,
                      int* blocks_per_sm);
int launch_cells16_t4(const Params& p, int hook, bool ctl, int lane_block, int smem, cudaStream_t stream,
                      int* blocks_per_sm);

}  // namespace mg_rollout

namespace {

using mg_rollout::Params;

// ---- 16-bit cells ----
//
// A cell word uses 20 bits (ops/packing.py): type 4, colour 4, state 4,
// contained type 4, contained colour 4. Every word of the ported families
// keeps its colours below 8 and its state below 4, so a 16-bit cell holds
// type 4 (bits 0-3), colour 3 (4-6), state 2 (7-8), contained type 4
// (9-12) and contained colour 3 (13-15). A word with any other bit set
// does not fit, and the launch traps: the error surfaces at the caller's
// next synchronization, as a broken protocol's does in policy_device.cuh.
// Not a status word that the wrapper reads after each launch: that read
// waits for the launch and so costs every call the host's time to the
// next one, 0.1-0.2 ms on the card (PERF.md), as much as a 32-step pass
// at B = 32,768 takes.
constexpr uint32_t kFit16 = 0x7F37Fu;  // the bits of a word that a 16-bit cell keeps
constexpr int kWallTcs = 2 + 5;        // tcs(kWallWord)

__device__ __forceinline__ bool fits16(int w) { return (static_cast<uint32_t>(w) & ~kFit16) == 0u; }

__device__ __forceinline__ uint32_t pack16(int w) {
  const uint32_t u = static_cast<uint32_t>(w);
  return (u & 0x7Fu) | ((u >> 1) & 0x180u) | ((u >> 3) & 0xFE00u);
}

__device__ __forceinline__ int unpack16(uint32_t c) {
  return static_cast<int>((c & 0x7Fu) | ((c & 0x180u) << 1) | ((c & 0xFE00u) << 3));
}

// tcs and transparent of a packed cell, without unpacking it.
__device__ __forceinline__ int tcs16(uint32_t c) { return (c & 15u) + ((c >> 4) & 7u) + ((c >> 7) & 3u); }

__device__ __forceinline__ bool transparent16(uint32_t c) {
  const uint32_t t = c & 15u;
  return !(t == kWall || (t == kDoor && (c & 0x180u) != 0u));
}

__device__ __forceinline__ int mod_hw(int x, int hw) {
  x %= hw;
  return x < 0 ? x + hw : x;
}

// A lane's grid column of 16-bit cells in shared memory: row r at
// col[r * stride]. Cells sit at their absolute rows (y * W + x): the
// agent-centred words are placed with the agent's cell at its own row, so
// an in-bounds view cell is read at its world position, without a
// modulo. With kTpl threads a lane each thread holds one of these; they
// write the same values, and a reset's rows are split over them.
template <int kTpl>
struct Grid16 {
  uint16_t* col;
  int stride;
  int sub;         // this thread's index among the lane's
  uint32_t gmask;  // the lane's threads in the warp
  bool bad;        // a stored word did not fit

  __device__ __forceinline__ uint32_t raw(int r) const { return col[r * stride]; }
  __device__ __forceinline__ int load(int r) const { return unpack16(col[r * stride]); }
  __device__ __forceinline__ void store(int r, int w) {
    bad = bad || !fits16(w);
    col[r * stride] = static_cast<uint16_t>(pack16(w));
  }
  // The agent's absolute row (its registers are grid coordinates, as every
  // generator and step keeps them), mod HW.
  __device__ __forceinline__ int agent_row(int x, int y, const StepShape& sh) const {
    return mod_hw(wadd(static_cast<int>(static_cast<uint32_t>(y) * static_cast<uint32_t>(sh.width)), x), sh.hw);
  }
  __device__ __forceinline__ int first_row() const { return sub; }
  __device__ __forceinline__ int row_step() const { return kTpl; }
  __device__ __forceinline__ void sync() const {
    if (kTpl > 1) __syncwarp(gmask);
  }
};

// The occlusion flood of one view row (ops/packing.py::visibility_bitmask):
// the visible bits of row rd given its transparency bits and the carry of
// row rd - 1 (rd, the forward distance, counts from the agent's row).
template <int kView>
__device__ __forceinline__ uint32_t flood_row(uint32_t trow, uint32_t& carry, bool agent_row) {
  constexpr uint32_t all_bits = (1u << kView) - 1u;
  constexpr uint32_t last_clear = all_bits >> 1;
  constexpr uint32_t first_clear = all_bits & ~1u;
  uint32_t row = carry | (agent_row ? 1u << (kView / 2) : 0u);
#pragma unroll
  for (int k = 0; k < kView - 1; ++k) row |= (row & trow) << 1;
  row &= all_bits;
  const uint32_t q_l = row & trow & last_clear;
#pragma unroll
  for (int k = 0; k < kView - 1; ++k) row |= (row & trow) >> 1;
  const uint32_t q_r = row & trow & first_clear;
  carry = (q_l | (q_l << 1) | q_r | (q_r >> 1)) & all_bits;
  return row;
}

// One view row's cells c (packed): each cell's tcs (a wall's where out of
// bounds: bit i of `row_ok` clear; the agent's cell, column kView / 2 of
// the agent's row, shows what it carries) into t, and, with kFlood, the
// row's transparency bits.
template <int kView, bool kFlood>
__device__ __forceinline__ uint32_t row_cells(const uint32_t (&c)[kView], uint32_t row_ok, bool agent_row,
                                              int agent_word, int (&t)[kView]) {
  uint32_t trow = 0u;
#pragma unroll
  for (int i = 0; i < kView; ++i) {
    const bool ok = (row_ok >> i) & 1u;
    t[i] = ok ? tcs16(c[i]) : kWallTcs;
    bool clear = kFlood && ok && transparent16(c[i]);
    if (i == kView / 2) {
      t[i] = agent_row ? tcs(agent_word) : t[i];
      clear = kFlood && (agent_row ? transparent(agent_word) : clear);
    }
    trow |= static_cast<uint32_t>(clear) << i;
  }
  return trow;
}

// The sum of t over the set bits of vis.
template <int kView>
__device__ __forceinline__ int visible_sum(const int (&t)[kView], uint32_t vis) {
  int sum = 0;
#pragma unroll
  for (int i = 0; i < kView; ++i) sum += (vis >> i) & 1u ? t[i] : 0;
  return sum;
}

// This thread's share of the post-step observation's checksum (the sum of
// tcs over the visible view cells; hidden cells count 0) for a view of
// kView, unrolled, with the occlusion flood if kFlood. The lane's kTpl
// threads split the view rows by forward distance rd (thread `sub` takes
// rd = sub, sub + kTpl, ...). Cell (rd, i) of the view lies at world
// offset rd * (f0, f1) + (i - half) * (-f1, f0) from the agent, so with
// cells at their absolute rows its physical row is shift + rd * step_rd +
// (i - half) * step_col, no modulo; the cells in bounds are a run of
// columns (`in_cols`) of the rows whose other coordinate is in bounds, and
// an out-of-bounds cell reads row 0 and counts as a wall. One thread a lane
// floods row by row as it reads; several keep their rows' cells (two to a
// register), gather every row's transparency bits with shuffles, run the
// whole flood each, and sum their own rows' visible cells.
template <int kView, int kTpl, bool kFlood>
__device__ __forceinline__ int view_sum16(const Grid16<kTpl>& grid, const StepShape& sh, const Lane& s) {
  constexpr int half = kView / 2;
  constexpr int kRows = (kView + kTpl - 1) / kTpl;
  constexpr int kPairs = (kView + 1) / 2;
  constexpr uint32_t kAll = (1u << kView) - 1u;
  const int f0 = (s.d == 0) - (s.d == 2);
  const int f1 = (s.d == 1) - (s.d == 3);
  const int step_col = f0 * sh.width - f1;
  const int step_rd = f1 * sh.width + f0;
  // Along a row one coordinate moves with i (x by -f1, or y by f0): the
  // columns where it is in bounds. The other moves with rd.
  const bool along_x = f1 != 0;
  const int c_mid = along_x ? s.x : s.y;
  const int n_along = along_x ? sh.width : sh.height;
  int lo = along_x ? (f1 < 0 ? half - c_mid : half + c_mid - n_along + 1)
                   : (f0 > 0 ? half - c_mid : half + c_mid - n_along + 1);
  int hi = lo + n_along - 1;
  lo = max(lo, 0);
  hi = min(hi, kView - 1);
  const uint32_t in_cols = lo <= hi ? (2u << hi) - (1u << lo) : 0u;
  const int r_agent = along_x ? s.y : s.x;
  const int r_step = along_x ? f1 : f0;
  const uint32_t n_other = static_cast<uint32_t>(along_x ? sh.height : sh.width);
  const int agent_word = s.ct > 0 ? (s.ct | (s.cc << 4)) : kEmptyWord;

  int sum = 0;
  uint32_t carry = 0u;
  uint32_t packed[kRows][kPairs];  // several threads a lane, with the flood: own rows' cells
  uint32_t trow[kRows];
  uint32_t ok[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int rd = grid.sub + kTpl * r;
    ok[r] = static_cast<uint32_t>(r_agent + r_step * rd) < n_other ? in_cols : 0u;
    const int p0 = s.shift + rd * step_rd - half * step_col;
    uint32_t c[kView];
#pragma unroll
    for (int i = 0; i < kView; ++i) c[i] = grid.raw((ok[r] >> i) & 1u ? p0 + i * step_col : 0);
    int t[kView];
    trow[r] = row_cells<kView, kFlood>(c, ok[r], rd == 0, agent_word, t);
    if constexpr (kTpl == 1) {
      sum += visible_sum<kView>(t, kFlood ? flood_row<kView>(trow[r], carry, rd == 0) : kAll);
    } else if constexpr (!kFlood) {
      sum += rd < kView ? visible_sum<kView>(t, kAll) : 0;
    } else {
#pragma unroll
      for (int q = 0; q < kPairs; ++q) packed[r][q] = c[2 * q] | (2 * q + 1 < kView ? c[2 * q + 1] << 16 : 0u);
    }
  }
  if constexpr (kTpl > 1 && kFlood) {
    uint32_t vis[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) vis[r] = 0u;
#pragma unroll
    for (int rd = 0; rd < kView; ++rd) {
      const uint32_t row =
          flood_row<kView>(__shfl_sync(grid.gmask, trow[rd / kTpl], rd % kTpl, kTpl), carry, rd == 0);
      vis[rd / kTpl] = rd % kTpl == grid.sub ? row : vis[rd / kTpl];
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int rd = grid.sub + kTpl * r;
      uint32_t c[kView];
#pragma unroll
      for (int i = 0; i < kView; ++i) c[i] = (packed[r][i / 2] >> (16 * (i & 1))) & 0xFFFFu;
      int t[kView];
      row_cells<kView, true>(c, ok[r], rd == 0, agent_word, t);
      sum += rd < kView ? visible_sum<kView>(t, vis[r]) : 0;
    }
  }
  return sum;
}

template <int kView, int kTpl>
__device__ __forceinline__ int view_checksum16(const Grid16<kTpl>& grid, const StepShape& sh, const Lane& s) {
  return sh.see_through_walls ? view_sum16<kView, kTpl, false>(grid, sh, s)
                              : view_sum16<kView, kTpl, true>(grid, sh, s);
}

// Shared memory, as ops/fused_rollout.py::rollout_smem_bytes counts it:
// the offset tables (4 + 4 V^2 int32), the obstacle rows [4n][bt] int32,
// then the cells: [HW][bt] int32 (generic), or [HW][stride] 16-bit.
__device__ __forceinline__ int table_words(int view) { return 4 + 4 * view * view; }

// The generic kernel: one thread a lane, int32 cells, any view size, the
// view read through the offset tables (step_device.cuh::read_view).
template <int kHook, bool kCtl>
__global__ void __launch_bounds__(128) rollout_generic(const Params p) {
  extern __shared__ __align__(16) int32_t smem_i32[];
  const int bt = blockDim.x;
  const int tid = threadIdx.x;
  const StepShape sh{p.width,     p.height,           p.width * p.height, p.view,
                     p.max_steps, p.see_through_walls, p.n_obst,           p.num_regs - 2};
  int32_t* tab = smem_i32;
  int32_t* obst = tab + table_words(p.view);
  int32_t* cells = obst + 4 * p.n_obst * bt;
  for (int i = tid; i < table_words(p.view); i += bt) tab[i] = p.tables[i];
  __syncthreads();  // the only block-wide step; each thread owns its column

  const int lane = blockIdx.x * bt + tid;
  if (lane >= p.B) return;
  const size_t B = static_cast<size_t>(p.B);
  int32_t* g = cells + tid;  // this lane's grid: row r at g[r * bt]

  Lane s;
  s.ob = obst + tid;  // this lane's obstacle rows, if any
  load_lane<kHook>(g, bt, p.words_in, p.regs_in, B, lane, sh, s);
  Ctl ctl{};
  if (kCtl) {
    ctl.consumed = p.ctl_in[lane];
    ctl.steps_done = p.ctl_in[B + lane];
    ctl.frozen = p.ctl_in[2 * B + lane];
  }
  bool reset_any = false;
  float rsum = 0.0f;
  int episodes = 0;
  int checksum = 0;
  for (int t = 0; t < p.T; ++t) {
    const int a = p.actions[t * B + lane];
    bool done;
    float reward;
    // Only under kCtl can a step go uncommitted, and the lane then stays
    // frozen or finished for the rest of the launch.
    if (!step_lane_ex<kHook, kCtl>(g, bt, tab, p.tmpl_words, p.tmpl_regs, B, lane, sh, a, p.T, s, ctl, reward,
                                   done))
      break;
    if (done) {
      reset_any = true;
      episodes += 1;
    }
    rsum = __fadd_rn(rsum, reward);
    int obs_sum = 0;
    read_view<false>(g, bt, tab, sh, s, [&](int, int w) { obs_sum += tcs(w); });
    checksum += obs_sum;
  }
  store_lane<kHook>(g, bt, p.words_out, p.regs_out, p.regs_in, p.tmpl_regs, reset_any, B, lane, sh, p.num_regs,
                    s);
  p.rsum_out[lane] = rsum;
  p.counts_out[lane] = episodes;
  p.counts_out[B + lane] = checksum;
  if (kCtl) {
    p.ctl_out[lane] = ctl.consumed;
    p.ctl_out[B + lane] = ctl.steps_done;
    p.ctl_out[2 * B + lane] = ctl.frozen;
  }
}

// The 16-bit kernel's largest block (threads) and the blocks of that size
// an SM must hold, which caps ptxas's registers a thread: 80 (65,536 /
// (128 * 6), 24 warps an SM) for one thread a lane without a hook or the
// commit rows; 96 (/ (128 * 5), 20 warps) with either, which spill at 80;
// 85 (/ (256 * 3)) for four threads a lane, which use 61-70; 128 for them
// under the DynamicObstacles walk. ops/fused_rollout.py::LANE_BLOCKS keeps
// the blocks within these sizes.
template <int kTpl>
constexpr int kCells16MaxThreads = kTpl == 1 ? 128 : 256;
template <int kHook, bool kCtl, int kTpl>
constexpr int kCells16MinBlocks = kTpl == 1 ? (kHook == kHookNone && !kCtl ? 6 : 5)
                                            : (kHook == kHookDynamicObstacles ? 2 : 3);

// The 16-bit kernel: kTpl threads a lane (blockDim.x / kTpl lanes a
// block), view kView unrolled (view_checksum16). The lane's threads run
// the step alike and split the view rows, the loads and stores of the
// grid rows and a reset's rows; they meet at __syncwarp over their own
// mask after each step and before the stores, and their checksums are
// summed with shuffles at the end (an int32 sum: the order does not
// matter). Lane li's column: with one thread a lane (blocks of whole
// 64-lane pairs of warps) the lanes of a warp take every other 16-bit
// column (warp 2k the even ones, 2k + 1 the odd ones), so that a warp's
// 32 reads of any rows hit 32 banks; with several threads a lane, rows
// are padded by 4 bytes.
template <int kHook, bool kCtl, int kTpl, int kView>
__global__ void __launch_bounds__(kCells16MaxThreads<kTpl>, kCells16MinBlocks<kHook, kCtl, kTpl>)
    rollout_cells16(const Params p) {
  extern __shared__ __align__(16) int32_t smem_i32[];
  const int bt = blockDim.x / kTpl;
  const int tid = threadIdx.x;
  const int li = tid / kTpl;
  const StepShape sh{p.width,     p.height,           p.width * p.height, kView,
                     p.max_steps, p.see_through_walls, p.n_obst,           p.num_regs - 2};
  int32_t* tab = smem_i32;
  int32_t* obst = tab + table_words(kView);
  uint16_t* cells = reinterpret_cast<uint16_t*>(obst + 4 * p.n_obst * bt);
  for (int i = tid; i < table_words(kView); i += blockDim.x) tab[i] = p.tables[i];
  __syncthreads();

  const int lane = blockIdx.x * bt + li;
  if (lane >= p.B) return;
  const size_t B = static_cast<size_t>(p.B);
  const int hw = sh.hw;
  const int col = kTpl == 1 ? (li & ~63) | ((li & 31) << 1) | ((li >> 5) & 1) : li;
  const uint32_t gmask = kTpl == 1 ? 0u : ((1u << kTpl) - 1u) << ((tid & 31) & ~(kTpl - 1));
  Grid16<kTpl> grid{cells + col, kTpl == 1 ? bt : bt + 2, tid % kTpl, gmask, false};

  Lane s;
  s.ob = obst + li;
  load_regs<kHook>(p.regs_in, B, lane, bt, sh, s);
  s.shift = grid.agent_row(s.x, s.y, sh);
  for (int r = grid.sub; r < hw; r += kTpl) grid.store(wrap_row(r + s.shift, hw), p.words_in[r * B + lane]);
  Ctl ctl{};
  if (kCtl) {
    ctl.consumed = p.ctl_in[lane];
    ctl.steps_done = p.ctl_in[B + lane];
    ctl.frozen = p.ctl_in[2 * B + lane];
  }
  grid.sync();
  bool reset_any = false;
  float rsum = 0.0f;
  int episodes = 0;
  int checksum = 0;
  for (int t = 0; t < p.T; ++t) {
    const int a = p.actions[t * B + lane];
    bool done;
    float reward;
    if (!step_lane_grid<kHook, kCtl>(grid, bt, tab, p.tmpl_words, p.tmpl_regs, B, lane, sh, a, p.T, s, ctl,
                                     reward, done))
      break;
    if (done) {
      reset_any = true;
      episodes += 1;
    }
    rsum = __fadd_rn(rsum, reward);
    grid.sync();  // the step's writes (a reset's rows from every thread) before the view
    checksum += view_checksum16<kView, kTpl>(grid, sh, s);
  }
#pragma unroll
  for (int o = 1; o < kTpl; o <<= 1) checksum += __shfl_xor_sync(gmask, checksum, o, kTpl);
  grid.sync();
  if (grid.bad) __trap();
  for (int r = grid.sub; r < hw; r += kTpl) p.words_out[r * B + lane] = grid.load(wrap_row(r + s.shift, hw));
  if (grid.sub != 0) return;
  store_regs<kHook>(bt, p.regs_out, p.regs_in, p.tmpl_regs, reset_any, B, lane, sh, p.num_regs, s);
  p.rsum_out[lane] = rsum;
  p.counts_out[lane] = episodes;
  p.counts_out[B + lane] = checksum;
  if (kCtl) {
    p.ctl_out[lane] = ctl.consumed;
    p.ctl_out[B + lane] = ctl.steps_done;
    p.ctl_out[2 * B + lane] = ctl.frozen;
  }
}

template <class Kernel>
int launch_kernel(Kernel kernel, const Params& p, int threads, int lane_block, int smem, cudaStream_t stream,
                  int* blocks_per_sm) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks_per_sm != nullptr)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, threads, smem));
  const int blocks = (p.B + lane_block - 1) / lane_block;
  kernel<<<blocks, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// kTpl threads a lane; kView 0 is the generic kernel.
template <int kHook, int kTpl, int kView>
int launch_hook(const Params& p, bool ctl, int lane_block, int smem, cudaStream_t stream, int* blocks_per_sm) {
  const int threads = lane_block * kTpl;
  if constexpr (kView == 0) {
    return ctl ? launch_kernel(rollout_generic<kHook, true>, p, threads, lane_block, smem, stream, blocks_per_sm)
               : launch_kernel(rollout_generic<kHook, false>, p, threads, lane_block, smem, stream, blocks_per_sm);
  } else {
    return ctl ? launch_kernel(rollout_cells16<kHook, true, kTpl, kView>, p, threads, lane_block, smem, stream,
                               blocks_per_sm)
               : launch_kernel(rollout_cells16<kHook, false, kTpl, kView>, p, threads, lane_block, smem, stream,
                               blocks_per_sm);
  }
}

template <int kTpl, int kView>
int launch_variant(const Params& p, int hook, bool ctl, int lane_block, int smem, cudaStream_t stream,
                   int* blocks_per_sm) {
  switch (hook) {
    case kHookNone: return launch_hook<kHookNone, kTpl, kView>(p, ctl, lane_block, smem, stream, blocks_per_sm);
    case kHookPickupTarget:
      return launch_hook<kHookPickupTarget, kTpl, kView>(p, ctl, lane_block, smem, stream, blocks_per_sm);
    case kHookFetch: return launch_hook<kHookFetch, kTpl, kView>(p, ctl, lane_block, smem, stream, blocks_per_sm);
    case kHookGoToDoor:
      return launch_hook<kHookGoToDoor, kTpl, kView>(p, ctl, lane_block, smem, stream, blocks_per_sm);
    case kHookGoToObject:
      return launch_hook<kHookGoToObject, kTpl, kView>(p, ctl, lane_block, smem, stream, blocks_per_sm);
    case kHookPutNear:
      return launch_hook<kHookPutNear, kTpl, kView>(p, ctl, lane_block, smem, stream, blocks_per_sm);
    case kHookRedBlueDoors:
      return launch_hook<kHookRedBlueDoors, kTpl, kView>(p, ctl, lane_block, smem, stream, blocks_per_sm);
    case kHookMemory: return launch_hook<kHookMemory, kTpl, kView>(p, ctl, lane_block, smem, stream, blocks_per_sm);
    case kHookUnlock: return launch_hook<kHookUnlock, kTpl, kView>(p, ctl, lane_block, smem, stream, blocks_per_sm);
    case kHookDynamicObstacles:
      return launch_hook<kHookDynamicObstacles, kTpl, kView>(p, ctl, lane_block, smem, stream, blocks_per_sm);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
