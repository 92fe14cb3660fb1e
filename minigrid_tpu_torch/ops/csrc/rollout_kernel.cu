// Packed-lane rollout kernel for Hopper (sm_90a), and the launch-check
// probe kernel at the end of the file.
//
// Replaces the TPU kernel minigrid_tpu/ops/fused_rollout.py::_rollout_kernel
// (the base step: no family hooks, no chunked-regen control rows, no matmul
// row reader). It runs T environment steps per lane in one launch and
// computes what that kernel computes: the 7-action transition, the
// forward-cell write-back, the re-centring on a forward move, template
// auto-reset, the V*V egocentric view read with out-of-bounds wall fill and
// the carried-object overlay, the occlusion flood, and the per-step obs
// checksum; outputs are the final words and registers, the per-lane reward
// sum (f32), the per-lane episode count and the per-lane checksum.
//
// What bounds it on the card: integer ALU work per lane-step (about V*V
// view-cell reads, each an address computation, a bounds test and a
// shared-memory load, plus the flood when walls occlude). The lane's grid
// stays in shared memory for the whole call, so the only per-step global
// traffic is 4 B of action read per lane-step; template words are read only
// by lanes that reset.
//
// Design:
//  * One thread per lane. A block of `bt` lanes keeps its grids in shared
//    memory as [HW][bt] int32, so neighbouring threads touch neighbouring
//    banks whatever row each reads, and the global (HW, B) layout loads and
//    stores coalesced.
//  * The TPU kernel rolls the whole grid on every forward move only to make
//    its addresses static. Here each thread keeps a row offset instead:
//    logical row s lives at physical row (s + shift) % HW, and a move adds
//    off_fwd[d] to `shift`. The offset is undone when the words are stored,
//    so the carry keeps the JAX package's agent-centred layout.
//  * The reward 1 - 0.9 * (sc / max_steps) is computed with round-to-nearest
//    intrinsics, one operation at a time, so nvcc cannot contract it into a
//    fused multiply-add; the per-lane sum then matches the plain version bit
//    for bit.
//  * Every modulo operand is non-negative (shift and table offsets lie in
//    [0, HW)), so C++'s truncating % never meets a negative value.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kEmpty = 1;
constexpr int kWall = 2;
constexpr int kFloor = 3;
constexpr int kDoor = 4;
constexpr int kKey = 5;
constexpr int kBall = 6;
constexpr int kBox = 7;
constexpr int kGoal = 8;
constexpr int kLava = 9;
constexpr int kStateOpen = 0;
constexpr int kStateLocked = 2;
constexpr int kGrey = 5;
constexpr int kWallWord = kWall | (kGrey << 4);
constexpr int kEmptyWord = kEmpty;
constexpr int kNumScalars = 8;  // x, y, dir, ct, cc, cct, ccc, step_count

struct Params {
  const int32_t* words_in;    // (HW, B), agent-centred
  const int32_t* regs_in;     // (num_regs, B)
  const int32_t* tmpl_words;  // (HW, B), centred on the template agent
  const int32_t* tmpl_regs;   // (num_regs, B)
  const int32_t* actions;     // (T, B)
  const int32_t* tables;      // [off_fwd (4); off_view (4 * V * V)]
  int32_t* words_out;
  int32_t* regs_out;
  float* rsum_out;     // (B,)
  int32_t* counts_out;  // (2, B): episodes; obs checksum
  int B, T, width, height, view, max_steps, see_through_walls, num_regs;
};

__device__ __forceinline__ int wrap_row(int p, int hw) { return p >= hw ? p - hw : p; }

// Type + colour + state of a packed cell word: what the checksum counts.
__device__ __forceinline__ int tcs(int w) { return (w & 15) + ((w >> 4) & 15) + ((w >> 8) & 15); }

__device__ __forceinline__ bool transparent(int w) {
  const int t = w & 15;
  const int s = (w >> 8) & 15;
  return !(t == kWall || (t == kDoor && s != kStateOpen));
}

__global__ void rollout_kernel(const Params p) {
  extern __shared__ int32_t smem[];
  const int bt = blockDim.x;
  const int tid = threadIdx.x;
  const int hw = p.width * p.height;
  const int v = p.view;
  const int v2 = v * v;
  const int half = v / 2;
  int32_t* tab = smem + static_cast<size_t>(hw) * bt;  // after the grids

  for (int i = tid; i < 4 + 4 * v2; i += bt) tab[i] = p.tables[i];
  __syncthreads();  // the only block-wide step; each thread owns its column

  const int lane = blockIdx.x * bt + tid;
  if (lane >= p.B) return;
  const size_t B = static_cast<size_t>(p.B);
  int32_t* g = smem + tid;  // this lane's grid: row r at g[r * bt]

  for (int s = 0; s < hw; ++s) g[s * bt] = p.words_in[s * B + lane];
  int x = p.regs_in[0 * B + lane];
  int y = p.regs_in[1 * B + lane];
  int d = p.regs_in[2 * B + lane];
  int ct = p.regs_in[3 * B + lane];
  int cc = p.regs_in[4 * B + lane];
  int cct = p.regs_in[5 * B + lane];
  int ccc = p.regs_in[6 * B + lane];
  int sc = p.regs_in[7 * B + lane];

  int shift = 0;  // logical row s is physical row (s + shift) % hw
  bool reset_any = false;
  float rsum = 0.0f;
  int episodes = 0;
  int checksum = 0;
  const float max_steps_f = static_cast<float>(p.max_steps);

  for (int t = 0; t < p.T; ++t) {
    const int a = p.actions[t * B + lane];

    // ---- transition --------------------------------------------------------
    const int fp = wrap_row(shift + tab[d], hw);  // forward cell, physical row
    const int fw = g[fp * bt];
    const int ft = fw & 15;
    const int fc = (fw >> 4) & 15;
    const int fs = (fw >> 8) & 15;
    const int fct = (fw >> 12) & 15;
    const int fcc = (fw >> 16) & 15;

    const bool is_fwd = a == 2;
    const int d1 = a == 1 ? (d + 1) % 4 : (a == 0 ? (d + 3) % 4 : d);
    const bool can_overlap = ft == kEmpty || ft == kFloor || ft == kGoal || ft == kLava ||
                             (ft == kDoor && fs == kStateOpen);
    const bool moves = is_fwd && can_overlap;
    const int dirx = (d == 0) - (d == 2);
    const int diry = (d == 1) - (d == 3);

    const int sc1 = sc + 1;
    const bool hit_goal = is_fwd && ft == kGoal;
    const bool terminated = hit_goal || (is_fwd && ft == kLava);
    const float reward =
        hit_goal ? __fsub_rn(1.0f, __fmul_rn(0.9f, __fdiv_rn(static_cast<float>(sc1), max_steps_f)))
                 : 0.0f;

    const bool hands_empty = ct == 0;
    const bool do_pickup = a == 3 && (ft == kKey || ft == kBall || ft == kBox) && hands_empty;
    const bool do_drop = a == 4 && ft == kEmpty && !hands_empty;
    const bool is_toggle = a == 5;

    uint32_t new_fwd = static_cast<uint32_t>(fw);
    if (do_pickup) new_fwd = kEmptyWord;
    if (do_drop) {
      new_fwd = static_cast<uint32_t>(ct) | (static_cast<uint32_t>(cc) << 4) |
                (static_cast<uint32_t>(cct) << 12) | (static_cast<uint32_t>(ccc) << 16);
    }
    if (is_toggle && ft == kDoor) {
      const bool has_key = ct == kKey && cc == fc;
      const int state = fs == kStateLocked ? (has_key ? kStateOpen : kStateLocked) : 1 - fs;
      new_fwd = (static_cast<uint32_t>(fw) & ~(15u << 8)) | (static_cast<uint32_t>(state) << 8);
    }
    if (is_toggle && ft == kBox) {
      new_fwd = static_cast<uint32_t>(fct > 0 ? fct : kEmptyWord) | (static_cast<uint32_t>(fcc) << 4);
    }
    g[fp * bt] = static_cast<int32_t>(new_fwd);

    const int ct1 = do_pickup ? ft : (do_drop ? 0 : ct);
    const int cc1 = do_pickup ? fc : (do_drop ? 0 : cc);
    const int cct1 = do_pickup ? fct : (do_drop ? 0 : cct);
    const int ccc1 = do_pickup ? fcc : (do_drop ? 0 : ccc);

    if (moves) shift = fp;  // re-centre: the forward cell becomes row 0

    // ---- template auto-reset -----------------------------------------------
    if (terminated || sc1 >= p.max_steps) {
      for (int s = 0; s < hw; ++s) g[s * bt] = p.tmpl_words[s * B + lane];
      shift = 0;
      x = p.tmpl_regs[0 * B + lane];
      y = p.tmpl_regs[1 * B + lane];
      d = p.tmpl_regs[2 * B + lane];
      ct = p.tmpl_regs[3 * B + lane];
      cc = p.tmpl_regs[4 * B + lane];
      cct = p.tmpl_regs[5 * B + lane];
      ccc = p.tmpl_regs[6 * B + lane];
      sc = 0;
      reset_any = true;
      episodes += 1;
    } else {
      x = moves ? x + dirx : x;
      y = moves ? y + diry : y;
      d = d1;
      ct = ct1;
      cc = cc1;
      cct = cct1;
      ccc = ccc1;
      sc = sc1;
    }
    rsum = __fadd_rn(rsum, reward);

    // ---- post-step observation checksum ------------------------------------
    const int f0 = (d == 0) - (d == 2);
    const int f1 = (d == 1) - (d == 3);
    const int agent_word = ct > 0 ? (ct | (cc << 4)) : kEmptyWord;
    const int32_t* off_view = tab + 4 + d * v2;
    // Packed word of view cell (row j, col i): the agent's cell shows what
    // it carries; cells off the map read as grey walls.
    auto cell = [&](int j, int i) -> int {
      const int rd = v - 1 - j;
      const int co = i - half;
      if (rd == 0 && co == 0) return agent_word;
      const int wx = x + f0 * rd - f1 * co;
      const int wy = y + f1 * rd + f0 * co;
      if (wx < 0 || wx >= p.width || wy < 0 || wy >= p.height) return kWallWord;
      return g[wrap_row(shift + off_view[j * v + i], hw) * bt];
    };

    int obs_sum = 0;
    if (p.see_through_walls) {
      for (int j = 0; j < v; ++j)
        for (int i = 0; i < v; ++i) obs_sum += tcs(cell(j, i));
    } else {
      // The occlusion flood on V-bit row masks, from the agent's row
      // outwards (ops/packing.py::visibility_bitmask).
      const uint32_t all_bits = (1u << v) - 1u;  // v <= 31 (kernel_lane_block)
      const uint32_t last_clear = all_bits >> 1;
      const uint32_t first_clear = all_bits & ~1u;
      uint32_t carry = 0;
      for (int j = v - 1; j >= 0; --j) {
        uint32_t trow = 0;
        for (int i = 0; i < v; ++i) trow |= static_cast<uint32_t>(transparent(cell(j, i))) << i;
        uint32_t row = carry;
        if (j == v - 1) row |= 1u << half;
        for (int k = 0; k < v - 1; ++k) row |= (row & trow) << 1;
        row &= all_bits;
        const uint32_t q_l = row & trow & last_clear;
        for (int k = 0; k < v - 1; ++k) row |= (row & trow) >> 1;
        const uint32_t q_r = row & trow & first_clear;
        carry = (q_l | (q_l << 1) | q_r | (q_r >> 1)) & all_bits;
        for (int i = 0; i < v; ++i)
          if ((row >> i) & 1u) obs_sum += tcs(cell(j, i));
      }
    }
    checksum += obs_sum;
  }

  // ---- store, undoing the row offset -----------------------------------------
  for (int s = 0; s < hw; ++s) p.words_out[s * B + lane] = g[wrap_row(s + shift, hw) * bt];
  const int scalars[kNumScalars] = {x, y, d, ct, cc, cct, ccc, sc};
  for (int r = 0; r < kNumScalars; ++r) p.regs_out[r * B + lane] = scalars[r];
  // aux, mission and rng rows only change on reset, to the template's.
  const int32_t* tail = reset_any ? p.tmpl_regs : p.regs_in;
  for (int r = kNumScalars; r < p.num_regs; ++r) p.regs_out[r * B + lane] = tail[r * B + lane];
  p.rsum_out[lane] = rsum;
  p.counts_out[lane] = episodes;
  p.counts_out[B + lane] = checksum;
}

// The launch check (replaces the TPU capability probe
// minigrid_tpu/utils/platform.py::mosaic_available, `x + 1` on an (8, 128)
// int32 block): run once per device after the library is loaded, so that a
// library the card cannot run fails there, not inside a rollout.
__global__ void probe_kernel(const int32_t* in, int32_t* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = in[i] + 1;
}

}  // namespace

extern "C" {

// out[i] = in[i] + 1 for i < n, on `stream`; returns the launch's cudaError_t.
int mg_probe_launch(const void* in, void* out, int n, void* stream) {
  constexpr int kThreads = 128;
  probe_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(in), static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// Launch the rollout on `stream`; returns the cudaError_t of the launch.
int mg_rollout_launch(const void* words_in, const void* regs_in, const void* tmpl_words,
                      const void* tmpl_regs, const void* actions, const void* tables,
                      void* words_out, void* regs_out, void* rsum_out, void* counts_out, int B,
                      int T, int width, int height, int view, int max_steps,
                      int see_through_walls, int num_regs, int lane_block, void* stream) {
  Params p;
  p.words_in = static_cast<const int32_t*>(words_in);
  p.regs_in = static_cast<const int32_t*>(regs_in);
  p.tmpl_words = static_cast<const int32_t*>(tmpl_words);
  p.tmpl_regs = static_cast<const int32_t*>(tmpl_regs);
  p.actions = static_cast<const int32_t*>(actions);
  p.tables = static_cast<const int32_t*>(tables);
  p.words_out = static_cast<int32_t*>(words_out);
  p.regs_out = static_cast<int32_t*>(regs_out);
  p.rsum_out = static_cast<float*>(rsum_out);
  p.counts_out = static_cast<int32_t*>(counts_out);
  p.B = B;
  p.T = T;
  p.width = width;
  p.height = height;
  p.view = view;
  p.max_steps = max_steps;
  p.see_through_walls = see_through_walls;
  p.num_regs = num_regs;

  const size_t smem = (static_cast<size_t>(width) * height * lane_block + 4 + 4 * view * view) *
                      sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(rollout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + lane_block - 1) / lane_block;
  rollout_kernel<<<blocks, lane_block, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* mg_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
