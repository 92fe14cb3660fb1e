// Packed-lane rollout kernel for Hopper (sm_90a), and the launch-check
// probe kernel at the end of the file.
//
// Replaces the TPU kernel minigrid_tpu/ops/fused_rollout.py::_rollout_kernel
// (the base step, every family hook and the chunked-regen control rows; the
// TPU kernel's matmul row reader is a layout choice of that chip, and this
// kernel reads rows by address under every `row_reader`). It runs T
// environment steps per lane in one launch and computes what that kernel
// computes: the family's action remap and pre-hook (the DynamicObstacles
// walk), the 7-action transition, the family post-hook, the
// forward-cell write-back, the re-centring on a forward move, template
// auto-reset, the V*V egocentric view read with out-of-bounds wall fill and
// the carried-object overlay, the occlusion flood, and the per-step obs
// checksum; outputs are the final words and registers, the per-lane reward
// sum (f32), the per-lane episode count and the per-lane checksum. Under
// the chunked-regen commit protocol (`chunk_exact` there, a non-null
// `ctl_in` here) the (3, B) control rows come in and go out, T is the chunk
// length, and a lane that froze or committed its T steps stops.
//
// What bounds it on the card: integer ALU work per lane-step (about V*V
// view-cell reads, each an address computation, a bounds test and a
// shared-memory load, plus the flood when walls occlude). The lane's grid
// stays in shared memory for the whole call, so the only per-step global
// traffic is 4 B of action read per lane-step; template words are read only
// by lanes that reset. Under the DynamicObstacles pre-hook each lane-step
// adds n Threefry-20 evaluations and the walk's coordinate tests.
//
// Design:
//  * One thread per lane. A block of `bt` lanes keeps its grids in shared
//    memory as [HW][bt] int32, so neighbouring threads touch neighbouring
//    banks whatever row each reads, and the global (HW, B) layout loads and
//    stores coalesced.
//  * The per-lane step, its row-offset re-centring, the reward's rounding,
//    the hooks, the commit protocol and the view read are in
//    step_device.cuh, which the policy kernel shares. The hook id and the
//    control rows are template parameters, so the base step compiles as
//    it did without them.
//  * The DynamicObstacles obstacles' coordinates live in shared memory
//    after the offset tables, [4n][bt] int32 (committed and new), not in
//    registers.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "step_device.cuh"

namespace {

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
  float* rsum_out;     // (B,)
  int32_t* counts_out;  // (2, B): episodes; obs checksum
  int32_t* ctl_out;     // (3, B), when ctl_in is not null
  int B, T, width, height, view, max_steps, see_through_walls, num_regs, n_obst;
};

template <int kHook, bool kCtl>
__global__ void rollout_kernel(const Params p) {
  extern __shared__ int32_t smem[];
  const int bt = blockDim.x;
  const int tid = threadIdx.x;
  const StepShape sh{p.width,     p.height,           p.width * p.height, p.view,
                     p.max_steps, p.see_through_walls, p.n_obst,           p.num_regs - 2};
  int32_t* tab = smem + static_cast<size_t>(sh.hw) * bt;  // after the grids
  int32_t* obst = tab + 4 + 4 * p.view * p.view;           // after the tables

  for (int i = tid; i < 4 + 4 * p.view * p.view; i += bt) tab[i] = p.tables[i];
  __syncthreads();  // the only block-wide step; each thread owns its column

  const int lane = blockIdx.x * bt + tid;
  if (lane >= p.B) return;
  const size_t B = static_cast<size_t>(p.B);
  int32_t* g = smem + tid;  // this lane's grid: row r at g[r * bt]

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
    if (!step_lane_ex<kHook, kCtl>(g, bt, tab, p.tmpl_words, p.tmpl_regs, B, lane, sh, a, p.T, s,
                                   ctl, reward, done))
      break;
    if (done) {
      reset_any = true;
      episodes += 1;
    }
    rsum = __fadd_rn(rsum, reward);
    // The post-step observation's checksum; hidden cells count 0.
    int obs_sum = 0;
    read_view<false>(g, bt, tab, sh, s, [&](int, int w) { obs_sum += tcs(w); });
    checksum += obs_sum;
  }

  store_lane<kHook>(g, bt, p.words_out, p.regs_out, p.regs_in, p.tmpl_regs, reset_any, B, lane, sh,
                    p.num_regs, s);
  p.rsum_out[lane] = rsum;
  p.counts_out[lane] = episodes;
  p.counts_out[B + lane] = checksum;
  if (kCtl) {
    p.ctl_out[lane] = ctl.consumed;
    p.ctl_out[B + lane] = ctl.steps_done;
    p.ctl_out[2 * B + lane] = ctl.frozen;
  }
}

template <int kHook, bool kCtl>
int launch_one(const Params& p, int lane_block, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(rollout_kernel<kHook, kCtl>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (p.B + lane_block - 1) / lane_block;
  rollout_kernel<kHook, kCtl><<<blocks, lane_block, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int kHook>
int launch(const Params& p, bool ctl, int lane_block, size_t smem, cudaStream_t stream) {
  return ctl ? launch_one<kHook, true>(p, lane_block, smem, stream)
             : launch_one<kHook, false>(p, lane_block, smem, stream);
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

// Launch the rollout on `stream` with family hook `hook` (an id of
// step_device.cuh, kHookNone to kHookDynamicObstacles) and `n_obst`
// DynamicObstacles obstacles (0 for any other hook); a non-null `ctl_in`
// runs the chunked-regen commit protocol and writes `ctl_out`. Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for an unknown hook).
int mg_rollout_launch(const void* words_in, const void* regs_in, const void* tmpl_words,
                      const void* tmpl_regs, const void* actions, const void* tables,
                      const void* ctl_in, void* words_out, void* regs_out, void* rsum_out,
                      void* counts_out, void* ctl_out, int B, int T, int width, int height,
                      int view, int max_steps, int see_through_walls, int num_regs, int hook,
                      int n_obst, int lane_block, void* stream) {
  Params p;
  p.words_in = static_cast<const int32_t*>(words_in);
  p.regs_in = static_cast<const int32_t*>(regs_in);
  p.tmpl_words = static_cast<const int32_t*>(tmpl_words);
  p.tmpl_regs = static_cast<const int32_t*>(tmpl_regs);
  p.actions = static_cast<const int32_t*>(actions);
  p.tables = static_cast<const int32_t*>(tables);
  p.ctl_in = static_cast<const int32_t*>(ctl_in);
  p.ctl_out = static_cast<int32_t*>(ctl_out);
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
  p.n_obst = n_obst;

  const size_t smem =
      ((static_cast<size_t>(width) * height + 4 * n_obst) * lane_block + 4 + 4 * view * view) *
      sizeof(int32_t);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool ctl = ctl_in != nullptr;
  switch (hook) {
    case kHookNone: return launch<kHookNone>(p, ctl, lane_block, smem, st);
    case kHookPickupTarget: return launch<kHookPickupTarget>(p, ctl, lane_block, smem, st);
    case kHookFetch: return launch<kHookFetch>(p, ctl, lane_block, smem, st);
    case kHookGoToDoor: return launch<kHookGoToDoor>(p, ctl, lane_block, smem, st);
    case kHookGoToObject: return launch<kHookGoToObject>(p, ctl, lane_block, smem, st);
    case kHookPutNear: return launch<kHookPutNear>(p, ctl, lane_block, smem, st);
    case kHookRedBlueDoors: return launch<kHookRedBlueDoors>(p, ctl, lane_block, smem, st);
    case kHookMemory: return launch<kHookMemory>(p, ctl, lane_block, smem, st);
    case kHookUnlock: return launch<kHookUnlock>(p, ctl, lane_block, smem, st);
    case kHookDynamicObstacles: return launch<kHookDynamicObstacles>(p, ctl, lane_block, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* mg_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
