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
// Design (rollout_kernel.cuh). In-kernel cycle counts (tools/
// b1_cycle_split.py) put 89-95 % of a lane-step in the view read where
// there is no walk, and the kernel at 2-4 resident warps an SM on 16x16
// and 25x25 grids, whose int32 grids filled shared memory. So:
//  * 16-bit cells: the lane's grid lives in shared memory as 16-bit cells
//    (a word's 20 bits without the unused high bits of colour and state),
//    packed at load and store and unpacked by the step; a word that does
//    not fit traps the launch. Half the bytes, so twice the lanes an SM
//    holds. The cells sit at their absolute rows, so an in-bounds view
//    cell is read at its world position without a modulo.
//  * Several threads a lane where one thread a lane leaves the card short
//    of warps (B = 32,768, or large grids): four threads run the lane's
//    step alike and split the view rows and the flood's row masks (gathered
//    with shuffles in a fixed order), the grid loads and stores and a
//    reset's rows; the checksum is an int32 sum.
//  * The view unrolled for the registry's view size (7): per step the
//    physical row steps by a constant along a view row, and the in-bounds
//    cells are a run of columns; the flood runs on unrolled row masks.
//  * The plan (ops/fused_rollout.py::rollout_plan): lanes a block, threads
//    a lane and cell width chosen for resident warps, from
//    `mg_rollout_occupancy` (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
//    on the card.
//  The generic kernel keeps the first design (one thread a lane, int32
//  cells, the view through offset tables) for any other view size and for
//  families whose words the configuration does not let into 16 bits.
//  Instantiations: rollout_generic here, rollout_cells16 in
//  rollout_cells16_t1.cu and rollout_cells16_t4.cu (compiled in parallel).
//  The DynamicObstacles obstacles' coordinates live in shared memory after
//  the offset tables, [4n][bt] int32 (committed and new).

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "rollout_kernel.cuh"

namespace mg_rollout {

int launch_generic(const Params& p, int hook, bool ctl, int lane_block, int smem, cudaStream_t stream,
                   int* blocks_per_sm) {
  return launch_variant<1, 0>(p, hook, ctl, lane_block, smem, stream, blocks_per_sm);
}

}  // namespace mg_rollout

namespace {

// The plan variant of (threads a lane, cell bits), or null.
using LaunchFn = int (*)(const Params&, int, bool, int, int, cudaStream_t, int*);

LaunchFn variant_for(int threads_per_lane, int cell_bits, int view) {
  if (cell_bits == 32 && threads_per_lane == 1) return mg_rollout::launch_generic;
  if (cell_bits == 16 && view == 7 && threads_per_lane == 1) return mg_rollout::launch_cells16_t1;
  if (cell_bits == 16 && view == 7 && threads_per_lane == 4) return mg_rollout::launch_cells16_t4;
  return nullptr;
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
// DynamicObstacles obstacles (0 for any other hook), under the plan
// (`lane_block` lanes a block, `threads_per_lane`, `cell_bits` 16 or 32,
// `smem` bytes of shared memory: ops/fused_rollout.py::rollout_plan); a
// non-null `ctl_in` runs the chunked-regen commit protocol and writes
// `ctl_out`; a word that does not fit a 16-bit cell traps the launch.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for an
// unknown hook or plan).
int mg_rollout_launch(const void* words_in, const void* regs_in, const void* tmpl_words,
                      const void* tmpl_regs, const void* actions, const void* tables,
                      const void* ctl_in, void* words_out, void* regs_out, void* rsum_out,
                      void* counts_out, void* ctl_out, int B, int T, int width,
                      int height, int view, int max_steps, int see_through_walls, int num_regs,
                      int hook, int n_obst, int lane_block, int threads_per_lane, int cell_bits,
                      int smem, void* stream) {
  const LaunchFn fn = variant_for(threads_per_lane, cell_bits, view);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
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
  return fn(p, hook, ctl_in != nullptr, lane_block, smem, static_cast<cudaStream_t>(stream), nullptr);
}

// Blocks of the plan's kernel (`lane_block` lanes, `threads_per_lane`,
// `cell_bits`, at `view`, `smem` bytes) that one SM holds at once,
// from cudaOccupancyMaxActiveBlocksPerMultiprocessor; a negative value is
// the negated cudaError_t.
int mg_rollout_occupancy(int hook, int ctl, int view, int lane_block, int threads_per_lane, int cell_bits,
                         int smem) {
  const LaunchFn fn = variant_for(threads_per_lane, cell_bits, view);
  if (fn == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  int blocks = 0;
  const int err = fn(p, hook, ctl != 0, lane_block, smem, nullptr, &blocks);
  return err != 0 ? -err : blocks;
}

const char* mg_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
