// The rollout kernel's 16-bit-cell instantiations at view 7 with 4 threads
// a lane (rollout_kernel.cu describes the kernel): every hook, with and
// without the commit rows.

#include "rollout_kernel.cuh"

namespace mg_rollout {

int launch_cells16_t4(const Params& p, int hook, bool ctl, int lane_block, int smem, cudaStream_t stream,
                      int* blocks_per_sm) {
  return launch_variant<4, 7>(p, hook, ctl, lane_block, smem, stream, blocks_per_sm);
}

}  // namespace mg_rollout
