// The policy kernel's instantiations under the DynamicObstacles hooks (the
// pre-hook's walk, the remap and the collision post-hook), in 128-lane
// blocks (16x16 with its 8 obstacles fits them). Replaces, with
// policy_kernel.cu, the TPU kernel
// minigrid_tpu/ops/policy_rollout.py::_policy_kernel.

#include "policy_kernel.cuh"

namespace mg_policy {

int launch_dynobst(const Params& p, int lane_block, bool collect, bool ctl, int smem, cudaStream_t stream) {
  return launch_hook<kHookDynamicObstacles, false>(p, lane_block, collect, ctl, smem, stream);
}

}  // namespace mg_policy
