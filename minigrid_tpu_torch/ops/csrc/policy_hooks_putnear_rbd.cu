// The policy kernel's instantiations under the family hooks of
// PutNear and RedBlueDoors, in 128-lane blocks (the largest grid, 16x8,
// fits them). Replaces, with policy_kernel.cu, the TPU kernel
// minigrid_tpu/ops/policy_rollout.py::_policy_kernel.

#include "policy_kernel.cuh"

namespace mg_policy {

int launch_putnear_rbd(const Params& p, int hook, int lane_block, bool collect, bool ctl, int smem,
                       cudaStream_t stream) {
  switch (hook) {
    case kHookPutNear: return launch_hook<kHookPutNear, false>(p, lane_block, collect, ctl, smem, stream);
    case kHookRedBlueDoors: return launch_hook<kHookRedBlueDoors, false>(p, lane_block, collect, ctl, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace mg_policy
