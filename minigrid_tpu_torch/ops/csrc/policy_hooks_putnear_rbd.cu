// The policy kernel's instantiations under the family hooks of
// PutNear (64-lane blocks) and RedBlueDoors (64-lane blocks at 6x6, 32 at
// its 16x8 grid). Replaces, with policy_kernel.cu, the TPU kernel
// minigrid_tpu/ops/policy_rollout.py::_policy_kernel.

#include "policy_kernel.cuh"

namespace mg_policy {

int launch_putnear_rbd(const Params& p, int hook, int lane_block, bool collect, bool ctl, int smem,
                       cudaStream_t stream) {
  switch (hook) {
    case kHookPutNear: return launch_hook<kHookPutNear, false>(p, lane_block, collect, ctl, smem, stream);
    case kHookRedBlueDoors: return launch_hook<kHookRedBlueDoors, true>(p, lane_block, collect, ctl, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace mg_policy
