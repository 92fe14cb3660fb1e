// The policy kernel's instantiations under the family hooks of
// Fetch, GoToDoor and GoToObject: every family of these hooks fits
// 128-lane blocks. Replaces, with policy_kernel.cu, the TPU kernel
// minigrid_tpu/ops/policy_rollout.py::_policy_kernel.

#include "policy_kernel.cuh"

namespace mg_policy {

int launch_fetch_goto(const Params& p, int hook, int lane_block, bool collect, bool ctl, int smem,
                      cudaStream_t stream) {
  switch (hook) {
    case kHookFetch: return launch_hook<kHookFetch, false>(p, lane_block, collect, ctl, smem, stream);
    case kHookGoToDoor: return launch_hook<kHookGoToDoor, false>(p, lane_block, collect, ctl, smem, stream);
    case kHookGoToObject: return launch_hook<kHookGoToObject, false>(p, lane_block, collect, ctl, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace mg_policy
