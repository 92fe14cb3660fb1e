// The policy kernel's instantiations under the family hooks of Memory
// (64-lane blocks at S7 and S9, 32 from S11 up) and Unlock (64-lane
// blocks). Replaces, with policy_kernel.cu, the TPU kernel
// minigrid_tpu/ops/policy_rollout.py::_policy_kernel.

#include "policy_kernel.cuh"

namespace mg_policy {

int launch_memory_unlock(const Params& p, int hook, int lane_block, bool collect, bool ctl, int smem,
                         cudaStream_t stream) {
  switch (hook) {
    case kHookMemory: return launch_hook<kHookMemory, true>(p, lane_block, collect, ctl, smem, stream);
    case kHookUnlock: return launch_hook<kHookUnlock, false>(p, lane_block, collect, ctl, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace mg_policy
