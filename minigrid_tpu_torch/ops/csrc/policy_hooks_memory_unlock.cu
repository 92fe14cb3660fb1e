// The policy kernel's instantiations under the family hooks of Memory
// and Unlock, in 128-lane blocks (Memory's largest grid, 17x17, fits
// them). Replaces, with policy_kernel.cu, the TPU kernel
// minigrid_tpu/ops/policy_rollout.py::_policy_kernel.

#include "policy_kernel.cuh"

namespace mg_policy {

int launch_memory_unlock(const Params& p, int hook, int lane_block, bool collect, bool ctl, int smem,
                         cudaStream_t stream) {
  switch (hook) {
    case kHookMemory: return launch_hook<kHookMemory, false>(p, lane_block, collect, ctl, smem, stream);
    case kHookUnlock: return launch_hook<kHookUnlock, false>(p, lane_block, collect, ctl, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace mg_policy
