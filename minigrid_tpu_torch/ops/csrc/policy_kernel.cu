// Policy-in-the-loop packed rollout kernel for Hopper (sm_90a), in eval and
// collect mode.
//
// Replaces the TPU kernel minigrid_tpu/ops/policy_rollout.py::_policy_kernel
// with every family hook (the nine post-hooks, the two action remaps and
// the DynamicObstacles pre-hook, in step_device.cuh). It runs T steps per
// lane in one launch. Each step takes the actor on the lane's pre-step
// view, as `policy_logits` computes it: value-major one-hot features of the
// (V*V) view (hidden cells read as value 0) -> (256 x V*V*20) bf16 product
// -> bf16 + b1 -> relu -> (256 x 256) bf16 product -> bf16 + b2 -> relu ->
// f32 (8 x 256) head + ba; then the inverse-CDF draw of
// `sample_categorical_with_logp` from one Threefry u31 of the lane's
// (t, b) seed (salt 0x243F6A88); then the packed step of step_device.cuh,
// whose post-step view is the next step's input and feeds the obs
// checksum. Outputs are the final words and registers, the per-lane reward
// sum (f32), the per-lane episode count and checksum. Collect mode (a
// template flag; eval mode compiles without it) also spills one
// (spill_rows, B) int32 slab per step, in the JAX package's layout: the
// pre-step obs words (type | colour << 4 | state << 8, 0 where hidden),
// then the action, the bits of logp and of the value (head row 7), the bits
// of the reward, done, and zero rows up to spill_rows. Under the
// chunked-regen commit protocol (`chunk_exact` there; the kCtl template
// flag and a non-null `ctl_in` here) the (3, B) control rows come in and
// go out, T is the chunk length, and a lane that is frozen or has
// committed its T steps takes no further step. Collect mode under kCtl
// spills each committed step at its pass-local row t, which
// ops/chunked_regen.py::_merge_spill moves to the lane's commit cursor
// (invariant I6); rows a lane did not commit are left unwritten (a lane
// may leave the obs rows of the step that froze it) and are never read.
// The family hook (kHook, the ids of ops/packed_hooks.py::KERNEL_HOOK_IDS)
// runs inside step_lane_ex, which reloads the aux rows it reads from the
// template on every reset, in cached mode too.
//
// What bounds it on the card: arithmetic and the weights' trips from L2.
// Counted as the input needs them, an Empty-8x8 lane-step takes 147 W1
// rows of 256 (37,632 adds), a 256 x 256 product (131,072 FLOP) and the
// head (4,096 FLOP): about 173k FLOP against about 9 B of state and seed
// traffic, far above the card's 295 FLOP/B balance point. Collect mode adds
// 4 * spill_rows bytes of writes per lane-step (224 B at V = 7). The dense
// products the design runs take 643k FLOP a lane-step, and every block
// copies the 638,976 B of W1 and W2 from L2 each step, so the bytes from
// L2 per lane-step fall as the block's lane count grows (4,992 at 128).
//
// Design (policy_device.cuh holds the forward's building blocks):
//  * One block of BT lanes (128, or 64 on grids whose 128 lanes do not fit
//    shared memory): BT / 64 warpgroups, each the wgmma M of its 64 lanes.
//    Every step streams W1^T, then W2^T, in 16 KB chunks of 64 (K) x 128
//    (N) through a ring of shared-memory slots (policy_device.cuh), each
//    chunk copied once per block and step by one bulk copy and read by
//    every warpgroup. The T loop runs inside the block.
//  * Layer 1: the A operand is built in registers from each lane's one-hot
//    features, kept as a bitset in shared memory ([K / 32][BT] uint32,
//    bit k the value-major feature row k of
//    ops/policy_rollout.py::_feature_permutation): the lane's thread sets
//    one bit per channel of each view cell as it reads the view (a channel
//    value at or above its width sets none), and a 16-deep k slab of the A
//    fragment is two shifts and masks of one word per row. Bf16 ones and
//    weights multiply exactly, so only the order of the f32 sums differs
//    from the reference. The fragments of slab kt + 1 are built while slab
//    kt's products run (wgmma is asynchronous).
//  * Layer 2 takes h1 straight from the accumulators: the epilogue rounds
//    them (bias + relu in bf16) into A fragments that stay in registers;
//    each N half of h2 is rounded in its epilogue and enters the f32 head
//    at once, as partial dots over the thread's columns, summed over the
//    quad in a fixed order.
//  * The env step, the draw and the view read run on two threads of each
//    quad (one lane each: 64 a warpgroup) between two warpgroup barriers;
//    the warpgroups of a block run their env phases apart from each other,
//    and only the ring binds their products together.
//  * Casts follow the reference: h = bf16(acc); bf16 + bf16 is an f32 add
//    rounded once to bf16 (as torch and XLA:CPU add two bf16); relu. The
//    sampling uses the round-to-nearest intrinsics and the accurate expf
//    (the library is built without --use_fast_math), one operation at a
//    time, as `sample_categorical` orders them.
//  * The spill is written by the lane's thread, one lane-contiguous row at
//    a time: a slab's obs rows while the view is read (at the load for
//    step 0, after step t - 1 for step t), its scalar rows after the draw
//    and the env step. Nothing is written after the last step.
//  * Instantiated: every kCollect and kCtl, under each hook at 128 lanes,
//    and without a hook at 64 lanes too (25 x 25 grids): 44 kernels. The
//    template is in policy_kernel.cuh; the family hooks are instantiated in
//    policy_hooks_fetch_goto.cu, policy_hooks_putnear_rbd.cu,
//    policy_hooks_memory_unlock.cu and policy_hooks_dynobst.cu, so that
//    the five files compile in parallel. A combination not built returns
//    cudaErrorInvalidValue.
//  * The DynamicObstacles obstacles' coordinates sit after the grids,
//    [4n][BT] int32 (committed and new), not in registers.
//  * Under kCtl a lane that can no longer commit stays in the T loop,
//    since its warpgroup's products and barriers need every thread: it
//    draws no action, takes no step, adds nothing to its sums, reads no
//    view (its stale words feed rows nobody reads) and writes nothing until
//    the end. step_lane_ex decides the commit before it writes the grid, so
//    the step that freezes a lane leaves no trace. Lanes past B in the last
//    block do the same.
//  * Shared memory at 8x8, BT = 128: 10 ring slots of 16 KB, grids 32 KB,
//    feature bits 16 KB, head weights 10 KB.

#include "policy_kernel.cuh"

extern "C" {

// Launch the policy rollout on `stream` with `smem_bytes` of dynamic shared
// memory per block (ops/policy_rollout.py::policy_smem_bytes, the layout
// policy_kernel carves), `stages` ring slots (ops/policy_rollout.py::
// policy_plan), family hook `hook` (an id of step_device.cuh,
// kHookNone to kHookDynamicObstacles) and `n_obst` DynamicObstacles
// obstacles (0 under any other hook); returns the cudaError_t of the launch
// (cudaErrorInvalidValue for an unknown hook, or a lane block the hook is
// not built for). A non-null `spill` selects
// collect mode: the kernel then writes the (T, spill_rows, B) int32
// trajectory slabs there. A non-null `ctl_in` runs the chunked-regen
// commit protocol and writes `ctl_out`, in either mode.
int mg_policy_launch(const void* words_in, const void* regs_in, const void* tmpl_words,
                     const void* tmpl_regs, const void* seeds, const void* tables, const void* w1s,
                     const void* b1, const void* w2s, const void* b2, const void* wta,
                     const void* ba, void* words_out, void* regs_out, void* rsum_out,
                     void* counts_out, void* spill, const void* ctl_in, void* ctl_out, int B, int T,
                     int width, int height, int view,
                     int max_steps, int see_through_walls, int num_regs, int num_actions,
                     int spill_rows, int hook, int n_obst, int lane_block, int stages,
                     int smem_bytes, void* stream) {
  mg_policy::Params p;
  p.words_in = static_cast<const int32_t*>(words_in);
  p.regs_in = static_cast<const int32_t*>(regs_in);
  p.tmpl_words = static_cast<const int32_t*>(tmpl_words);
  p.tmpl_regs = static_cast<const int32_t*>(tmpl_regs);
  p.seeds = static_cast<const int32_t*>(seeds);
  p.tables = static_cast<const int32_t*>(tables);
  p.w1s = w1s;
  p.b1 = static_cast<const __nv_bfloat16*>(b1);
  p.w2s = w2s;
  p.b2 = static_cast<const __nv_bfloat16*>(b2);
  p.wta = static_cast<const float*>(wta);
  p.ba = static_cast<const float*>(ba);
  p.words_out = static_cast<int32_t*>(words_out);
  p.regs_out = static_cast<int32_t*>(regs_out);
  p.rsum_out = static_cast<float*>(rsum_out);
  p.counts_out = static_cast<int32_t*>(counts_out);
  p.spill = static_cast<int32_t*>(spill);
  p.ctl_in = static_cast<const int32_t*>(ctl_in);
  p.ctl_out = static_cast<int32_t*>(ctl_out);
  p.B = B;
  p.T = T;
  p.width = width;
  p.height = height;
  p.view = view;
  p.max_steps = max_steps;
  p.see_through_walls = see_through_walls;
  p.num_regs = num_regs;
  p.num_actions = num_actions;
  p.spill_rows = spill_rows;
  p.n_obst = n_obst;
  p.stages = stages;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool collect = spill != nullptr;
  const bool ctl = ctl_in != nullptr;
  switch (hook) {
    case kHookNone: return launch_hook<kHookNone, true>(p, lane_block, collect, ctl, smem_bytes, s);
    case kHookPickupTarget:
      return launch_hook<kHookPickupTarget, false>(p, lane_block, collect, ctl, smem_bytes, s);
    case kHookFetch:
    case kHookGoToDoor:
    case kHookGoToObject:
      return mg_policy::launch_fetch_goto(p, hook, lane_block, collect, ctl, smem_bytes, s);
    case kHookPutNear:
    case kHookRedBlueDoors:
      return mg_policy::launch_putnear_rbd(p, hook, lane_block, collect, ctl, smem_bytes, s);
    case kHookMemory:
    case kHookUnlock:
      return mg_policy::launch_memory_unlock(p, hook, lane_block, collect, ctl, smem_bytes, s);
    case kHookDynamicObstacles: return mg_policy::launch_dynobst(p, lane_block, collect, ctl, smem_bytes, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
