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
// What bounds it on the card: arithmetic. At Empty-8x8 a lane-step needs
// 147 W1 rows of 256 (37,632 adds, counted as the input needs them), a
// 256 x 256 product (131,072 FLOP) and the head (4,096 FLOP): about 173k
// FLOP against about 9 B of state and seed traffic, far above the card's
// 295 FLOP/B balance point. Collect mode adds 4 * spill_rows bytes of
// writes per lane-step (224 B at V = 7), still below that point.
//
// Design (simple and right first; what is left for speed is in PERF.md):
//  * One block of BT lanes (64, or 32 on large grids) and 256 threads, the
//    T loop inside. Env work is one thread per lane on the first BT
//    threads, as in the rollout kernel; the network spreads over all 256.
//  * Both torso layers run on the tensor cores with mma.sync m16n8k16 (bf16
//    in, f32 accumulate); each warp owns 32 rows of the 256 hidden units
//    and all BT lanes. A is the weight matrix, stored once on the host in
//    A-fragment order so that each thread loads its fragment as one
//    16-byte read from L2, one k tile ahead (three ahead measured slower,
//    PERF.md). B sits in shared memory as [lane][k] bf16, each row padded
//    by 8 so that the fragments load without bank conflicts.
//  * Layer 1 multiplies the dense one-hot features: the lane's thread
//    writes a bf16 1.0 for each (cell, channel) of the view into its
//    zeroed row of V*V*20 (padded to whole k tiles), and a channel value at
//    or above its width writes nothing. This does 980 / 147 times the adds
//    a gather of W1 rows would, but on the tensor cores: a gather on CUDA
//    cores, issue-bound on one 16-byte load, 8 unpacks and 8 adds per row,
//    took 2.4 times as long at the main path's shape (PERF.md). Bf16 ones
//    and weights multiply exactly, so only the order of the f32 sums
//    differs from the reference.
//  * The head stays f32, as the reference computes it (no TF32): each lane's
//    256-term dot is split over 256 / BT threads, then summed in a fixed
//    order by the lane's thread.
//  * Casts follow the reference: h = bf16(acc); bf16 + bf16 is an f32 add
//    rounded once to bf16 (as torch and XLA:CPU add two bf16); relu. The
//    sampling uses the round-to-nearest intrinsics and the accurate expf
//    (the library is built without --use_fast_math), one operation at a
//    time, as `sample_categorical` orders them.
//  * The spill is written by the lane's thread, one lane-contiguous row at
//    a time: a slab's obs rows while the view is read (at the load for
//    step 0, after step t - 1 for step t), its scalar rows after the draw
//    and the env step. Nothing is written after the last step.
//  * Instantiated: every kCollect and kCtl, under each hook at the lane
//    blocks its families reach: no hook, pickup-target, RedBlueDoors,
//    Memory and DynamicObstacles at BT 64 and 32, Fetch, GoToDoor,
//    GoToObject, PutNear and Unlock at BT 64 (60 kernels). The template is
//    in policy_kernel.cuh; the family hooks are instantiated in
//    policy_hooks_fetch_goto.cu, policy_hooks_putnear_rbd.cu,
//    policy_hooks_memory_unlock.cu and policy_hooks_dynobst.cu, so that
//    the five files compile in parallel. A combination not built returns
//    cudaErrorInvalidValue.
//  * The DynamicObstacles obstacles' coordinates sit after the offset
//    tables, [4n][BT] int32 (committed and new), not in registers: 4 KB
//    at 16x16, BT = 32.
//  * Under kCtl a lane that can no longer commit stays in the T loop,
//    since all 256 threads take part in the products and the barriers: it
//    draws no action, takes no step, adds nothing to its sums, reads no
//    view (its feature row stays zero) and writes nothing until the end.
//    step_lane_ex decides the commit before it writes the grid, so the
//    step that freezes a lane leaves no trace.
//  * Shared memory at 8x8, BT = 64: features 125 KB, h1 33 KB, h2 36 KB,
//    head weights 10 KB, grids 16 KB: 221 KB, one block per SM.

#include "policy_kernel.cuh"

extern "C" {

// Launch the policy rollout on `stream` with `smem_bytes` of dynamic shared
// memory per block (ops/policy_rollout.py::policy_smem_bytes, the layout
// policy_kernel carves), family hook `hook` (an id of step_device.cuh,
// kHookNone to kHookDynamicObstacles) and `n_obst` DynamicObstacles
// obstacles (0 under any other hook); returns the cudaError_t of the launch
// (cudaErrorInvalidValue for an unknown hook, or a lane block the hook is
// not built for). A non-null `spill` selects
// collect mode: the kernel then writes the (T, spill_rows, B) int32
// trajectory slabs there. A non-null `ctl_in` runs the chunked-regen
// commit protocol and writes `ctl_out`, in either mode.
int mg_policy_launch(const void* words_in, const void* regs_in, const void* tmpl_words,
                     const void* tmpl_regs, const void* seeds, const void* tables, const void* w1frag,
                     const void* b1, const void* w2frag, const void* b2, const void* wta,
                     const void* ba, void* words_out, void* regs_out, void* rsum_out,
                     void* counts_out, void* spill, const void* ctl_in, void* ctl_out, int B, int T,
                     int width, int height, int view,
                     int max_steps, int see_through_walls, int num_regs, int num_actions,
                     int spill_rows, int hook, int n_obst, int lane_block, int smem_bytes, void* stream) {
  mg_policy::Params p;
  p.words_in = static_cast<const int32_t*>(words_in);
  p.regs_in = static_cast<const int32_t*>(regs_in);
  p.tmpl_words = static_cast<const int32_t*>(tmpl_words);
  p.tmpl_regs = static_cast<const int32_t*>(tmpl_regs);
  p.seeds = static_cast<const int32_t*>(seeds);
  p.tables = static_cast<const int32_t*>(tables);
  p.w1frag = static_cast<const uint4*>(w1frag);
  p.b1 = static_cast<const __nv_bfloat16*>(b1);
  p.w2frag = static_cast<const uint4*>(w2frag);
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool collect = spill != nullptr;
  const bool ctl = ctl_in != nullptr;
  switch (hook) {
    case kHookNone: return launch_hook<kHookNone, true>(p, lane_block, collect, ctl, smem_bytes, s);
    case kHookPickupTarget:
      return launch_hook<kHookPickupTarget, true>(p, lane_block, collect, ctl, smem_bytes, s);
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
