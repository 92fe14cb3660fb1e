// Policy-in-the-loop packed rollout kernel for Hopper (sm_90a), in eval and
// collect mode.
//
// Replaces the TPU kernel minigrid_tpu/ops/policy_rollout.py::_policy_kernel
// with the ported family hooks (the pickup-target hook; the others are
// still to port). It runs T steps per lane in one launch. Each step takes the actor on the lane's pre-step
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
//  * Instantiated: every combination of BT in {64, 32}, kCollect, kCtl and
//    kHook in {none, pickup-target} that a ported family reaches, which is
//    all but <64, collect, ctl, no hook>: the only random layout without a
//    hook is MultiRoom, at 25x25 in 32-lane blocks (mg_policy_launch
//    refuses that one with cudaErrorInvalidValue).
//  * Under kCtl a lane that can no longer commit stays in the T loop,
//    since all 256 threads take part in the products and the barriers: it
//    draws no action, takes no step, adds nothing to its sums, reads no
//    view (its feature row stays zero) and writes nothing until the end.
//    step_lane_ex decides the commit before it writes the grid, so the
//    step that freezes a lane leaves no trace.
//  * Shared memory at 8x8, BT = 64: features 125 KB, h1 33 KB, h2 36 KB,
//    head weights 10 KB, grids 16 KB: 221 KB, one block per SM.

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "policy_device.cuh"
#include "step_device.cuh"
#include "threefry.cuh"

namespace {

constexpr uint32_t kSeedSalt = 0x243F6A88u;

struct PolicyParams {
  const int32_t* words_in;    // (HW, B), agent-centred
  const int32_t* regs_in;     // (num_regs, B)
  const int32_t* tmpl_words;  // (HW, B)
  const int32_t* tmpl_regs;   // (num_regs, B)
  const int32_t* seeds;       // (T, B)
  const int32_t* tables;      // [off_fwd (4); off_view (4 * V * V)]
  const uint4* w1frag;        // (16, K/16, 32) x 8 bf16: W1 (K = V*V*20 padded to 16) in A-fragment order
  const __nv_bfloat16* b1;    // (256,)
  const uint4* w2frag;        // (16, 16, 32) x 8 bf16: W2 in mma A-fragment order
  const __nv_bfloat16* b2;    // (256,)
  const float* wta;           // (8, 256)
  const float* ba;            // (8,)
  int32_t* words_out;
  int32_t* regs_out;
  float* rsum_out;      // (B,)
  int32_t* counts_out;  // (2, B): episodes; obs checksum
  int32_t* spill;       // collect mode: (T, spill_rows, B); unused in eval mode
  const int32_t* ctl_in;  // kCtl: (3, B) commit rows
  int32_t* ctl_out;       // kCtl: (3, B)
  int B, T, width, height, view, max_steps, see_through_walls, num_regs, num_actions, spill_rows;
};

// `sample_categorical_with_logp` for one lane: inverse CDF over the first
// A logits. With kLogp it also sets `logp` to the drawn action's
// log-probability, (l_a - m) - log(total), as the reference orders it.
template <bool kLogp>
__device__ __forceinline__ int sample_action(const float (&logit)[kHeadRows], int num_actions,
                                             int32_t seed, float& logp) {
  const uint32_t u31 = threefry2x32(static_cast<uint32_t>(seed), kSeedSalt, 0u, 0u).x & 0x7FFFFFFFu;
  const float u01 = __fmul_rn(__int2float_rn(static_cast<int>(u31)), 0x1p-31f);
  float m = logit[0];
#pragma unroll
  for (int i = 1; i < kHeadRows; ++i)
    if (i < num_actions) m = fmaxf(m, logit[i]);
  float cums[kHeadRows];
  float cum = 0.0f;
#pragma unroll
  for (int i = 0; i < kHeadRows; ++i) {
    if (i < num_actions) cum = __fadd_rn(cum, expf(__fsub_rn(logit[i], m)));
    cums[i] = cum;
  }
  const float thresh = __fmul_rn(u01, cum);
  int hits = 0;
#pragma unroll
  for (int i = 0; i < kHeadRows; ++i)
    if (i < num_actions) hits += cums[i] > thresh ? 1 : 0;
  const int action = num_actions - hits;
  if (kLogp) {
    float l_a = 0.0f;
#pragma unroll
    for (int i = 0; i < kHeadRows; ++i)
      if (i < num_actions && action == i) l_a = logit[i];
    logp = __fsub_rn(__fsub_rn(l_a, m), logf(cum));
  }
  return action;
}

template <int BT, bool kCollect, bool kCtl, int kHook>
__global__ void __launch_bounds__(kThreads, 1) policy_kernel(const PolicyParams p) {
  constexpr int kNTiles = BT / 8;  // n8 tiles of the products
  constexpr int kH2Stride = BT + 8;
  const int v = p.view;
  const int v2 = v * v;
  const int k_tiles = padded_features(v) / 16;
  const int f_stride = padded_features(v) + 8;  // bf16 per lane row of the features

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* h1s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BT][kH1Stride]
  float* part_s = reinterpret_cast<float*>(smem_raw);  // [kParts][8][BT]: aliases h1
  __nv_bfloat16* feat_s = h1s + BT * kH1Stride;        // [BT][f_stride]
  __nv_bfloat16* h2s = feat_s + BT * f_stride;         // [256][kH2Stride]
  float* wta_s = reinterpret_cast<float*>(h2s + kHidden * kH2Stride);
  float* b1_s = wta_s + kHeadRows * kHidden;
  float* b2_s = b1_s + kHidden;
  float* ba_s = b2_s + kHidden;
  const StepShape sh{p.width, p.height, p.width * p.height, v, p.max_steps, p.see_through_walls};
  int32_t* grid_s = reinterpret_cast<int32_t*>(ba_s + kHeadRows);
  int32_t* tab = grid_s + sh.hw * BT;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int ln = tid & 31;
  const int g8 = ln >> 2;
  const int t4 = ln & 3;
  for (int i = tid; i < 4 + 4 * v2; i += kThreads) tab[i] = p.tables[i];
  for (int i = tid; i < kHeadRows * kHidden; i += kThreads) wta_s[i] = p.wta[i];
  for (int i = tid; i < kHidden; i += kThreads) {
    b1_s[i] = __bfloat162float(p.b1[i]);
    b2_s[i] = __bfloat162float(p.b2[i]);
  }
  if (tid < kHeadRows) ba_s[tid] = p.ba[tid];
  // Features start at zero; f_stride * 2 bytes is a multiple of 16.
  uint4* feat_words = reinterpret_cast<uint4*>(feat_s);
  const int feat_uint4 = BT * f_stride / 8;
  for (int i = tid; i < feat_uint4; i += kThreads) feat_words[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  const size_t B = static_cast<size_t>(p.B);
  const int lane = blockIdx.x * BT + tid;  // the env lane of threads tid < BT
  const bool live = tid < BT && lane < p.B;
  int32_t* g = grid_s + tid;
  unsigned short* frow = reinterpret_cast<unsigned short*>(feat_s + tid * f_stride);
  // Collect mode: slab t of the spill holds step t's pre-step obs words in
  // rows 0..V*V-1, then the action, logp, value, reward and done rows,
  // then zero rows; each row is lane-contiguous.
  const size_t slab = static_cast<size_t>(p.spill_rows) * B;
  int32_t* spill_lane = kCollect ? p.spill + lane : nullptr;
  Lane s{};
  Ctl ctl{};
  bool reset_any = false;
  float rsum = 0.0f;
  int episodes = 0;
  int checksum = 0;
  if (live) {
    load_lane(g, BT, p.words_in, p.regs_in, B, lane, sh.hw, s);
    if (kCtl) {
      ctl.consumed = p.ctl_in[lane];
      ctl.steps_done = p.ctl_in[B + lane];
      ctl.frozen = p.ctl_in[2 * B + lane];
    }
    const bool spills = kCollect && (!kCtl || (ctl.steps_done < p.T && ctl.frozen == 0));
    read_view<true>(g, BT, tab, sh, s, [&](int kv, int w) {
      set_features(frow, kv, v2, w & 0xFFF);
      if (spills) spill_lane[kv * B] = w & 0xFFF;
    });
  }
  __syncthreads();

  for (int t = 0; t < p.T; ++t) {
    // ---- layer 1 on the tensor cores: h1 = relu(bf16(bf16(W1 . feats) + b1)) ----
    {
      float c[2][kNTiles][4];
      warp_product<BT>(c, p.w1frag, k_tiles, feat_s, f_stride, warp, ln);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int o = (warp * 2 + mi) * 16 + g8;
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt) {
          const int n = nt * 8 + 2 * t4;
          unsigned short* h = reinterpret_cast<unsigned short*>(h1s);
          h[n * kH1Stride + o] = static_cast<unsigned short>(bias_relu(c[mi][nt][0], b1_s[o]));
          h[(n + 1) * kH1Stride + o] = static_cast<unsigned short>(bias_relu(c[mi][nt][1], b1_s[o]));
          h[n * kH1Stride + o + 8] = static_cast<unsigned short>(bias_relu(c[mi][nt][2], b1_s[o + 8]));
          h[(n + 1) * kH1Stride + o + 8] = static_cast<unsigned short>(bias_relu(c[mi][nt][3], b1_s[o + 8]));
        }
      }
    }
    __syncthreads();

    // ---- layer 2 on the tensor cores: h2 = relu(bf16(bf16(W2 . h1) + b2)) ----
    {
      float c[2][kNTiles][4];
      warp_product<BT>(c, p.w2frag, kKTiles, h1s, kH1Stride, warp, ln);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int o = (warp * 2 + mi) * 16 + g8;
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt) {
          const int n = nt * 8 + 2 * t4;
          *reinterpret_cast<uint32_t*>(h2s + o * kH2Stride + n) =
              bias_relu(c[mi][nt][0], b2_s[o]) | (bias_relu(c[mi][nt][1], b2_s[o]) << 16);
          *reinterpret_cast<uint32_t*>(h2s + (o + 8) * kH2Stride + n) =
              bias_relu(c[mi][nt][2], b2_s[o + 8]) | (bias_relu(c[mi][nt][3], b2_s[o + 8]) << 16);
        }
      }
    }
    __syncthreads();

    // ---- the f32 head, each lane's dot split over kThreads / BT threads;
    //      the features are cleared for the next view meanwhile ----
    for (int i = tid; i < feat_uint4; i += kThreads) feat_words[i] = make_uint4(0, 0, 0, 0);
    head_partials<BT>(h2s, wta_s, part_s, tid);
    __syncthreads();

    // ---- per lane: logits, the draw, the env step, the next view ----
    if (live && (!kCtl || (ctl.steps_done < p.T && ctl.frozen == 0))) {
      float logit[kHeadRows];
      head_logits<BT>(logit, part_s, ba_s, tid);
      float logp = 0.0f;
      const int a = sample_action<kCollect>(logit, p.num_actions, p.seeds[t * B + lane], logp);
      bool done;
      float reward;
      // Under kCtl a step that would reuse the consumed template freezes
      // the lane instead and leaves nothing behind.
      if (step_lane_ex<kHook, kCtl>(g, BT, tab, p.tmpl_words, p.tmpl_regs, B, lane, sh, a, p.T, s, ctl,
                                    reward, done)) {
        if (done) {
          reset_any = true;
          episodes += 1;
        }
        rsum = __fadd_rn(rsum, reward);
        if (kCollect) {
          int32_t* row = spill_lane + t * slab + v2 * B;
          row[0] = a;
          row[B] = __float_as_int(logp);
          row[2 * B] = __float_as_int(logit[kHeadRows - 1]);
          row[3 * B] = __float_as_int(reward);
          row[4 * B] = done ? 1 : 0;
          for (int r = v2 + 5; r < p.spill_rows; ++r) spill_lane[t * slab + r * B] = 0;
        }
        // The next step's obs rows, unless this lane has committed its
        // chunk (under kCtl) or this was the last step.
        const bool more = t + 1 < p.T && (!kCtl || ctl.steps_done < p.T);
        int32_t* next_obs = kCollect && more ? spill_lane + (t + 1) * slab : nullptr;
        int obs_sum = 0;
        read_view<true>(g, BT, tab, sh, s, [&](int kv, int w) {
          const int m = w & 0xFFF;
          set_features(frow, kv, v2, m);
          obs_sum += tcs(m);
          if (kCollect && next_obs != nullptr) next_obs[kv * B] = m;
        });
        checksum += obs_sum;
      }
    }
    __syncthreads();
  }

  if (live) {
    store_lane(g, BT, p.words_out, p.regs_out, p.regs_in, p.tmpl_regs, reset_any, B, lane, sh.hw,
               p.num_regs, s);
    p.rsum_out[lane] = rsum;
    p.counts_out[lane] = episodes;
    p.counts_out[B + lane] = checksum;
    if (kCtl) {
      p.ctl_out[lane] = ctl.consumed;
      p.ctl_out[B + lane] = ctl.steps_done;
      p.ctl_out[2 * B + lane] = ctl.frozen;
    }
  }
}

template <int BT, bool kCollect, bool kCtl, int kHook>
int launch(const PolicyParams& p, int smem, cudaStream_t stream) {
  if constexpr (BT == 64 && kCollect && kCtl && kHook == kHookNone) {
    return static_cast<int>(cudaErrorInvalidValue);  // not built: no ported family reaches it
  } else {
    cudaError_t err = cudaFuncSetAttribute(policy_kernel<BT, kCollect, kCtl, kHook>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = (p.B + BT - 1) / BT;
    policy_kernel<BT, kCollect, kCtl, kHook><<<blocks, kThreads, smem, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
}

template <int BT, bool kCollect, bool kCtl>
int launch_hook(const PolicyParams& p, int hook, int smem, cudaStream_t stream) {
  if (hook == kHookNone) return launch<BT, kCollect, kCtl, kHookNone>(p, smem, stream);
  if (hook == kHookPickupTarget) return launch<BT, kCollect, kCtl, kHookPickupTarget>(p, smem, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int BT>
int launch_mode(const PolicyParams& p, bool collect, bool ctl, int hook, int smem, cudaStream_t stream) {
  if (collect) {
    return ctl ? launch_hook<BT, true, true>(p, hook, smem, stream)
               : launch_hook<BT, true, false>(p, hook, smem, stream);
  }
  return ctl ? launch_hook<BT, false, true>(p, hook, smem, stream)
             : launch_hook<BT, false, false>(p, hook, smem, stream);
}

}  // namespace

extern "C" {

// Launch the policy rollout on `stream` with `smem_bytes` of dynamic shared
// memory per block (ops/policy_rollout.py::policy_smem_bytes, the layout
// policy_kernel carves) and family hook `hook` (kHookNone or
// kHookPickupTarget); returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a lane block other than 32 or 64, an unknown
// hook, or the one combination not built). A non-null `spill` selects
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
                     int spill_rows, int hook, int lane_block, int smem_bytes, void* stream) {
  PolicyParams p;
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool collect = spill != nullptr;
  const bool ctl = ctl_in != nullptr;
  if (lane_block == 64) return launch_mode<64>(p, collect, ctl, hook, smem_bytes, s);
  if (lane_block == 32) return launch_mode<32>(p, collect, ctl, hook, smem_bytes, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
