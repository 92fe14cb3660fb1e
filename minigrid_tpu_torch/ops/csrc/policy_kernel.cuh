// The policy kernel (policy_kernel.cu describes it) as templates, shared
// by the translation units that instantiate it: policy_kernel.cu (no hook
// and the pickup-target hook, with the C entry point), and
// policy_hooks_fetch_goto.cu, policy_hooks_putnear_rbd.cu,
// policy_hooks_memory_unlock.cu and policy_hooks_dynobst.cu (the other
// family hooks). Each compiles in its own nvcc process, so the build takes
// as long as the largest of them.

#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "policy_device.cuh"
#include "step_device.cuh"
#include "threefry.cuh"

namespace mg_policy {

struct Params {
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
  int n_obst;  // DynamicObstacles obstacles (0 under any other hook)
};

// Launchers of the family-hook instantiations, one per translation unit:
// each returns cudaErrorInvalidValue for a hook or lane block it does not
// build.
int launch_fetch_goto(const Params& p, int hook, int lane_block, bool collect, bool ctl, int smem,
                      cudaStream_t stream);
int launch_putnear_rbd(const Params& p, int hook, int lane_block, bool collect, bool ctl, int smem,
                       cudaStream_t stream);
int launch_memory_unlock(const Params& p, int hook, int lane_block, bool collect, bool ctl, int smem,
                         cudaStream_t stream);
int launch_dynobst(const Params& p, int lane_block, bool collect, bool ctl, int smem, cudaStream_t stream);

}  // namespace mg_policy

namespace {

constexpr uint32_t kSeedSalt = 0x243F6A88u;

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
__global__ void __launch_bounds__(kThreads, 1) policy_kernel(const mg_policy::Params p) {
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
  const StepShape sh{p.width,     p.height,           p.width * p.height, v,
                     p.max_steps, p.see_through_walls, p.n_obst,           p.num_regs - 2};
  int32_t* grid_s = reinterpret_cast<int32_t*>(ba_s + kHeadRows);
  int32_t* tab = grid_s + sh.hw * BT;
  int32_t* obst = tab + 4 + 4 * v2;  // [4n][BT]: the DynamicObstacles rows

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
    s.ob = obst + tid;
    load_lane<kHook>(g, BT, p.words_in, p.regs_in, B, lane, sh, s);
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
    store_lane<kHook>(g, BT, p.words_out, p.regs_out, p.regs_in, p.tmpl_regs, reset_any, B, lane, sh,
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
int launch_one(const mg_policy::Params& p, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(policy_kernel<BT, kCollect, kCtl, kHook>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (p.B + BT - 1) / BT;
  policy_kernel<BT, kCollect, kCtl, kHook><<<blocks, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int BT, int kHook>
int launch_modes(const mg_policy::Params& p, bool collect, bool ctl, int smem, cudaStream_t stream) {
  if (collect) {
    return ctl ? launch_one<BT, true, true, kHook>(p, smem, stream)
               : launch_one<BT, true, false, kHook>(p, smem, stream);
  }
  return ctl ? launch_one<BT, false, true, kHook>(p, smem, stream)
             : launch_one<BT, false, false, kHook>(p, smem, stream);
}

// Every mode of hook kHook in 64-lane blocks, and in 32-lane blocks if
// kWith32 (a family with a grid whose 64 lanes do not fit one block's
// shared memory, ops/policy_rollout.py::policy_lane_block).
template <int kHook, bool kWith32>
int launch_hook(const mg_policy::Params& p, int lane_block, bool collect, bool ctl, int smem,
                cudaStream_t stream) {
  if (lane_block == 64) return launch_modes<64, kHook>(p, collect, ctl, smem, stream);
  if constexpr (kWith32) {
    if (lane_block == 32) return launch_modes<32, kHook>(p, collect, ctl, smem, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
