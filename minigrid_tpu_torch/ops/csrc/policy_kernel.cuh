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
  const void* w1s;            // W1^T in 16 KB chunks (ops/policy_rollout.py::_b_chunks)
  const __nv_bfloat16* b1;    // (256,)
  const void* w2s;            // W2^T in kW2Chunks chunks, (N half, K chunk)
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
  int stages;  // ring slots (3..kMaxStages)
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

// Shared memory as ops/policy_rollout.py::policy_smem_bytes counts it: the
// ring's bookkeeping (policy_device.cuh), `stages` slots of a 16 KB weight
// chunk, the head weights ([256][8] f32) and biases, the offset
// tables, the grids [HW][BT], the DynamicObstacles rows [4n][BT] and the
// lanes' feature bits [K / 32][BT] (uint32).
template <int BT>
struct PolicySmem {
  float *wta, *b1, *b2, *ba;
  int32_t *tab, *grid, *obst;
  uint32_t* feat;

  __device__ PolicySmem(unsigned char* raw, const mg_policy::Params& p) {
    const int v2 = p.view * p.view;
    wta = reinterpret_cast<float*>(raw + kBarBytes + p.stages * kChunkBytes);
    b1 = wta + kHidden * kHeadRows;
    b2 = b1 + kHidden;
    ba = b2 + kHidden;
    tab = reinterpret_cast<int32_t*>(ba + kHeadRows);
    grid = tab + ((4 + 4 * v2 + 3) & ~3);
    obst = grid + p.width * p.height * BT;
    feat = reinterpret_cast<uint32_t*>(obst + 4 * p.n_obst * BT);
  }
};

// One block: BT lanes, 64 per warpgroup.
template <int BT, bool kCollect, bool kCtl, int kHook>
__global__ void __launch_bounds__(BT * 2, 1) policy_kernel(const mg_policy::Params p) {
  constexpr int kGroups = BT / 64;
  const int v = p.view;
  const int v2 = v * v;
  const int k_chunks = padded_features(v) / 64;
  const bool tail = padded_features(v) % 64 != 0;
  const int feat_words = padded_features(v) / 32;
  const int per_step = w1_chunks(v) + kW2Chunks;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const PolicySmem<BT> sm(smem_raw, p);
  const int tid = threadIdx.x;
  if (tid == 0) {
    // Each step: W1^T's chunks, then W2^T's.
    const ChunkSequence sq{{static_cast<const char*>(p.w1s), static_cast<const char*>(p.w2s), nullptr},
                           {w1_chunks(v), kW2Chunks, 0},
                           p.T};
    init_ring(smem_raw, p.stages, sq);
  }
  for (int i = tid; i < 4 + 4 * v2; i += blockDim.x) sm.tab[i] = p.tables[i];
  for (int i = tid; i < kHeadRows * kHidden; i += blockDim.x)
    sm.wta[i] = p.wta[(i % kHeadRows) * kHidden + i / kHeadRows];
  for (int i = tid; i < kHidden; i += blockDim.x) {
    sm.b1[i] = __bfloat162float(p.b1[i]);
    sm.b2[i] = __bfloat162float(p.b2[i]);
  }
  if (tid < kHeadRows) sm.ba[tid] = p.ba[tid];
  __syncthreads();

  // ---- warpgroup wg owns block lanes [64 wg, 64 wg + 64) ----
  const int wg = tid / kWG;
  const int ln = tid & 31;
  const int g8 = ln >> 2;
  const int t4 = ln & 3;
  const int r0 = wg * 64 + ((tid % kWG) >> 5) * 16 + g8;  // rows r0 and r0 + 8 of the fragments
  const bool elected = tid % kWG == 0;
  const int group_bar = 1 + wg;
  // Env work: threads t4 = 0 and 1 of each quad own lanes r0 and r0 + 8.
  const int bl = r0 + 8 * t4;
  const size_t B = static_cast<size_t>(p.B);
  const int lane = blockIdx.x * BT + bl;
  const bool live = t4 < 2 && lane < p.B;
  const StepShape sh{p.width,     p.height,           p.width * p.height, v,
                     p.max_steps, p.see_through_walls, p.n_obst,           p.num_regs - 2};
  int32_t* g = sm.grid + bl;
  uint32_t* fcol = sm.feat + bl;
  Ring ring{smem_raw, p.stages, kGroups, per_step, p.T * per_step};

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
    s.ob = sm.obst + bl;
    load_lane<kHook>(g, BT, p.words_in, p.regs_in, B, lane, sh, s);
    if (kCtl) {
      ctl.consumed = p.ctl_in[lane];
      ctl.steps_done = p.ctl_in[B + lane];
      ctl.frozen = p.ctl_in[2 * B + lane];
    }
    const bool spills = kCollect && (!kCtl || (ctl.steps_done < p.T && ctl.frozen == 0));
    clear_feature_bits(fcol, BT, feat_words);
    read_view<true>(g, BT, sm.tab, sh, s, [&](int kv, int w) {
      set_feature_bits(fcol, BT, kv, v2, w & 0xFFF);
      if (spills) spill_lane[kv * B] = w & 0xFFF;
    });
  }
  bar_sync(group_bar, kWG);

  // Each step's seed is loaded a step ahead, so that its latency hides
  // behind the products (lanes past B read lane B - 1's, unused).
  const size_t seed_lane = static_cast<size_t>(min(lane, p.B - 1));
  int32_t seed_next = p.seeds[seed_lane];
  for (int t = 0; t < p.T; ++t) {
    const int32_t seed = seed_next;
    seed_next = p.seeds[static_cast<size_t>(min(t + 1, p.T - 1)) * B + seed_lane];
    // ---- the actor on the tensor cores: layer 1, layer 2, the head ----
    float head[2][kHeadRows];
    {
      uint32_t h1[kKTiles][4];
      {
        float acc[2][64];
        layer1(acc, ring, sm.feat, BT, k_chunks, tail, r0, t4, elected);
        h1_fragments(h1, acc, sm.b1, t4);
      }
      layer2_head(head, h1, ring, sm.b2, sm.wta, t4, elected, [](int, int, uint32_t) {});
    }
    quad_sum(head);
    bar_sync(group_bar, kWG);  // the group's feature reads of this step are done

    // ---- per lane: logits, the draw, the env step, the next view ----
    if (live && (!kCtl || (ctl.steps_done < p.T && ctl.frozen == 0))) {
      float logit[kHeadRows];
#pragma unroll
      for (int a = 0; a < kHeadRows; ++a) logit[a] = __fadd_rn(t4 == 0 ? head[0][a] : head[1][a], sm.ba[a]);
      float logp = 0.0f;
      const int a = sample_action<kCollect>(logit, p.num_actions, seed, logp);
      bool done;
      float reward;
      // Under kCtl a step that would reuse the consumed template freezes
      // the lane instead and leaves nothing behind.
      if (step_lane_ex<kHook, kCtl>(g, BT, sm.tab, p.tmpl_words, p.tmpl_regs, B, lane, sh, a, p.T, s, ctl,
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
        clear_feature_bits(fcol, BT, feat_words);
        read_view<true>(g, BT, sm.tab, sh, s, [&](int kv, int w) {
          const int m = w & 0xFFF;
          set_feature_bits(fcol, BT, kv, v2, m);
          obs_sum += tcs(m);
          if (kCollect && next_obs != nullptr) next_obs[kv * B] = m;
        });
        checksum += obs_sum;
      }
    }
    bar_sync(group_bar, kWG);  // the next view is in place
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
  policy_kernel<BT, kCollect, kCtl, kHook><<<blocks, BT * 2, smem, stream>>>(p);
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

// Every mode of hook kHook in 128-lane blocks, and in 64-lane blocks if
// kWith64 (a family with a grid whose 128 lanes do not fit one block's
// shared memory, ops/policy_rollout.py::policy_lane_block).
template <int kHook, bool kWith64>
int launch_hook(const mg_policy::Params& p, int lane_block, bool collect, bool ctl, int smem,
                cudaStream_t stream) {
  if (lane_block == 128) return launch_modes<128, kHook>(p, collect, ctl, smem, stream);
  if constexpr (kWith64) {
    if (lane_block == 64) return launch_modes<64, kHook>(p, collect, ctl, smem, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
