// Actor-critic gradient pass over a spilled trajectory, for Hopper (sm_90a).
//
// Replaces the TPU kernel minigrid_tpu/ops/grad_kernel.py::_grad_kernel:
// for every (step, lane) sample of the trajectory, the forward of
// `policy_logits` from the obs words (bf16 torso, f32 head), the
// hand-derived cotangents of the loss
//   (-sum logp[a] * adv + vc * sum (v - ret)^2 - ec * sum entropy) / denom
// on the 8 head rows (log-softmax over the A action rows, the critic in
// row 7), and the backward products, accumulated in f32 over all samples:
//   dwta = dhead . h2^T, dba = sum dhead,
//   dh2 = bf16(mask(h2_pre > 0) * wta^T . dhead), db2 = sum dh2,
//   dW2 = dh2 . h1^T,
//   dh1 = bf16(mask(h1_pre > 0) * W2^T . dh2), db1 = sum dh1,
//   dW1 = dh1 . feats^T,
// and the loss sums [pg_sum, v_sum, ent_sum].
//
// What bounds it on the card: operations. Counted as the function needs
// them (layer 1 by its 3 * V * V active one-hot rows), a sample takes
// 480,768 FLOP at V = 7 against about 208 bytes of trajectory, far above
// the card's 295 FLOP/B balance point; the products are bf16, so the
// tensor cores' rate is the bound. The design runs the one-hot products
// densely (K = 992 at V = 7), on wgmma.
//
// Design. The TPU kernel keeps the 256 x 980 f32 dW1 accumulator (1 MB) in
// VMEM across its sequential time grid; no block can hold it, and blocks
// run in no order. So the pass is split in two kernels, run chunk by chunk
// over the time axis (`tc` steps a chunk) by one host call, on one stream:
//  * G1, one block of 64 lanes per lane tile: one warpgroup, the weights
//    streamed through the ring of policy_device.cuh (each step: W1^T's
//    chunks, W2^T's and W2's, in the order they are used). For each
//    step of the chunk: the forward of policy_kernel.cuh (features built in
//    registers from the lanes' feature bits, set from the obs words by one
//    thread a lane; layer 1 and layer 2 on wgmma with h1 kept as layer 2's A
//    fragments, the f32 head summed over each quad), the cotangents per
//    lane, dh2 on CUDA cores (thread c owns hidden units c and c + 128),
//    and dh1 = dh2 . W2 on wgmma with dh2 as A from shared memory and W2 as
//    B, masked by h1 > 0 from the h1 tile it then overwrites. It writes h1,
//    dh2 and dh1 (bf16, (tc, 256, B), lane-contiguous) to scratch through
//    shared-memory tiles, 16 bytes a store, and keeps dwta, the bias grads
//    and the per-lane loss sums in shared memory (all f32, small), added
//    once per chunk into its lane tile's row of partials.
//  * G2, a pipelined wgmma GEMM with the samples as K: one block per (128
//    x 256 output tile, split of the lanes), two consumer warpgroups of 64
//    rows. dW1 is taken transposed, dW1^T[f][h] = sum feats[f] dh1[h]: its
//    A operand, the one-hot features of the tile's 128 feature rows, is
//    built in registers from the obs words as in the forward (nothing is
//    stored), its B the dh1 scratch. dW2 = dh2 . h1^T takes both operands
//    from the scratch. A ring of 4 stages of 64 samples (one step's lanes:
//    K-contiguous in the scratch) is filled with cp.async, three stages
//    ahead of the products. Each tile is added into its split's f32
//    partial.
// No float atomics: every partial element has one owner per launch, and
// the chunks run in order on the stream, so a run repeats bit for bit. The
// wrapper sums the partials over tiles and splits with torch.sum, as the
// JAX wrapper sums its per-block partials outside the kernel.
//
// The relu masks test the bf16 activation h = relu(h_pre) for h > 0, which
// is true exactly when h_pre > 0. Bias and loss sums are plain f32 sums in
// a fixed order.

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "policy_device.cuh"

namespace {

constexpr int kBT = 64;                 // lanes of a G1 block: one warpgroup's rows
constexpr int kG1Threads = kWG;
constexpr int kLaneStride = kBT + 8;    // elements per hidden row of the [256][kBT] tiles
constexpr int kPartWidth = 2576;        // G1 partial row: dwta 2048, db1 256, db2 256, dba 8, sums 8
constexpr int kPartDb1 = kHeadRows * kHidden;
constexpr int kPartDb2 = kPartDb1 + kHidden;
constexpr int kPartDba = kPartDb2 + kHidden;
constexpr int kPartSums = kPartDba + kHeadRows;
constexpr int kTile = 128;              // G2 output rows a block (N is all 256 columns)
constexpr int kG2Threads = 2 * kWG;
constexpr int kKStep = 64;              // G2 samples a stage: 64 lanes of one step
constexpr int kG2Stages = 4;
constexpr int kStageBytes = 48 * 1024;  // B tile 32 KB, then the A tile or the obs words
constexpr int kWordsStride = kKStep + 8;  // int32 per obs-word row of a stage
constexpr int kHalfTile = 128 * 128;    // bytes of 128 rows of a 64-deep tile (128-byte swizzle)

struct GradParams {
  const int32_t* obs;      // (T, V*V, B) obs words, t stride obs_tstride
  const int32_t* actions;  // (T, B), t stride act_tstride
  const float* adv;        // (T, B)
  const float* ret;        // (T, B)
  const void* w1s;         // W1^T in chunks (ops/policy_rollout.py::_b_chunks)
  const __nv_bfloat16* b1;
  const void* w2s;         // W2^T chunks: layer 2's B
  const __nv_bfloat16* b2;
  const void* w2ts;        // W2 chunks: the B of dh1 = dh2 . W2
  const float* wta;        // (8, 256)
  const float* ba;         // (8,)
  __nv_bfloat16* h1;       // scratch (tc, 256, B)
  __nv_bfloat16* dh1;      // scratch (tc, 256, B)
  __nv_bfloat16* dh2;      // scratch (tc, 256, B)
  float* part1;            // (B / 64, kPartWidth)
  float* dw1p;             // (splits, nf, 256): dW1^T
  float* dw2p;             // (splits, 256, 256)
  long long obs_tstride, act_tstride;
  int B, view, num_actions, nf, splits, split_lanes, stages;
  float inv_denom, vc2, ec;
};

__device__ __forceinline__ uint32_t float_to_bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void addto(float* p, float x, bool accumulate) { *p = accumulate ? *p + x : x; }

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// G1's shared memory, as ops/grad_kernel.py::grad_smem_bytes counts it:
// the ring's bookkeeping and `stages` slots, dh2 as wgmma's A ([64][256]
// bf16: four 64-deep K chunks in the 128-byte swizzle), the head weights
// ([256][8] f32) and biases, the step's feature bits [K / 32][64] uint32,
// the [256][72] bf16 tiles of h1 (later dh1) and h2, dhead [8][64], the
// lane sums [3][64] and the tile's running dwta, db1, db2 and dba in f32.
struct G1Smem {
  unsigned char* dh2;  // A operand: 4 chunks of [64 lanes][64 hidden units]
  float *wta, *b1, *b2, *ba;
  uint32_t* feat;
  uint16_t* tile;  // h1, then dh1: [256][kLaneStride]
  uint16_t* h2;    // [256][kLaneStride]
  float *dhead, *sums;
  float* grads;    // the partial row's first kPartSums entries

  __device__ G1Smem(unsigned char* raw, const GradParams& p) {
    dh2 = raw + kBarBytes + p.stages * kChunkBytes;
    wta = reinterpret_cast<float*>(dh2 + kBT * kHidden * 2);
    b1 = wta + kHidden * kHeadRows;
    b2 = b1 + kHidden;
    ba = b2 + kHidden;
    feat = reinterpret_cast<uint32_t*>(ba + kHeadRows);
    tile = reinterpret_cast<uint16_t*>(feat + padded_features(p.view) / 32 * kBT);
    h2 = tile + kHidden * kLaneStride;
    dhead = reinterpret_cast<float*>(h2 + kHidden * kLaneStride);
    sums = dhead + kHeadRows * kBT;
    grads = sums + 3 * kBT;
  }
};

// Byte offset of element (lane l, hidden unit o) in the dh2 A tile.
__device__ __forceinline__ int dh2_offset(int l, int o) { return (o >> 6) * 8192 + sw128_offset(l, o & 63); }

// Write a [256][kLaneStride] tile's hidden row o (64 lanes) to scratch at dst.
__device__ __forceinline__ void row_to_scratch(const uint16_t* tile, int o, __nv_bfloat16* dst) {
  const uint4* src = reinterpret_cast<const uint4*>(tile + o * kLaneStride);
  uint4* out = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int q = 0; q < kBT / 8; ++q) out[q] = src[q];
}

// G1: forward, cotangents and the lane-local backward for steps
// [t0, t0 + tcc) of one tile of 64 lanes.
__global__ void __launch_bounds__(kG1Threads, 1) grad_g1_kernel(const GradParams p, int t0, int tcc,
                                                                 int accumulate) {
  const int v2 = p.view * p.view;
  const int k_chunks = padded_features(p.view) / 64;
  const bool tail = padded_features(p.view) % 64 != 0;
  // Each step: W1^T's chunks, W2^T's (layer 2), W2's (dh1).
  const int per_step = w1_chunks(p.view) + 2 * kW2Chunks;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const G1Smem sm(smem_raw, p);
  const int tid = threadIdx.x;
  if (tid == 0) {
    const ChunkSequence sq{{static_cast<const char*>(p.w1s), static_cast<const char*>(p.w2s),
                            static_cast<const char*>(p.w2ts)},
                           {w1_chunks(p.view), kW2Chunks, kW2Chunks},
                           tcc};
    init_ring(smem_raw, p.stages, sq);
  }
  for (int i = tid; i < kHeadRows * kHidden; i += kG1Threads)
    sm.wta[i] = p.wta[(i % kHeadRows) * kHidden + i / kHeadRows];
  for (int i = tid; i < kHidden; i += kG1Threads) {
    sm.b1[i] = __bfloat162float(p.b1[i]);
    sm.b2[i] = __bfloat162float(p.b2[i]);
  }
  if (tid < kHeadRows) sm.ba[tid] = p.ba[tid];
  for (int i = tid; i < kPartSums; i += kG1Threads) sm.grads[i] = 0.0f;
  for (int i = tid; i < 3 * kBT; i += kG1Threads) sm.sums[i] = 0.0f;
  __syncthreads();

  const int ln = tid & 31;
  const int g8 = ln >> 2;
  const int t4 = ln & 3;
  const int r0 = (tid >> 5) * 16 + g8;  // fragment rows r0 and r0 + 8
  const int own = r0 + 8 * t4;          // the lane of threads t4 < 2 in the per-lane phase
  const bool elected = tid == 0;
  const size_t B = static_cast<size_t>(p.B);
  const int lane0 = blockIdx.x * kBT;
  Ring ring{smem_raw, p.stages, 1, per_step, tcc * per_step};
  const uint32_t dh2_tile = smem_addr(sm.dh2);

  // Thread tid owns hidden units tid and tid + 128 in the column phases;
  // their running gradients are in sm.grads.

  for (int j = 0; j < tcc; ++j) {
    const int t = t0 + j;
    // ---- the step's feature bits from its obs words, one thread a lane ----
    if (tid < kBT) {
      const int32_t* w = p.obs + t * p.obs_tstride + lane0 + tid;
      uint32_t* col = sm.feat + tid;
      clear_feature_bits(col, kBT, padded_features(p.view) / 32);
      for (int kv = 0; kv < v2; ++kv) set_feature_bits(col, kBT, kv, v2, w[kv * B]);
    }
    bar_sync(1, kWG);

    // ---- the forward: layer 1, layer 2 and the head; h1 and h2 into their tiles ----
    float head[2][kHeadRows];
    {
      uint32_t h1[kKTiles][4];
      {
        float acc[2][64];
        layer1(acc, ring, sm.feat, kBT, k_chunks, tail, r0, t4, elected);
        h1_fragments(h1, acc, sm.b1, t4);
      }
#pragma unroll
      for (int kt = 0; kt < kKTiles; ++kt) {
        const int c0 = (kt / 8) * 128 + 16 * (kt % 8) + 2 * t4;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + (e >> 1) * 8;
          const int row = r0 + (e & 1) * 8;
          sm.tile[col * kLaneStride + row] = static_cast<uint16_t>(h1[kt][e] & 0xFFFFu);
          sm.tile[(col + 1) * kLaneStride + row] = static_cast<uint16_t>(h1[kt][e] >> 16);
        }
      }
      layer2_head(head, h1, ring, sm.b2, sm.wta, t4, elected, [&](int r, int col, uint32_t bits) {
        sm.h2[col * kLaneStride + r0 + 8 * r] = static_cast<uint16_t>(bits);
      });
    }
    quad_sum(head);

    // ---- per lane: the loss terms and the head cotangent ----
    if (t4 < 2) {
      float logit[kHeadRows];
#pragma unroll
      for (int a = 0; a < kHeadRows; ++a) logit[a] = __fadd_rn(t4 == 0 ? head[0][a] : head[1][a], sm.ba[a]);
      const size_t i_tb = static_cast<size_t>(t) * B + lane0 + own;
      const int act = p.actions[t * p.act_tstride + lane0 + own];
      const float adv = p.adv[i_tb];
      const float ret = p.ret[i_tb];
      const int na = p.num_actions;
      float m = logit[0];
#pragma unroll
      for (int i = 1; i < kHeadRows; ++i)
        if (i < na) m = fmaxf(m, logit[i]);
      float ex[kHeadRows];
      float total = 0.0f;
#pragma unroll
      for (int i = 0; i < kHeadRows; ++i) {
        ex[i] = i < na ? expf(logit[i] - m) : 0.0f;
        total += ex[i];
      }
      const float logz = logf(total) + m;
      float dlp[kHeadRows], prob[kHeadRows];
      float s_dlp = 0.0f;
      float pg_sum = sm.sums[own], v_sum = sm.sums[kBT + own], ent_sum = sm.sums[2 * kBT + own];
#pragma unroll
      for (int i = 0; i < kHeadRows; ++i) {
        dlp[i] = 0.0f;
        prob[i] = 0.0f;
        if (i < na) {
          const float lp = logit[i] - logz;
          const float pr = ex[i] / total;
          const float oh = act == i ? 1.0f : 0.0f;
          dlp[i] = (-adv) * oh * p.inv_denom + (-p.ec) * (-(pr * (lp + 1.0f))) * p.inv_denom;
          prob[i] = pr;
          ent_sum -= pr * lp;
          pg_sum -= lp * oh * adv;
          s_dlp += dlp[i];
        }
      }
      const float dv = logit[kHeadRows - 1] - ret;
#pragma unroll
      for (int i = 0; i < kHeadRows - 1; ++i) sm.dhead[i * kBT + own] = i < na ? dlp[i] - prob[i] * s_dlp : 0.0f;
      sm.dhead[(kHeadRows - 1) * kBT + own] = p.vc2 * dv * p.inv_denom;
      v_sum += dv * dv;
      sm.sums[own] = pg_sum;
      sm.sums[kBT + own] = v_sum;
      sm.sums[2 * kBT + own] = ent_sum;
    }
    bar_sync(1, kWG);

    // ---- hidden units o: h1 to scratch; dh2 = bf16(mask * wta^T . dhead) for
    //      every lane, dwta and db2, dh2 to the A tile and scratch ----
#pragma unroll 1
    for (int c = 0; c < 2; ++c) {
      const int o = tid + c * kWG;
      const size_t row = (static_cast<size_t>(j) * kHidden + o) * B + lane0;
      row_to_scratch(sm.tile, o, p.h1 + row);
      const float4 w0 = *reinterpret_cast<const float4*>(sm.wta + o * kHeadRows);
      const float4 w1 = *reinterpret_cast<const float4*>(sm.wta + o * kHeadRows + 4);
      const float wcol[kHeadRows] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      float dwta[kHeadRows];
#pragma unroll
      for (int a = 0; a < kHeadRows; ++a) dwta[a] = sm.grads[a * kHidden + o];
      float db2 = sm.grads[kPartDb2 + o];
      uint4* dst = reinterpret_cast<uint4*>(p.dh2 + row);
#pragma unroll 1
      for (int q = 0; q < kBT / 8; ++q) {
        uint32_t wd[4];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int l = 8 * q + e;
          const float h2 = bf16_bits_to_float(sm.h2[o * kLaneStride + l]);
          float dh2f = 0.0f;
#pragma unroll
          for (int a = 0; a < kHeadRows; ++a) {
            const float dh = sm.dhead[a * kBT + l];
            dh2f += wcol[a] * dh;
            dwta[a] += dh * h2;
          }
          const uint32_t bits = h2 > 0.0f ? float_to_bf16_bits(dh2f) : 0u;
          db2 += bf16_bits_to_float(bits);
          *reinterpret_cast<uint16_t*>(sm.dh2 + dh2_offset(l, o)) = static_cast<uint16_t>(bits);
          wd[e >> 1] = (e & 1) ? wd[e >> 1] | bits << 16 : bits;
        }
        dst[q] = make_uint4(wd[0], wd[1], wd[2], wd[3]);
      }
#pragma unroll
      for (int a = 0; a < kHeadRows; ++a) sm.grads[a * kHidden + o] = dwta[a];
      sm.grads[kPartDb2 + o] = db2;
    }
    if (tid < kHeadRows) {
      float dba = sm.grads[kPartDba + tid];
      for (int l = 0; l < kBT; ++l) dba += sm.dhead[tid * kBT + l];
      sm.grads[kPartDba + tid] = dba;
    }
    fence_async_proxy();  // the dh2 tile is read by wgmma next
    bar_sync(1, kWG);

    // ---- dh1 = bf16(mask * dh2 . W2) on the tensor cores, in place of h1 in the tile ----
#pragma unroll 1
    for (int hn = 0; hn < 2; ++hn) {
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
      fence_acc(acc);
      Held held{-1, 0, 0};
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        const uint32_t chunk = ring.acquire();
        const Held now = ring.advance();
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wgmma_ss(acc, sw128_desc(dh2_tile + kc * 8192 + 32 * j), sw128_desc(chunk + 32 * j), kc + j > 0);
        wgmma_commit();
        if (kc > 0) wgmma_wait<1>();
        ring.release(held, elected);
        held = now;
      }
      wgmma_wait<0>();
      ring.release(held, elected);
      fence_acc(acc);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint16_t& x = sm.tile[(hn * 128 + 8 * i + 2 * t4 + (e & 1)) * kLaneStride + r0 + 8 * (e >> 1)];
          x = static_cast<uint16_t>(bf16_bits_to_float(x) > 0.0f ? float_to_bf16_bits(acc[4 * i + e]) : 0u);
        }
      }
    }
    bar_sync(1, kWG);

    // ---- hidden units o: db1 and dh1 to scratch ----
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int o = tid + c * kWG;
      float db1 = sm.grads[kPartDb1 + o];
      for (int l = 0; l < kBT; ++l) db1 += bf16_bits_to_float(sm.tile[o * kLaneStride + l]);
      sm.grads[kPartDb1 + o] = db1;
      row_to_scratch(sm.tile, o, p.dh1 + (static_cast<size_t>(j) * kHidden + o) * B + lane0);
    }
    bar_sync(1, kWG);  // the tiles and the feature bits are free for the next step
  }

  // ---- the chunk's sums into this lane tile's partial row ----
  bar_sync(1, kWG);
  float* part = p.part1 + static_cast<size_t>(blockIdx.x) * kPartWidth;
  const bool acc = accumulate != 0;
  for (int i = tid; i < kPartSums; i += kG1Threads) addto(part + i, sm.grads[i], acc);
  if (tid < 3) {
    float s = 0.0f;
    for (int l = 0; l < kBT; ++l) s += sm.sums[tid * kBT + l];
    addto(part + kPartSums + tid, s, acc);
  }
}

// G2: one 128 x 256 tile of dW1^T = feats . dh1^T (tiles [0, nf / 128)) or
// of dW2 = dh2 . h1^T (the next 2), over the lanes of split blockIdx.y and
// the steps [t0, t0 + tcc), added into the split's f32 partial. Warpgroup
// wg takes rows [64 wg, 64 wg + 64) of the tile.
__global__ void __launch_bounds__(kG2Threads, 1) grad_g2_kernel(const GradParams p, int t0, int tcc,
                                                                 int accumulate) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];  // kG2Stages x kStageBytes
  const int v2 = p.view * p.view;
  const int w1_tiles = p.nf / kTile;
  const bool is_w1 = static_cast<int>(blockIdx.x) < w1_tiles;
  const int mt = is_w1 ? blockIdx.x : blockIdx.x - w1_tiles;
  const size_t B = static_cast<size_t>(p.B);
  const int split = blockIdx.y;
  const int l_begin = split * p.split_lanes;
  const int l_end = min(l_begin + p.split_lanes, p.B);
  const int nls = (l_end - l_begin) / kKStep;
  const int n_st = tcc * nls;

  const int tid = threadIdx.x;
  const int wg = tid / kWG;
  const int ln = tid & 31;
  const int g8 = ln >> 2;
  const int t4 = ln & 3;
  const int row0 = mt * kTile + wg * 64 + ((tid % kWG) >> 5) * 16 + g8;  // output rows row0, row0 + 8
  const int code0 = is_w1 ? feature_code(row0, v2) : 0;
  const int code1 = is_w1 ? feature_code(row0 + 8, v2) : 0;
  const uint32_t smem0 = smem_addr(smem_raw);

  // Stage st: step j = st / nls, lanes [l0, l0 + 64). The B tile (dh1 or h1,
  // all 256 hidden rows) in the 128-byte swizzle at 0; then the obs words
  // [V*V][kWordsStride] (dW1 tiles) or the A tile (dh2, the tile's 128 rows),
  // each 16-byte group one cp.async, 8 threads a row.
  auto load_stage = [&](int st, int slot) {
    const int j = st / nls;
    const int l0 = l_begin + (st - j * nls) * kKStep;
    const uint32_t base = smem0 + slot * kStageBytes;
    const __nv_bfloat16* brows = (is_w1 ? p.dh1 : p.h1) + static_cast<size_t>(j) * kHidden * B + l0;
    for (int c = tid; c < kHidden * 8; c += kG2Threads) {
      const int row = c >> 3;
      const int g = c & 7;
      cp_async16(base + sw128_offset(row, 8 * g), brows + row * B + g * 8);
    }
    if (is_w1) {
      const int32_t* w = p.obs + (t0 + j) * p.obs_tstride + l0;
      for (int c = tid; c < v2 * 16; c += kG2Threads) {
        const int kv = c >> 4;
        const int q = c & 15;
        cp_async16(base + 32768 + (kv * kWordsStride + q * 4) * 4, w + kv * B + q * 4);
      }
    } else {
      const __nv_bfloat16* arows = p.dh2 + (static_cast<size_t>(j) * kHidden + mt * kTile) * B + l0;
      for (int c = tid; c < kTile * 8; c += kG2Threads) {
        const int row = c >> 3;
        const int g = c & 7;
        cp_async16(base + 32768 + sw128_offset(row, 8 * g), arows + row * B + g * 8);
      }
    }
  };

  float acc[2][64];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.0f;
#pragma unroll
  for (int i = 0; i < kG2Stages - 1; ++i) {
    if (i < n_st) load_stage(i, i);
    cp_async_commit();
  }
  for (int st = 0; st < n_st; ++st) {
    cp_async_wait<kG2Stages - 2>();
    fence_async_proxy();
    __syncthreads();  // stage st is in place everywhere; slot (st - 1) % kG2Stages is free
    const int nx = st + kG2Stages - 1;
    if (nx < n_st) load_stage(nx, nx % kG2Stages);
    cp_async_commit();

    const int slot = st % kG2Stages;
    const uint32_t bt = smem0 + slot * kStageBytes;
    if (is_w1) {
      const int32_t* ws = reinterpret_cast<const int32_t*>(smem_raw + slot * kStageBytes + 32768);
      const int32_t* x0 = ws + (code0 & 0x3FF) * kWordsStride + 2 * t4;
      const int32_t* x1 = ws + (code1 & 0x3FF) * kWordsStride + 2 * t4;
      uint32_t a[kKStep / 16][4];
#pragma unroll
      for (int kk = 0; kk < kKStep / 16; ++kk) {
        const int2 p0 = *reinterpret_cast<const int2*>(x0 + kk * 16);
        const int2 p1 = *reinterpret_cast<const int2*>(x1 + kk * 16);
        const int2 q0 = *reinterpret_cast<const int2*>(x0 + kk * 16 + 8);
        const int2 q1 = *reinterpret_cast<const int2*>(x1 + kk * 16 + 8);
        a[kk][0] = one_hot(p0.x, code0) | one_hot(p0.y, code0) << 16;
        a[kk][1] = one_hot(p1.x, code1) | one_hot(p1.y, code1) << 16;
        a[kk][2] = one_hot(q0.x, code0) | one_hot(q0.y, code0) << 16;
        a[kk][3] = one_hot(q1.x, code1) | one_hot(q1.y, code1) << 16;
      }
      fence_frags(a);
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKStep / 16; ++kk) {
        wgmma_rs(acc[0], a[kk], sw128_desc(bt + kk * 32), 1);
        wgmma_rs(acc[1], a[kk], sw128_desc(bt + kHalfTile + kk * 32), 1);
      }
      wgmma_commit();
    } else {
      const uint32_t at = bt + 32768 + wg * 64 * 128;
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKStep / 16; ++kk) {
        const uint64_t da = sw128_desc(at + kk * 32);
        wgmma_ss(acc[0], da, sw128_desc(bt + kk * 32), 1);
        wgmma_ss(acc[1], da, sw128_desc(bt + kHalfTile + kk * 32), 1);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
  }
  cp_async_wait<0>();

  const size_t ld = kHidden;
  float* out = (is_w1 ? p.dw1p + static_cast<size_t>(split) * p.nf * ld : p.dw2p + static_cast<size_t>(split) * kHidden * ld);
  const bool accum = accumulate != 0;
#pragma unroll
  for (int hn = 0; hn < 2; ++hn)
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float2* dst = reinterpret_cast<float2*>(out + static_cast<size_t>(row0 + 8 * r) * ld + hn * 128 + 8 * i + 2 * t4);
        const float2 x = make_float2(acc[hn][4 * i + 2 * r], acc[hn][4 * i + 2 * r + 1]);
        if (accum) {
          const float2 y = *dst;
          *dst = make_float2(y.x + x.x, y.y + x.y);
        } else {
          *dst = x;
        }
      }
}

}  // namespace

extern "C" {

// Run the gradient pass on `stream`: for each chunk of `tc` steps, G1 on
// B / 64 lane tiles with `smem_bytes` of dynamic shared memory and `stages`
// ring slots (ops/grad_kernel.py::grad_plan), then
// G2 on (nf / 128 + 2, splits) tiles. The first chunk writes the partials,
// later ones add to them. Returns the first cudaError_t of a launch, or 0.
int mg_grad_launch(const void* obs, const void* actions, const void* adv, const void* ret,
                   const void* w1s, const void* b1, const void* w2s, const void* b2,
                   const void* w2ts, const void* wta, const void* ba, void* h1, void* dh1,
                   void* dh2, void* part1, void* dw1p, void* dw2p, long long obs_tstride,
                   long long act_tstride, int B, int T, int view, int num_actions, int tc, int nf,
                   int splits, int split_lanes, int stages, float inv_denom, float vc2, float ec,
                   int smem_bytes, void* stream) {
  GradParams p;
  p.obs = static_cast<const int32_t*>(obs);
  p.actions = static_cast<const int32_t*>(actions);
  p.adv = static_cast<const float*>(adv);
  p.ret = static_cast<const float*>(ret);
  p.w1s = w1s;
  p.b1 = static_cast<const __nv_bfloat16*>(b1);
  p.w2s = w2s;
  p.b2 = static_cast<const __nv_bfloat16*>(b2);
  p.w2ts = w2ts;
  p.wta = static_cast<const float*>(wta);
  p.ba = static_cast<const float*>(ba);
  p.h1 = static_cast<__nv_bfloat16*>(h1);
  p.dh1 = static_cast<__nv_bfloat16*>(dh1);
  p.dh2 = static_cast<__nv_bfloat16*>(dh2);
  p.part1 = static_cast<float*>(part1);
  p.dw1p = static_cast<float*>(dw1p);
  p.dw2p = static_cast<float*>(dw2p);
  p.obs_tstride = obs_tstride;
  p.act_tstride = act_tstride;
  p.B = B;
  p.view = view;
  p.num_actions = num_actions;
  p.nf = nf;
  p.splits = splits;
  p.split_lanes = split_lanes;
  p.stages = stages;
  p.inv_denom = inv_denom;
  p.vc2 = vc2;
  p.ec = ec;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(grad_g1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(grad_g2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kG2Stages * kStageBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 g2_grid(nf / kTile + 2, splits);
  for (int t0 = 0; t0 < T; t0 += tc) {
    const int tcc = T - t0 < tc ? T - t0 : tc;
    grad_g1_kernel<<<B / kBT, kG1Threads, smem_bytes, s>>>(p, t0, tcc, t0 > 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    grad_g2_kernel<<<g2_grid, kG2Threads, kG2Stages * kStageBytes, s>>>(p, t0, tcc, t0 > 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
