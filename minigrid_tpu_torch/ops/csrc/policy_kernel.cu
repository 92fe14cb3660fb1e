// Policy-in-the-loop packed rollout kernel for Hopper (sm_90a), eval mode.
//
// Replaces the TPU kernel minigrid_tpu/ops/policy_rollout.py::_policy_kernel
// in eval mode (no trajectory spill, no family hooks, no chunked-regen
// control rows). It runs T steps per lane in one launch. Each step takes
// the actor on the lane's pre-step view, as `policy_logits` computes it:
// value-major one-hot features of the (V*V) view (hidden cells read as
// value 0) -> (256 x V*V*20) bf16 product -> bf16 + b1 -> relu ->
// (256 x 256) bf16 product -> bf16 + b2 -> relu -> f32 (8 x 256) head + ba;
// then the inverse-CDF draw of `sample_categorical` from one Threefry u31
// of the lane's (t, b) seed (salt 0x243F6A88); then the packed step of
// step_device.cuh, whose post-step view is the next step's input and feeds
// the obs checksum. Outputs are the final words and registers, the
// per-lane reward sum (f32), the per-lane episode count and checksum.
//
// What bounds it on the card: arithmetic. At Empty-8x8 a lane-step needs
// 147 W1 rows of 256 (37,632 adds, counted as the input needs them), a
// 256 x 256 product (131,072 FLOP) and the head (4,096 FLOP): about 173k
// FLOP against about 9 B of state and seed traffic, far above the card's
// 295 FLOP/B balance point.
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
//  * Shared memory at 8x8, BT = 64: features 125 KB, h1 33 KB, h2 36 KB,
//    head weights 10 KB, grids 16 KB: 221 KB, one block per SM.

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "step_device.cuh"

namespace {

constexpr int kHidden = 256;
constexpr int kThreads = 256;
constexpr int kHeadRows = 8;
constexpr int kH1Stride = kHidden + 8;  // bf16 per lane row of h1
constexpr int kKTiles = kHidden / 16;
constexpr uint32_t kSeedSalt = 0x243F6A88u;
constexpr int kWidthType = 11;
constexpr int kWidthColor = 6;
constexpr int kWidthState = 3;

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
  int B, T, width, height, view, max_steps, see_through_walls, num_regs, num_actions;
};

// Features per lane: V*V*20 padded to a whole number of 16-wide k tiles.
__host__ __device__ constexpr int padded_features(int view) { return (view * view * 20 + 15) / 16 * 16; }

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

// First output word of Threefry-2x32 (20 rounds): core/prng.py::threefry2x32.
__device__ __forceinline__ uint32_t threefry_x0(uint32_t k0, uint32_t k1, uint32_t x0,
                                                uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i % 2][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return x0;
}

// `sample_categorical` for one lane: inverse CDF over the first A logits.
__device__ __forceinline__ int sample_action(const float (&logit)[kHeadRows], int num_actions,
                                             int32_t seed) {
  const uint32_t u31 = threefry_x0(static_cast<uint32_t>(seed), kSeedSalt, 0u, 0u) & 0x7FFFFFFFu;
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
  return num_actions - hits;
}

// relu(bf16(bf16(acc) + bias)) as bf16 bits; `bias` is a bf16 value in f32.
__device__ __forceinline__ uint32_t bias_relu(float acc, float bias) {
  const float h = __bfloat162float(__float2bfloat16_rn(acc));
  const float s = __bfloat162float(__float2bfloat16_rn(__fadd_rn(h, bias)));
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(fmaxf(s, 0.0f))));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint4& a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// One warp's share of a (256 x K) . (K x BT) product on the tensor cores:
// rows [32 * warp, 32 * warp + 32) of A (bf16, in A-fragment order, read
// from L2 one k tile ahead) times B (bf16 in shared memory as [BT][stride],
// k contiguous), accumulated in f32 into c.
template <int BT>
__device__ __forceinline__ void warp_product(float (&c)[2][BT / 8][4], const uint4* afrag, int k_tiles,
                                             const __nv_bfloat16* b, int stride, int warp, int ln) {
  const int g8 = ln >> 2;
  const int t4 = ln & 3;
  const uint4* a_row0 = afrag + static_cast<size_t>(warp * 2) * k_tiles * 32 + ln;
  const uint4* a_row1 = a_row0 + static_cast<size_t>(k_tiles) * 32;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[mi][nt][e] = 0.0f;
  uint4 a0 = __ldg(a_row0);
  uint4 a1 = __ldg(a_row1);
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int kn = kt + 1 < k_tiles ? kt + 1 : kt;
    const uint4 n0 = __ldg(a_row0 + kn * 32);
    const uint4 n1 = __ldg(a_row1 + kn * 32);
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt) {
      const __nv_bfloat16* brow = b + (nt * 8 + g8) * stride + kt * 16 + 2 * t4;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(brow);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(brow + 8);
      mma_bf16(c[0][nt], a0, b0, b1);
      mma_bf16(c[1][nt], a1, b0, b1);
    }
    a0 = n0;
    a1 = n1;
  }
}

// The one-hot features of a view cell's packed word, written as bf16 ones
// into the lane's feature row (value-major: row off_ch + v * V * V + kv).
// A channel value at or above its width matches no feature.
__device__ __forceinline__ void set_features(unsigned short* frow, int kv, int v2, int m) {
  constexpr unsigned short kOne = 0x3F80;  // bf16 1.0
  const int ty = m & 15;
  const int co = (m >> 4) & 15;
  const int st = (m >> 8) & 15;
  if (ty < kWidthType) frow[ty * v2 + kv] = kOne;
  if (co < kWidthColor) frow[(kWidthType + co) * v2 + kv] = kOne;
  if (st < kWidthState) frow[(kWidthType + kWidthColor + st) * v2 + kv] = kOne;
}

template <int BT>
__global__ void __launch_bounds__(kThreads, 1) policy_kernel(const PolicyParams p) {
  constexpr int kNTiles = BT / 8;        // n8 tiles of the products
  constexpr int kParts = kThreads / BT;  // head
  constexpr int kSlice = kHidden / kParts;
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
  Lane s{};
  bool reset_any = false;
  float rsum = 0.0f;
  int episodes = 0;
  int checksum = 0;
  if (live) {
    load_lane(g, BT, p.words_in, p.regs_in, B, lane, sh.hw, s);
    read_view<true>(g, BT, tab, sh, s, [&](int kv, int w) { set_features(frow, kv, v2, w & 0xFFF); });
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

    // ---- the f32 head, each lane's dot split over kParts threads; the
    //      features are cleared for the next view meanwhile ----
    {
      for (int i = tid; i < feat_uint4; i += kThreads) feat_words[i] = make_uint4(0, 0, 0, 0);
      const int hl = tid % BT;
      const int part = tid / BT;
      float acc[kHeadRows];
#pragma unroll
      for (int a = 0; a < kHeadRows; ++a) acc[a] = 0.0f;
      for (int o = part * kSlice; o < (part + 1) * kSlice; ++o) {
        const float h = __bfloat162float(h2s[o * kH2Stride + hl]);
#pragma unroll
        for (int a = 0; a < kHeadRows; ++a) acc[a] = fmaf(wta_s[a * kHidden + o], h, acc[a]);
      }
#pragma unroll
      for (int a = 0; a < kHeadRows; ++a) part_s[(part * kHeadRows + a) * BT + hl] = acc[a];
    }
    __syncthreads();

    // ---- per lane: logits, the draw, the env step, the next view ----
    if (live) {
      float logit[kHeadRows];
#pragma unroll
      for (int a = 0; a < kHeadRows; ++a) {
        float sum = part_s[a * BT + tid];
#pragma unroll
        for (int q = 1; q < kParts; ++q) sum = __fadd_rn(sum, part_s[(q * kHeadRows + a) * BT + tid]);
        logit[a] = __fadd_rn(sum, ba_s[a]);
      }
      const int a = sample_action(logit, p.num_actions, p.seeds[t * B + lane]);
      bool done;
      const float reward = step_lane(g, BT, tab, p.tmpl_words, p.tmpl_regs, B, lane, sh, a, s, done);
      if (done) {
        reset_any = true;
        episodes += 1;
      }
      rsum = __fadd_rn(rsum, reward);
      int obs_sum = 0;
      read_view<true>(g, BT, tab, sh, s, [&](int kv, int w) {
        const int m = w & 0xFFF;
        set_features(frow, kv, v2, m);
        obs_sum += tcs(m);
      });
      checksum += obs_sum;
    }
    __syncthreads();
  }

  if (live) {
    store_lane(g, BT, p.words_out, p.regs_out, p.regs_in, p.tmpl_regs, reset_any, B, lane, sh.hw,
               p.num_regs, s);
    p.rsum_out[lane] = rsum;
    p.counts_out[lane] = episodes;
    p.counts_out[B + lane] = checksum;
  }
}

template <int BT>
int launch(const PolicyParams& p, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(policy_kernel<BT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (p.B + BT - 1) / BT;
  policy_kernel<BT><<<blocks, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch the policy rollout on `stream` with `smem_bytes` of dynamic shared
// memory per block (ops/policy_rollout.py::policy_smem_bytes, the layout
// policy_kernel carves); returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a lane block other than 32 or 64).
int mg_policy_launch(const void* words_in, const void* regs_in, const void* tmpl_words,
                     const void* tmpl_regs, const void* seeds, const void* tables, const void* w1frag,
                     const void* b1, const void* w2frag, const void* b2, const void* wta,
                     const void* ba, void* words_out, void* regs_out, void* rsum_out,
                     void* counts_out, int B, int T, int width, int height, int view,
                     int max_steps, int see_through_walls, int num_regs, int num_actions,
                     int lane_block, int smem_bytes, void* stream) {
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
  p.B = B;
  p.T = T;
  p.width = width;
  p.height = height;
  p.view = view;
  p.max_steps = max_steps;
  p.see_through_walls = see_through_walls;
  p.num_regs = num_regs;
  p.num_actions = num_actions;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lane_block == 64) return launch<64>(p, smem_bytes, s);
  if (lane_block == 32) return launch<32>(p, smem_bytes, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
