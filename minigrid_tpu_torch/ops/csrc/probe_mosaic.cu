// The Mosaic bisection probe for Hopper (sm_90a): the dW2 product of the
// gradient kernel's G2 in isolation, templated on the variant.
//
// Replaces the TPU kernels tools/probe_mosaic.py::make_kernel and
// ::make_kernel_scratch (the pallas_call of run_variant). Over the probe's
// fixed shapes it computes, for 2 steps of 512 lanes:
//   f   = the value-major one-hot features of the (49, 512) obs words
//         (11 type, 6 colour and 3 state rows per cell; a value at or above
//         its channel's width sets no row), 980 rows;
//   h1  = relu(bf16(bf16(W1 . f) + b1)), h2d = W2 . h1 (f32),
//   h2p = bf16(bf16(h2d) + b2);
//   dh  = the variant's masked cotangent of g (256, 512; the same block for
//         both steps), mostly bf16(g) where h2p > 0, else 0;
//   acc = sum over the 1024 lanes of dh . h1^T, an f32 (256, 256) matrix.
// The variants (ids in the order of tools/probe_mosaic.py::VARIANTS):
//   0 control_unmasked    dh = bf16(g)
//   1 base_where          dh = h2p > 0 ? bf16(g) : 0
//   2 bitand_mask         the bits of bf16(g) and-ed with 0xFFFF or 0
//   3 int_select_bitcast  a select on the bits of bf16(g)
//   4 scratch_roundtrip   base_where's dh through a bf16 shared-memory scratch
//   5 f32_dot             dh = h2p > 0 ? g : 0 in f32, the product in f32
//   6 opt_barrier         base_where: an optimization barrier has no
//                         meaning in CUDA
//   7 mask_from_f32       dh = bf16(h2d + b2 > 0 ? g : 0), the mask on f32
//   8 upcast_cmp          dh = f32(h2p) > 0 ? bf16(g) : 0 (base_where's value)
// Variants 1-4, 6 and 8 compute one formula, so they must agree bit for bit.
//
// What bounds it on the card: bytes (1.6 MB in and out against about 3e8
// FLOP of dense products), so the least time is a fraction of a
// microsecond; in practice the launches and the two products' pipelines
// set it.
//
// Design: two launches on one stream, because the product needs the h1 and
// dh of all 1024 lanes, which 16 blocks compute (a grid-wide dependency;
// a cluster that shares them would have to span 16 SMs).
//  * probe_forward_kernel<variant>: 16 blocks of one warpgroup, 64 lanes
//    each, so the forward runs once per lane. It is the actor forward of
//    policy_device.cuh: feature bits from the obs words (set_feature_bits),
//    layer 1 on wgmma with W1^T streamed through the weight ring
//    (ops/policy_rollout.py::_b_chunks, laid out by the wrapper), h1 kept as
//    layer 2's A fragments (h1_fragments), layer 2 on wgmma (product_half)
//    with the raw f32 h2d kept for the epilogue, which computes h2p and the
//    variant's dh exactly as the formulas above. h1 (bf16) and dh (bf16, f32
//    for f32_dot) go to scratch as (256, 1024): lanes contiguous, the K-major
//    layout of the product. scratch_roundtrip stages its dh bits through a
//    bf16 shared-memory tile before the store.
//  * probe_product_kernel: acc = dh . h1^T with the lanes as K, on wgmma, as
//    G2's dW2 (grad_kernel.cu): 8 blocks of one warpgroup, each a 64 x 128
//    tile of acc, a 4-stage cp.async ring of 64-lane stages in the 128-byte
//    swizzle, the K loop in lane order.
//  * probe_product_f32_kernel (f32_dot): the same product in f32 on the CUDA
//    cores, each output a chain of round-to-nearest FMAs in lane order. TF32
//    on the tensor cores would round dh and h1 to 10-bit mantissas, and a
//    three-term bf16 split costs three products for 1.3e8 FLOP that the
//    CUDA cores take in a few microseconds.
// No float atomics and no split of K: every output element is one chain in
// a fixed order, so two runs agree bit for bit.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "policy_device.cuh"

namespace {

constexpr int kPV = 7;                     // the probe's view
constexpr int kPV2 = kPV * kPV;            // view cells
constexpr int kLanes = 512;                // lanes of one step (the TPU block)
constexpr int kSteps = 2;                  // steps (the TPU grid)
constexpr int kAll = kSteps * kLanes;      // the product's K
constexpr int kFwdLanes = 64;              // lanes of a forward block: one warpgroup's rows
constexpr int kFwdStages = 4;              // weight-ring slots
constexpr int kFeatWords = padded_features(kPV) / 32;
// Forward shared memory: the ring, the lanes' feature bits [kFeatWords][64],
// b1 and b2 in f32, and scratch_roundtrip's [64][256] bf16 tile.
constexpr int kFeatOffset = kBarBytes + kFwdStages * kChunkBytes;
constexpr int kBiasOffset = kFeatOffset + kFeatWords * kFwdLanes * 4;
constexpr int kScratchOffset = kBiasOffset + 2 * kHidden * 4;
constexpr int kFwdSmem = kScratchOffset + kFwdLanes * kHidden * 2;
// Product: 64 x 128 tiles, 64-lane stages (A 8 KB, B 16 KB).
constexpr int kPM = 64;
constexpr int kPN = 128;
constexpr int kPK = 64;
constexpr int kPStages = 4;
constexpr int kPABytes = kPM * 128;
constexpr int kPStageBytes = kPABytes + kPN * 128;
constexpr int kProductSmem = kPStages * kPStageBytes;
// f32 product: 32 x 32 tiles, 16 x 16 threads of 2 x 2 outputs, 32-lane K tiles.
constexpr int kFT = 32;

enum : int {
  kControlUnmasked = 0,
  kBaseWhere = 1,
  kBitandMask = 2,
  kIntSelectBitcast = 3,
  kScratchRoundtrip = 4,
  kF32Dot = 5,
  kOptBarrier = 6,
  kMaskFromF32 = 7,
  kUpcastCmp = 8,
};

__device__ __forceinline__ float bf16_round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__device__ __forceinline__ unsigned short bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float bf16_value(unsigned short bits) {
  return __bfloat162float(__ushort_as_bfloat16(bits));
}

// The variant's cotangent of one element from the raw layer-2 sum h2d, the
// bf16 bias b2 (as f32) and g; a bf16 value (held in f32) except f32_dot's.
template <int kVariant>
__device__ __forceinline__ float cotangent(float h2d, float bias, float gv) {
  const float h2p = bf16_round(__fadd_rn(bf16_round(h2d), bias));
  const bool live = h2p > 0.0f;
  if (kVariant == kControlUnmasked) return bf16_round(gv);
  if (kVariant == kBitandMask) return bf16_value(static_cast<unsigned short>(bf16_bits(gv) & (live ? 0xFFFFu : 0u)));
  if (kVariant == kIntSelectBitcast) return bf16_value(live ? bf16_bits(gv) : static_cast<unsigned short>(0));
  if (kVariant == kF32Dot) return live ? gv : 0.0f;
  if (kVariant == kMaskFromF32) return bf16_round(__fadd_rn(h2d, bias) > 0.0f ? gv : 0.0f);
  return live ? bf16_round(gv) : 0.0f;  // base_where, scratch_roundtrip, opt_barrier, upcast_cmp
}

// The forward of 64 lanes (block b: lanes 64 b .. 64 b + 63 of the 1024,
// step 64 b / 512): h1 and the variant's dh into the (256, 1024) scratch.
template <int kVariant>
__global__ void __launch_bounds__(kWG, 1) probe_forward_kernel(
    const int32_t* __restrict__ obs, const float* __restrict__ g, const void* __restrict__ w1s,
    const __nv_bfloat16* __restrict__ b1, const void* __restrict__ w2s, const __nv_bfloat16* __restrict__ b2,
    __nv_bfloat16* __restrict__ h1_out, void* __restrict__ dh_out) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  uint32_t* feat = reinterpret_cast<uint32_t*>(smem_raw + kFeatOffset);
  float* b1_s = reinterpret_cast<float*>(smem_raw + kBiasOffset);
  float* b2_s = b1_s + kHidden;
  uint16_t* scratch = reinterpret_cast<uint16_t*>(smem_raw + kScratchOffset);  // [lane][unit]
  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * kFwdLanes;
  const int step = lane0 / kLanes;
  const int l0 = lane0 % kLanes;
  const int k_chunks = padded_features(kPV) / 64;
  const bool tail = padded_features(kPV) % 64 != 0;
  const int per_step = w1_chunks(kPV) + kW2Chunks;
  if (tid == 0) {
    const ChunkSequence sq{{static_cast<const char*>(w1s), static_cast<const char*>(w2s), nullptr},
                           {w1_chunks(kPV), kW2Chunks, 0},
                           1};
    init_ring(smem_raw, kFwdStages, sq);
  }
  for (int i = tid; i < kHidden; i += kWG) {
    b1_s[i] = __bfloat162float(b1[i]);
    b2_s[i] = __bfloat162float(b2[i]);
  }
  for (int i = tid; i < kFeatWords * kFwdLanes; i += kWG) feat[i] = 0u;
  __syncthreads();
  // The feature bits: thread tid takes lane tid % 64 and every other cell.
  {
    const int l = tid % kFwdLanes;
    const int32_t* w = obs + static_cast<size_t>(step) * kPV2 * kLanes + l0 + l;
    for (int kv = tid / kFwdLanes; kv < kPV2; kv += kWG / kFwdLanes)
      set_feature_bits(feat + l, kFwdLanes, kv, kPV2, w[kv * kLanes]);
  }
  __syncthreads();

  const int ln = tid & 31;
  const int g8 = ln >> 2;
  const int t4 = ln & 3;
  const int r0 = (tid >> 5) * 16 + g8;  // fragment rows (lanes) r0 and r0 + 8
  const bool elected = tid == 0;
  Ring ring{smem_raw, kFwdStages, 1, per_step, per_step};

  uint32_t h[kKTiles][4];
  {
    float acc[2][64];
    layer1(acc, ring, feat, kFwdLanes, k_chunks, tail, r0, t4, elected);
    h1_fragments(h, acc, b1_s, t4);
  }
#pragma unroll
  for (int kt = 0; kt < kKTiles; ++kt) {
    const int c0 = (kt / 8) * 128 + 16 * (kt % 8) + 2 * t4;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = c0 + (e >> 1) * 8;
      const int row = r0 + (e & 1) * 8;
      uint16_t* dst = reinterpret_cast<uint16_t*>(h1_out) + static_cast<size_t>(col) * kAll + lane0 + row;
      dst[0] = static_cast<uint16_t>(h[kt][e] & 0xFFFFu);
      dst[kAll] = static_cast<uint16_t>(h[kt][e] >> 16);
    }
  }

  fence_frags(h);
#pragma unroll 1
  for (int hn = 0; hn < 2; ++hn) {
    float acc[64];
    product_half(acc, h, ring, elected);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = hn * 128 + 8 * i + 2 * t4 + (e & 1);
        const int row = r0 + 8 * (e >> 1);
        const float dh = cotangent<kVariant>(acc[4 * i + e], b2_s[col], g[col * kLanes + l0 + row]);
        const size_t at = static_cast<size_t>(col) * kAll + lane0 + row;
        if (kVariant == kF32Dot) {
          static_cast<float*>(dh_out)[at] = dh;
        } else if (kVariant == kScratchRoundtrip) {
          scratch[row * kHidden + col] = bf16_bits(dh);
        } else {
          static_cast<uint16_t*>(dh_out)[at] = bf16_bits(dh);
        }
      }
    }
  }
  if (kVariant == kScratchRoundtrip) {
    __syncthreads();
    for (int i = tid; i < kFwdLanes * kHidden; i += kWG) {
      const int row = i % kFwdLanes;
      const int col = i / kFwdLanes;
      static_cast<uint16_t*>(dh_out)[static_cast<size_t>(col) * kAll + lane0 + row] = scratch[row * kHidden + col];
    }
  }
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// acc[m0 .. m0 + 63][n0 .. n0 + 127] = sum over the lanes of dh . h1^T (both
// bf16, (256, 1024) lane-contiguous), on wgmma; block (blockIdx.x, y) owns
// rows 64 x and columns 128 y.
__global__ void __launch_bounds__(kWG, 1) probe_product_kernel(const __nv_bfloat16* __restrict__ dh,
                                                                const __nv_bfloat16* __restrict__ h1,
                                                                float* __restrict__ out) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t smem0 = smem_addr(smem_raw);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kPM;
  const int n0 = blockIdx.y * kPN;
  constexpr int n_st = kAll / kPK;

  // Stage st: lanes [64 st, 64 st + 64). A (dh rows) then B (h1 rows), each
  // row 8 16-byte groups in the 128-byte swizzle, one cp.async a group.
  auto load_stage = [&](int st, int slot) {
    const uint32_t base = smem0 + slot * kPStageBytes;
    const int k0 = st * kPK;
    for (int c = tid; c < (kPM + kPN) * 8; c += kWG) {
      const int row = c >> 3;
      const int grp = c & 7;
      const bool is_a = row < kPM;
      const __nv_bfloat16* src = is_a ? dh + static_cast<size_t>(m0 + row) * kAll
                                      : h1 + static_cast<size_t>(n0 + row - kPM) * kAll;
      const uint32_t dst =
          is_a ? base + sw128_offset(row, 8 * grp) : base + kPABytes + sw128_offset(row - kPM, 8 * grp);
      cp_async16(dst, src + k0 + 8 * grp);
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < kPStages - 1; ++i) {
    load_stage(i, i);
    cp_async_commit();
  }
  for (int st = 0; st < n_st; ++st) {
    cp_async_wait<kPStages - 2>();
    fence_async_proxy();
    __syncthreads();  // stage st is in place everywhere; slot (st - 1) % kPStages is free
    const int nx = st + kPStages - 1;
    if (nx < n_st) load_stage(nx, nx % kPStages);
    cp_async_commit();
    const uint32_t a = smem0 + (st % kPStages) * kPStageBytes;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kPK / 16; ++kk) wgmma_ss(acc, sw128_desc(a + 32 * kk), sw128_desc(a + kPABytes + 32 * kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
  }
  cp_async_wait<0>();

  const int ln = tid & 31;
  const int row = m0 + (tid >> 5) * 16 + (ln >> 2);
  const int t4 = ln & 3;
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(out + static_cast<size_t>(row + 8 * r) * kHidden + n0 + 8 * i + 2 * t4) =
          make_float2(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
}

// f32_dot's product on the CUDA cores: each output a chain of FMAs over the
// 1024 lanes in order (dh f32, h1 bf16 widened exactly).
__global__ void __launch_bounds__(256) probe_product_f32_kernel(const float* __restrict__ dh,
                                                                 const __nv_bfloat16* __restrict__ h1,
                                                                 float* __restrict__ out) {
  __shared__ float a_s[kFT][kFT + 1];
  __shared__ float b_s[kFT][kFT + 1];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * kFT;
  const int n0 = blockIdx.y * kFT;
  float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  for (int k0 = 0; k0 < kAll; k0 += kFT) {
    for (int i = threadIdx.x; i < kFT * kFT; i += 256) {
      const int r = i / kFT;
      const int k = i % kFT;
      a_s[r][k] = dh[static_cast<size_t>(m0 + r) * kAll + k0 + k];
      b_s[r][k] = __bfloat162float(h1[static_cast<size_t>(n0 + r) * kAll + k0 + k]);
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kFT; ++k)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) acc[i][j] = __fmaf_rn(a_s[2 * ty + i][k], b_s[2 * tx + j][k], acc[i][j]);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) out[(m0 + 2 * ty + i) * kHidden + n0 + 2 * tx + j] = acc[i][j];
}

template <int kVariant>
int launch_probe(const int32_t* obs, const float* g, const void* w1s, const __nv_bfloat16* b1, const void* w2s,
                 const __nv_bfloat16* b2, __nv_bfloat16* h1, void* dh, float* out, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(probe_forward_kernel<kVariant>, cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  probe_forward_kernel<kVariant><<<kAll / kFwdLanes, kWG, kFwdSmem, stream>>>(obs, g, w1s, b1, w2s, b2, h1, dh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (kVariant == kF32Dot) {
    probe_product_f32_kernel<<<dim3(kHidden / kFT, kHidden / kFT), 256, 0, stream>>>(static_cast<const float*>(dh),
                                                                                    h1, out);
  } else {
    err = cudaFuncSetAttribute(probe_product_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kProductSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    probe_product_kernel<<<dim3(kHidden / kPM, kHidden / kPN), kWG, kProductSmem, stream>>>(
        static_cast<const __nv_bfloat16*>(dh), h1, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Run probe variant `variant` (0-8, tools/probe_mosaic.py::VARIANTS) on
// `stream`: obs (2, 49, 512) int32, g (256, 512) f32, W1^T and W2^T as the
// weight ring's chunks (ops/policy_rollout.py::_b_chunks of wt1 (256, 980),
// K chunks outer, and of wt2 (256, 256)), b1 and b2 (256,) bf16; scratch h1
// (256, 1024) bf16 and dh (256, 1024) bf16 (f32 for f32_dot); out (256, 256)
// f32. Returns the first launch's cudaError_t (cudaErrorInvalidValue for an
// unknown variant).
int mg_mosaic_probe_launch(const void* obs, const void* g, const void* w1s, const void* b1, const void* w2s,
                           const void* b2, void* h1, void* dh, void* out, int variant, void* stream) {
  const auto* o = static_cast<const int32_t*>(obs);
  const auto* gg = static_cast<const float*>(g);
  const auto* c1 = static_cast<const __nv_bfloat16*>(b1);
  const auto* c2 = static_cast<const __nv_bfloat16*>(b2);
  auto* h = static_cast<__nv_bfloat16*>(h1);
  auto* r = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kControlUnmasked: return launch_probe<kControlUnmasked>(o, gg, w1s, c1, w2s, c2, h, dh, r, s);
    case kBaseWhere: return launch_probe<kBaseWhere>(o, gg, w1s, c1, w2s, c2, h, dh, r, s);
    case kBitandMask: return launch_probe<kBitandMask>(o, gg, w1s, c1, w2s, c2, h, dh, r, s);
    case kIntSelectBitcast: return launch_probe<kIntSelectBitcast>(o, gg, w1s, c1, w2s, c2, h, dh, r, s);
    case kScratchRoundtrip: return launch_probe<kScratchRoundtrip>(o, gg, w1s, c1, w2s, c2, h, dh, r, s);
    case kF32Dot: return launch_probe<kF32Dot>(o, gg, w1s, c1, w2s, c2, h, dh, r, s);
    case kOptBarrier: return launch_probe<kOptBarrier>(o, gg, w1s, c1, w2s, c2, h, dh, r, s);
    case kMaskFromF32: return launch_probe<kMaskFromF32>(o, gg, w1s, c1, w2s, c2, h, dh, r, s);
    case kUpcastCmp: return launch_probe<kUpcastCmp>(o, gg, w1s, c1, w2s, c2, h, dh, r, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
