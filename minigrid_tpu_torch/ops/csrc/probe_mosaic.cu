// The Mosaic bisection probe for Hopper (sm_90a): the dW2 product of the
// gradient kernel's G2 in isolation, one kernel templated on the variant.
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
// FLOP). The design is the simplest right one: each block owns a 16 x 64
// tile of acc and walks all 1024 lanes in chunks of 32, recomputing the
// forward of the chunk (layer 1 as a sum of the 147 active W1 columns of
// each lane, read from L2; layer 2 for the block's 16 rows only) with
// plain f32 adds and FMAs in a fixed order. Blocks own disjoint tiles and
// each sum runs in one thread in lane order, so there are no float
// atomics and two runs agree bit for bit. The forward, recomputed by each
// of the 64 blocks, keeps it far above its bound (PERF.md); the probe's
// value is as a regression check of G2's masked product, not its speed.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kH = 256;                    // hidden units
constexpr int kV2 = 49;                    // view cells
constexpr int kF = 980;                    // feature rows
constexpr int kLanes = 512;                // lanes of one step (the TPU block)
constexpr int kSteps = 2;                  // steps (the TPU grid)
constexpr int kActive = 3 * kV2;           // feature rows a lane can set
constexpr int kRowTile = 16;               // acc rows per block
constexpr int kColTile = 64;               // acc columns per block
constexpr int kChunk = 32;                 // lanes per chunk
constexpr int kProbeThreads = 256;
constexpr int kColorRow0 = 11 * kV2;       // first colour row
constexpr int kStateRow0 = (11 + 6) * kV2; // first state row

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

template <int kVariant>
__global__ void __launch_bounds__(kProbeThreads) mosaic_probe_kernel(
    const int32_t* __restrict__ obs, const float* __restrict__ g, const __nv_bfloat16* __restrict__ wt1,
    const __nv_bfloat16* __restrict__ b1, const __nv_bfloat16* __restrict__ wt2,
    const __nv_bfloat16* __restrict__ b2, float* __restrict__ out) {
  __shared__ int16_t rows_s[kChunk][kActive];  // each lane's active feature rows (-1: none)
  __shared__ float h1_s[kH][kChunk + 1];
  __shared__ float dh_s[kRowTile][kChunk + 1];
  __shared__ unsigned short scratch_s[kRowTile][kChunk];  // scratch_roundtrip's bf16 dh

  const int tid = threadIdx.x;
  const int o0 = blockIdx.x * kRowTile;  // acc rows: h2 units
  const int u0 = blockIdx.y * kColTile;  // acc columns: h1 units
  const int ao = tid >> 4;               // this thread's acc row in the tile
  const int au = tid & 15;               // and its columns au + 16 k
  float acc[kColTile / 16] = {0.0f, 0.0f, 0.0f, 0.0f};

  for (int n0 = 0; n0 < kSteps * kLanes; n0 += kChunk) {
    const int step = n0 / kLanes;
    const int l0 = n0 % kLanes;
    // The chunk's active feature rows, channel by channel.
    for (int i = tid; i < kChunk * kV2; i += kProbeThreads) {
      const int l = i % kChunk;
      const int kv = i / kChunk;
      const int w = obs[(step * kV2 + kv) * kLanes + l0 + l];
      const int t = w & 15, c = (w >> 4) & 15, s = (w >> 8) & 15;
      rows_s[l][kv] = static_cast<int16_t>(t < 11 ? t * kV2 + kv : -1);
      rows_s[l][kV2 + kv] = static_cast<int16_t>(c < 6 ? kColorRow0 + c * kV2 + kv : -1);
      rows_s[l][2 * kV2 + kv] = static_cast<int16_t>(s < 3 ? kStateRow0 + s * kV2 + kv : -1);
    }
    __syncthreads();

    // Layer 1 for all 256 units: h1 = relu(bf16(bf16(W1 . f) + b1)).
    {
      const int l = tid & 31;
      for (int u = tid >> 5; u < kH; u += kProbeThreads / 32) {
        const __nv_bfloat16* w = wt1 + u * kF;
        float sum = 0.0f;
        for (int r = 0; r < kActive; ++r) {
          const int row = rows_s[l][r];
          if (row >= 0) sum = __fadd_rn(sum, __bfloat162float(w[row]));
        }
        const float pre = bf16_round(__fadd_rn(bf16_round(sum), __bfloat162float(b1[u])));
        h1_s[u][l] = fmaxf(pre, 0.0f);
      }
    }
    __syncthreads();

    // Layer 2 for the tile's 16 rows, then the variant's cotangent.
    for (int m = 0; m < 2; ++m) {
      const int l = (tid & 15) + 16 * m;
      const int o = o0 + ao;
      const __nv_bfloat16* w = wt2 + o * kH;
      float h2d = 0.0f;
      for (int u = 0; u < kH; ++u) h2d = __fmaf_rn(__bfloat162float(w[u]), h1_s[u][l], h2d);
      const float bias = __bfloat162float(b2[o]);
      const float h2p = bf16_round(__fadd_rn(bf16_round(h2d), bias));
      const float gv = g[o * kLanes + l0 + l];
      const bool live = h2p > 0.0f;
      float dh;
      if (kVariant == kControlUnmasked) {
        dh = bf16_round(gv);
      } else if (kVariant == kBitandMask) {
        dh = bf16_value(static_cast<unsigned short>(bf16_bits(gv) & (live ? 0xFFFFu : 0u)));
      } else if (kVariant == kIntSelectBitcast) {
        dh = bf16_value(live ? bf16_bits(gv) : static_cast<unsigned short>(0));
      } else if (kVariant == kF32Dot) {
        dh = live ? gv : 0.0f;
      } else if (kVariant == kMaskFromF32) {
        dh = bf16_round(__fadd_rn(h2d, bias) > 0.0f ? gv : 0.0f);
      } else {  // base_where, scratch_roundtrip, opt_barrier, upcast_cmp
        dh = live ? bf16_round(gv) : 0.0f;
      }
      if (kVariant == kScratchRoundtrip) {
        scratch_s[ao][l] = bf16_bits(dh);
      } else {
        dh_s[ao][l] = dh;
      }
    }
    __syncthreads();

    // acc += dh . h1^T over the chunk's lanes, in lane order.
    for (int l = 0; l < kChunk; ++l) {
      const float d = kVariant == kScratchRoundtrip ? bf16_value(scratch_s[ao][l]) : dh_s[ao][l];
#pragma unroll
      for (int k = 0; k < kColTile / 16; ++k) acc[k] = __fmaf_rn(d, h1_s[u0 + au + 16 * k][l], acc[k]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kColTile / 16; ++k) out[(o0 + ao) * kH + u0 + au + 16 * k] = acc[k];
}

template <int kVariant>
int launch_probe(const int32_t* obs, const float* g, const __nv_bfloat16* wt1, const __nv_bfloat16* b1,
                 const __nv_bfloat16* wt2, const __nv_bfloat16* b2, float* out, cudaStream_t stream) {
  const dim3 grid(kH / kRowTile, kH / kColTile);
  mosaic_probe_kernel<kVariant><<<grid, kProbeThreads, 0, stream>>>(obs, g, wt1, b1, wt2, b2, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Run probe variant `variant` (0-8, tools/probe_mosaic.py::VARIANTS) on
// `stream`: obs (2, 49, 512) int32, g (256, 512) f32, wt1 (256, 980), b1
// (256,), wt2 (256, 256), b2 (256,) bf16, out (256, 256) f32. Returns the
// launch's cudaError_t (cudaErrorInvalidValue for an unknown variant).
int mg_mosaic_probe_launch(const void* obs, const void* g, const void* wt1, const void* b1, const void* wt2,
                           const void* b2, void* out, int variant, void* stream) {
  const auto* o = static_cast<const int32_t*>(obs);
  const auto* gg = static_cast<const float*>(g);
  const auto* w1 = static_cast<const __nv_bfloat16*>(wt1);
  const auto* c1 = static_cast<const __nv_bfloat16*>(b1);
  const auto* w2 = static_cast<const __nv_bfloat16*>(wt2);
  const auto* c2 = static_cast<const __nv_bfloat16*>(b2);
  auto* r = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kControlUnmasked: return launch_probe<kControlUnmasked>(o, gg, w1, c1, w2, c2, r, s);
    case kBaseWhere: return launch_probe<kBaseWhere>(o, gg, w1, c1, w2, c2, r, s);
    case kBitandMask: return launch_probe<kBitandMask>(o, gg, w1, c1, w2, c2, r, s);
    case kIntSelectBitcast: return launch_probe<kIntSelectBitcast>(o, gg, w1, c1, w2, c2, r, s);
    case kScratchRoundtrip: return launch_probe<kScratchRoundtrip>(o, gg, w1, c1, w2, c2, r, s);
    case kF32Dot: return launch_probe<kF32Dot>(o, gg, w1, c1, w2, c2, r, s);
    case kOptBarrier: return launch_probe<kOptBarrier>(o, gg, w1, c1, w2, c2, r, s);
    case kMaskFromF32: return launch_probe<kMaskFromF32>(o, gg, w1, c1, w2, c2, r, s);
    case kUpcastCmp: return launch_probe<kUpcastCmp>(o, gg, w1, c1, w2, c2, r, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
