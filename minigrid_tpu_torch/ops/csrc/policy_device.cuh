// Network building blocks shared by the port's actor kernels
// (policy_kernel.cu and grad_kernel.cu): the ActorCritic torso's widths,
// the value-major one-hot feature write, the bf16 bias + relu epilogue and
// the warp-level (256 x K) . (K x BT) product on mma.sync m16n8k16 (bf16
// in, f32 accumulate), with the weight matrix pre-arranged on the host in
// A-fragment order (ops/policy_rollout.py::_a_fragments).
//
// Casts follow the reference forward (ops/policy_rollout.py::policy_logits):
// h = bf16(acc); bf16 + bf16 is an f32 add rounded once to bf16; relu.

#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>

namespace {

constexpr int kHidden = 256;
constexpr int kThreads = 256;
constexpr int kHeadRows = 8;
constexpr int kH1Stride = kHidden + 8;  // bf16 per lane row of h1
constexpr int kKTiles = kHidden / 16;
constexpr int kWidthType = 11;
constexpr int kWidthColor = 6;
constexpr int kWidthState = 3;

// Features per lane: V*V*20 padded to a whole number of 16-wide k tiles.
__host__ __device__ constexpr int padded_features(int view) { return (view * view * 20 + 15) / 16 * 16; }

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
// k contiguous), accumulated in f32 into c. Fragment c[mi][nt] holds rows
// (2 * warp + mi) * 16 + g8 (+ 8 for elements 2, 3) and lanes nt * 8 + 2 *
// t4 (+ 1 for elements 1, 3), with g8 = lane / 4 and t4 = lane % 4.
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

// The f32 head's partial dots: each lane's 256-term dot with the 8 head
// rows is split over kThreads / BT threads (part = tid / BT takes hidden
// units [part * 256 / parts, ...)), and each part's 8 sums go to
// part_s[(part * 8 + a) * BT + lane]. h2s is [256][BT + 8] bf16.
template <int BT>
__device__ __forceinline__ void head_partials(const __nv_bfloat16* h2s, const float* wta_s, float* part_s,
                                              int tid) {
  constexpr int kParts = kThreads / BT;
  constexpr int kSlice = kHidden / kParts;
  constexpr int kH2Stride = BT + 8;
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

// Lane `lane`'s 8 head rows: its parts summed in a fixed order, plus ba.
template <int BT>
__device__ __forceinline__ void head_logits(float (&logit)[kHeadRows], const float* part_s, const float* ba_s,
                                            int lane) {
  constexpr int kParts = kThreads / BT;
#pragma unroll
  for (int a = 0; a < kHeadRows; ++a) {
    float sum = part_s[a * BT + lane];
#pragma unroll
    for (int q = 1; q < kParts; ++q) sum = __fadd_rn(sum, part_s[(q * kHeadRows + a) * BT + lane]);
    logit[a] = __fadd_rn(sum, ba_s[a]);
  }
}

}  // namespace
