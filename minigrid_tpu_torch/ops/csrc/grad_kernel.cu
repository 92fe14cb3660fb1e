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
// tensor cores' rate is the bound.
//
// Design (right first; what is left for speed is in PERF.md). The TPU
// kernel keeps the 256 x 980 f32 dW1 accumulator (1 MB) in VMEM across its
// sequential time grid; no CTA can hold it, and blocks run in no order. So
// the pass is split in two kernels, run chunk by chunk over the time axis
// (`tc` steps a chunk) by one host call, on one stream:
//  * G1, one block of 64 lanes and 256 threads per lane tile: for each step
//    of the chunk, the forward as in policy_kernel.cu (one-hot features in
//    shared memory, both torso layers on mma.sync m16n8k16, the f32 head
//    split over threads), the cotangents per lane, dh2 on CUDA cores, and
//    dh1 = W2^T . dh2 on mma.sync with W2^T in A-fragment order. It writes
//    h1, dh2 and dh1 (bf16, (tc, 256, B), lane-contiguous) to scratch, and
//    keeps dwta, the bias grads and the loss sums (all f32, small) in
//    registers, added once per chunk into its lane tile's row of partials.
//  * G2, one block per (128 x 128 output tile, split of the lanes): the two
//    large weight products dW1 = dh1 . feats^T and dW2 = dh2 . h1^T, with
//    the samples as the K dimension, on mma.sync. It re-derives the one-hot
//    features of its 128 feature columns from the obs words instead of
//    storing them, and adds its tile into its split's f32 partial.
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

constexpr int kBT = 64;                   // lanes of a G1 block
constexpr int kH2Stride = kBT + 8;        // bf16 per hidden row of h2 ([256][kBT + 8])
constexpr int kPartWidth = 2576;          // G1 partial row: dwta 2048, db1 256, db2 256, dba 8, sums 8
constexpr int kPartDb1 = kHeadRows * kHidden;
constexpr int kPartDb2 = kPartDb1 + kHidden;
constexpr int kPartDba = kPartDb2 + kHidden;
constexpr int kPartSums = kPartDba + kHeadRows;
constexpr int kTile = 128;                // G2 output tile
constexpr int kKStep = 32;                // G2 samples per shared-memory step
constexpr int kTileStride = kKStep + 8;   // bf16 per row of a G2 operand tile
constexpr int kMaxV2 = 49;                // view cells: V <= 7 (ops/grad_kernel.py checks)

struct GradParams {
  const int32_t* obs;      // (T, V*V, B) obs words, t stride obs_tstride
  const int32_t* actions;  // (T, B), t stride act_tstride
  const float* adv;        // (T, B)
  const float* ret;        // (T, B)
  const uint4* w1frag;     // W1 in A-fragment order (policy_kernel.cu)
  const __nv_bfloat16* b1;
  const uint4* w2frag;     // W2 in A-fragment order
  const __nv_bfloat16* b2;
  const uint4* w2tfrag;    // W2^T in A-fragment order
  const float* wta;        // (8, 256)
  const float* ba;         // (8,)
  __nv_bfloat16* h1;       // scratch (tc, 256, B)
  __nv_bfloat16* dh1;      // scratch (tc, 256, B)
  __nv_bfloat16* dh2;      // scratch (tc, 256, B)
  float* part1;            // (B / 64, kPartWidth)
  float* dw1p;             // (splits, 256, nf)
  float* dw2p;             // (splits, 256, 256)
  long long obs_tstride, act_tstride;
  int B, view, num_actions, nf, splits, split_lanes;
  float inv_denom, vc2, ec;
};

__device__ __forceinline__ float bf16_bits_to_float(unsigned short u) {
  return __bfloat162float(__ushort_as_bfloat16(u));
}

__device__ __forceinline__ unsigned short float_to_bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void addto(float* p, float x, bool accumulate) { *p = accumulate ? *p + x : x; }

// G1: forward, cotangents and the lane-local backward for steps
// [t0, t0 + tcc) of one tile of 64 lanes.
__global__ void __launch_bounds__(kThreads, 1) grad_g1_kernel(const GradParams p, int t0, int tcc,
                                                               int accumulate) {
  constexpr int kNTiles = kBT / 8;
  const int v2 = p.view * p.view;
  const int k_tiles = padded_features(p.view) / 16;
  const int f_stride = padded_features(p.view) + 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* h1s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kBT][kH1Stride]
  __nv_bfloat16* h2s = h1s + kBT * kH1Stride;                         // [256][kH2Stride]
  __nv_bfloat16* dh1s = h2s;                 // [kBT][kH1Stride]: aliases h2 once dh2 is made
  __nv_bfloat16* feat_s = h2s + kHidden * kH2Stride;  // [kBT][f_stride]; after layer 1:
  __nv_bfloat16* dh2s = feat_s;                       //   [kBT][kH1Stride]
  float* part_s = reinterpret_cast<float*>(dh2s + kBT * kH1Stride);  // [4][8][kBT]
  float* dhead_s = part_s + (kThreads / kBT) * kHeadRows * kBT;       // [8][kBT]
  const int region = f_stride * kBT * 2 > (kBT * kH1Stride * 2 + (kThreads / kBT + 1) * kHeadRows * kBT * 4)
                         ? f_stride * kBT * 2
                         : kBT * kH1Stride * 2 + (kThreads / kBT + 1) * kHeadRows * kBT * 4;
  float* wta_s = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(feat_s) + region);
  float* b1_s = wta_s + kHeadRows * kHidden;
  float* b2_s = b1_s + kHidden;
  float* ba_s = b2_s + kHidden;
  float* sums_s = ba_s + kHeadRows;  // [3][kBT]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int ln = tid & 31;
  const int g8 = ln >> 2;
  const int t4 = ln & 3;
  for (int i = tid; i < kHeadRows * kHidden; i += kThreads) wta_s[i] = p.wta[i];
  b1_s[tid] = __bfloat162float(p.b1[tid]);
  b2_s[tid] = __bfloat162float(p.b2[tid]);
  if (tid < kHeadRows) ba_s[tid] = p.ba[tid];

  const size_t B = static_cast<size_t>(p.B);
  const int lane0 = blockIdx.x * kBT;
  const int lane = lane0 + tid;  // the lane of threads tid < kBT
  const int o = tid;             // the hidden unit of thread tid in the column phases
  uint4* feat_words = reinterpret_cast<uint4*>(feat_s);
  const int feat_uint4 = kBT * f_stride / 8;
  unsigned short* frow = reinterpret_cast<unsigned short*>(feat_s + tid * f_stride);

  float dwta_acc[kHeadRows];
#pragma unroll
  for (int a = 0; a < kHeadRows; ++a) dwta_acc[a] = 0.0f;
  float db1_acc = 0.0f, db2_acc = 0.0f, dba_acc = 0.0f;
  float pg_sum = 0.0f, v_sum = 0.0f, ent_sum = 0.0f;
  float wcol[kHeadRows];
#pragma unroll
  for (int a = 0; a < kHeadRows; ++a) wcol[a] = p.wta[a * kHidden + o];

  for (int j = 0; j < tcc; ++j) {
    const int t = t0 + j;
    // ---- the one-hot features of the step's obs words ----
    for (int i = tid; i < feat_uint4; i += kThreads) feat_words[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
    if (tid < kBT) {
      const int32_t* w = p.obs + t * p.obs_tstride + lane;
      for (int kv = 0; kv < v2; ++kv) set_features(frow, kv, v2, w[kv * B]);
    }
    __syncthreads();

    // ---- layer 1: h1 = relu(bf16(bf16(W1 . feats) + b1)) into h1s[lane][o] ----
    {
      float c[2][kNTiles][4];
      warp_product<kBT>(c, p.w1frag, k_tiles, feat_s, f_stride, warp, ln);
      unsigned short* h = reinterpret_cast<unsigned short*>(h1s);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = (warp * 2 + mi) * 16 + g8;
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt) {
          const int n = nt * 8 + 2 * t4;
          h[n * kH1Stride + r] = static_cast<unsigned short>(bias_relu(c[mi][nt][0], b1_s[r]));
          h[(n + 1) * kH1Stride + r] = static_cast<unsigned short>(bias_relu(c[mi][nt][1], b1_s[r]));
          h[n * kH1Stride + r + 8] = static_cast<unsigned short>(bias_relu(c[mi][nt][2], b1_s[r + 8]));
          h[(n + 1) * kH1Stride + r + 8] = static_cast<unsigned short>(bias_relu(c[mi][nt][3], b1_s[r + 8]));
        }
      }
    }
    __syncthreads();

    // ---- h1 to scratch (thread o writes hidden row o); layer 2 into h2s[o][lane] ----
    {
      const unsigned short* h = reinterpret_cast<const unsigned short*>(h1s);
      uint4* dst = reinterpret_cast<uint4*>(p.h1 + (static_cast<size_t>(j) * kHidden + o) * B + lane0);
#pragma unroll
      for (int q = 0; q < kBT / 8; ++q) {
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[e] = h[(q * 8 + 2 * e) * kH1Stride + o] | (static_cast<uint32_t>(h[(q * 8 + 2 * e + 1) * kH1Stride + o]) << 16);
        dst[q] = make_uint4(w[0], w[1], w[2], w[3]);
      }
      float c[2][kNTiles][4];
      warp_product<kBT>(c, p.w2frag, kKTiles, h1s, kH1Stride, warp, ln);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = (warp * 2 + mi) * 16 + g8;
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt) {
          const int n = nt * 8 + 2 * t4;
          *reinterpret_cast<uint32_t*>(h2s + r * kH2Stride + n) =
              bias_relu(c[mi][nt][0], b2_s[r]) | (bias_relu(c[mi][nt][1], b2_s[r]) << 16);
          *reinterpret_cast<uint32_t*>(h2s + (r + 8) * kH2Stride + n) =
              bias_relu(c[mi][nt][2], b2_s[r + 8]) | (bias_relu(c[mi][nt][3], b2_s[r + 8]) << 16);
        }
      }
    }
    __syncthreads();

    // ---- the f32 head ----
    head_partials<kBT>(h2s, wta_s, part_s, tid);
    __syncthreads();

    // ---- per lane: the loss terms and the head cotangent ----
    if (tid < kBT) {
      float logit[kHeadRows];
      head_logits<kBT>(logit, part_s, ba_s, tid);
      const size_t i_tb = static_cast<size_t>(t) * B + lane;
      const int act = p.actions[t * p.act_tstride + lane];
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
      for (int i = 0; i < kHeadRows - 1; ++i) dhead_s[i * kBT + tid] = i < na ? dlp[i] - prob[i] * s_dlp : 0.0f;
      dhead_s[(kHeadRows - 1) * kBT + tid] = p.vc2 * dv * p.inv_denom;
      v_sum += dv * dv;
    }
    __syncthreads();

    // ---- thread o: dh2 = bf16(mask * wta^T . dhead) for every lane, dwta
    //      and db2 into registers, dh2 to scratch and to dh2s[lane][o] ----
    {
      unsigned short* d2 = reinterpret_cast<unsigned short*>(dh2s);
      uint4* dst = reinterpret_cast<uint4*>(p.dh2 + (static_cast<size_t>(j) * kHidden + o) * B + lane0);
      uint32_t w[4];
      for (int l = 0; l < kBT; ++l) {
        const float h2 = __bfloat162float(h2s[o * kH2Stride + l]);
        float dh2f = 0.0f;
#pragma unroll
        for (int a = 0; a < kHeadRows; ++a) {
          const float dh = dhead_s[a * kBT + l];
          dh2f += wcol[a] * dh;
          dwta_acc[a] += dh * h2;
        }
        const unsigned short bits = h2 > 0.0f ? float_to_bf16_bits(dh2f) : 0;
        db2_acc += bf16_bits_to_float(bits);
        d2[l * kH1Stride + o] = bits;
        if (l & 1) {
          w[(l >> 1) & 3] |= static_cast<uint32_t>(bits) << 16;
        } else {
          w[(l >> 1) & 3] = bits;
        }
        if ((l & 7) == 7) dst[l >> 3] = make_uint4(w[0], w[1], w[2], w[3]);
      }
      if (tid < kHeadRows)
        for (int l = 0; l < kBT; ++l) dba_acc += dhead_s[tid * kBT + l];
    }
    __syncthreads();

    // ---- dh1 = bf16(mask * W2^T . dh2) on the tensor cores into dh1s[lane][o] ----
    {
      float c[2][kNTiles][4];
      warp_product<kBT>(c, p.w2tfrag, kKTiles, dh2s, kH1Stride, warp, ln);
      const unsigned short* h = reinterpret_cast<const unsigned short*>(h1s);
      unsigned short* d1 = reinterpret_cast<unsigned short*>(dh1s);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = (warp * 2 + mi) * 16 + g8;
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt) {
          const int n = nt * 8 + 2 * t4;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rr = r + (e >> 1) * 8;
            const int nn = n + (e & 1);
            const bool on = bf16_bits_to_float(h[nn * kH1Stride + rr]) > 0.0f;
            d1[nn * kH1Stride + rr] = on ? float_to_bf16_bits(c[mi][nt][e]) : 0;
          }
        }
      }
    }
    __syncthreads();

    // ---- thread o: db1 and dh1 to scratch ----
    {
      const unsigned short* d1 = reinterpret_cast<const unsigned short*>(dh1s);
      uint4* dst = reinterpret_cast<uint4*>(p.dh1 + (static_cast<size_t>(j) * kHidden + o) * B + lane0);
#pragma unroll
      for (int q = 0; q < kBT / 8; ++q) {
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const unsigned short lo = d1[(q * 8 + 2 * e) * kH1Stride + o];
          const unsigned short hi = d1[(q * 8 + 2 * e + 1) * kH1Stride + o];
          db1_acc += bf16_bits_to_float(lo);
          db1_acc += bf16_bits_to_float(hi);
          w[e] = lo | (static_cast<uint32_t>(hi) << 16);
        }
        dst[q] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    __syncthreads();
  }

  // ---- the chunk's sums into this lane tile's partial row ----
  if (tid < kBT) {
    sums_s[tid] = pg_sum;
    sums_s[kBT + tid] = v_sum;
    sums_s[2 * kBT + tid] = ent_sum;
  }
  __syncthreads();
  float* part = p.part1 + static_cast<size_t>(blockIdx.x) * kPartWidth;
  const bool acc = accumulate != 0;
#pragma unroll
  for (int a = 0; a < kHeadRows; ++a) addto(part + a * kHidden + o, dwta_acc[a], acc);
  addto(part + kPartDb1 + o, db1_acc, acc);
  addto(part + kPartDb2 + o, db2_acc, acc);
  if (tid < kHeadRows) addto(part + kPartDba + tid, dba_acc, acc);
  if (tid < 3) {
    float s = 0.0f;
    for (int l = 0; l < kBT; ++l) s += sums_s[tid * kBT + l];
    addto(part + kPartSums + tid, s, acc);
  }
}

// G2: one 128 x 128 tile of dW1 = dh1 . feats^T (tiles [0, 2 * nf / 128))
// or of dW2 = dh2 . h1^T (the next 4), over the lanes of split blockIdx.y
// and the steps [t0, t0 + tcc), added into the split's f32 partial.
__global__ void __launch_bounds__(kThreads) grad_g2_kernel(const GradParams p, int t0, int tcc,
                                                           int accumulate) {
  __shared__ __align__(16) __nv_bfloat16 as[kTile * kTileStride];
  __shared__ __align__(16) __nv_bfloat16 bs[kTile * kTileStride];
  __shared__ int32_t ws[kMaxV2 * kKStep];  // obs words [v2][kKStep]

  const int v2 = p.view * p.view;
  const int w1_tiles = 2 * (p.nf / kTile);
  const bool is_w1 = static_cast<int>(blockIdx.x) < w1_tiles;
  const int tile = is_w1 ? blockIdx.x : blockIdx.x - w1_tiles;
  const int n_tiles = is_w1 ? p.nf / kTile : kHidden / kTile;
  const int mt = tile / n_tiles;
  const int nt = tile % n_tiles;
  const __nv_bfloat16* a_src = is_w1 ? p.dh1 : p.dh2;
  const size_t B = static_cast<size_t>(p.B);
  const int s = blockIdx.y;
  const int l_begin = s * p.split_lanes;
  const int l_end = min(l_begin + p.split_lanes, p.B);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int ln = tid & 31;
  const int g8 = ln >> 2;
  const int t4 = ln & 3;
  const int wm = warp & 1;   // rows [wm * 64, +64) of the tile
  const int wn = warp >> 1;  // columns [wn * 32, +32)

  // The feature column this thread builds (W1 tiles): value-major row
  // off_ch + val * V * V + kv; f >= V * V * 20 is a zero column.
  const int bn = tid >> 1;
  const int bk = (tid & 1) * 16;
  const int f = nt * kTile + bn;
  int f_kv = 0, f_shift = 0, f_val = -1;
  if (is_w1 && f < v2 * 20) {
    int off = f;
    if (off < kWidthType * v2) {
      f_shift = 0;
    } else if (off < (kWidthType + kWidthColor) * v2) {
      off -= kWidthType * v2;
      f_shift = 4;
    } else {
      off -= (kWidthType + kWidthColor) * v2;
      f_shift = 8;
    }
    f_val = off / v2;
    f_kv = off % v2;
  }

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

  for (int j = 0; j < tcc; ++j) {
    const int t = t0 + j;
    const __nv_bfloat16* a_rows = a_src + (static_cast<size_t>(j) * kHidden + mt * kTile) * B;
    const __nv_bfloat16* b_rows = p.h1 + (static_cast<size_t>(j) * kHidden + nt * kTile) * B;
    for (int l0 = l_begin; l0 < l_end; l0 += kKStep) {
      // A: 128 rows x 32 lanes; B: h1 rows, or the obs words of 32 lanes.
      for (int idx = tid; idx < kTile * 4; idx += kThreads) {
        const int r = idx >> 2;
        const int q = idx & 3;
        *reinterpret_cast<uint4*>(as + r * kTileStride + q * 8) =
            *reinterpret_cast<const uint4*>(a_rows + r * B + l0 + q * 8);
        if (!is_w1)
          *reinterpret_cast<uint4*>(bs + r * kTileStride + q * 8) =
              *reinterpret_cast<const uint4*>(b_rows + r * B + l0 + q * 8);
      }
      if (is_w1) {
        const int32_t* w = p.obs + t * p.obs_tstride + l0;
        for (int idx = tid; idx < v2 * kKStep; idx += kThreads) {
          const int kv = idx / kKStep;
          ws[idx] = w[kv * B + (idx - kv * kKStep)];
        }
        __syncthreads();
        uint32_t wv[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          uint32_t pair = 0;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int word = ws[f_kv * kKStep + bk + 2 * e + h];
            const bool one = ((word >> f_shift) & 15) == f_val;
            pair |= (one ? 0x3F80u : 0u) << (16 * h);
          }
          wv[e] = pair;
        }
        uint4* dst = reinterpret_cast<uint4*>(bs + bn * kTileStride + bk);
        dst[0] = make_uint4(wv[0], wv[1], wv[2], wv[3]);
        dst[1] = make_uint4(wv[4], wv[5], wv[6], wv[7]);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kKStep; kk += 16) {
        uint4 af[4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          const __nv_bfloat16* r0 = as + (wm * 64 + mi * 16 + g8) * kTileStride + kk + 2 * t4;
          const __nv_bfloat16* r1 = r0 + 8 * kTileStride;
          af[mi] = make_uint4(*reinterpret_cast<const uint32_t*>(r0), *reinterpret_cast<const uint32_t*>(r1),
                              *reinterpret_cast<const uint32_t*>(r0 + 8), *reinterpret_cast<const uint32_t*>(r1 + 8));
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const __nv_bfloat16* c0 = bs + (wn * 32 + ni * 8 + g8) * kTileStride + kk + 2 * t4;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(c0);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(c0 + 8);
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) mma_bf16(acc[mi][ni], af[mi], b0, b1);
        }
      }
      __syncthreads();
    }
  }

  const int ld = is_w1 ? p.nf : kHidden;
  float* out = (is_w1 ? p.dw1p : p.dw2p) + static_cast<size_t>(s) * kHidden * ld;
  const bool accum = accumulate != 0;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = mt * kTile + wm * 64 + mi * 16 + g8 + (e >> 1) * 8;
        const int col = nt * kTile + wn * 32 + ni * 8 + 2 * t4 + (e & 1);
        addto(out + static_cast<size_t>(row) * ld + col, acc[mi][ni][e], accum);
      }
}

}  // namespace

extern "C" {

// Run the gradient pass on `stream`: for each chunk of `tc` steps, G1 on
// B / 64 lane tiles with `smem_bytes` of dynamic shared memory
// (ops/grad_kernel.py::grad_smem_bytes), then G2 on (2 * nf / 128 + 4,
// splits) tiles. The first chunk writes the partials, later ones add to
// them. Returns the first cudaError_t of a launch, or 0.
int mg_grad_launch(const void* obs, const void* actions, const void* adv, const void* ret,
                   const void* w1frag, const void* b1, const void* w2frag, const void* b2,
                   const void* w2tfrag, const void* wta, const void* ba, void* h1, void* dh1,
                   void* dh2, void* part1, void* dw1p, void* dw2p, long long obs_tstride,
                   long long act_tstride, int B, int T, int view, int num_actions, int tc, int nf,
                   int splits, int split_lanes, float inv_denom, float vc2, float ec,
                   int smem_bytes, void* stream) {
  GradParams p;
  p.obs = static_cast<const int32_t*>(obs);
  p.actions = static_cast<const int32_t*>(actions);
  p.adv = static_cast<const float*>(adv);
  p.ret = static_cast<const float*>(ret);
  p.w1frag = static_cast<const uint4*>(w1frag);
  p.b1 = static_cast<const __nv_bfloat16*>(b1);
  p.w2frag = static_cast<const uint4*>(w2frag);
  p.b2 = static_cast<const __nv_bfloat16*>(b2);
  p.w2tfrag = static_cast<const uint4*>(w2tfrag);
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
  p.inv_denom = inv_denom;
  p.vc2 = vc2;
  p.ec = ec;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(grad_g1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 g2_grid(2 * (nf / kTile) + 4, splits);
  for (int t0 = 0; t0 < T; t0 += tc) {
    const int tcc = T - t0 < tc ? T - t0 : tc;
    grad_g1_kernel<<<B / kBT, kThreads, smem_bytes, s>>>(p, t0, tcc, t0 > 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    grad_g2_kernel<<<g2_grid, kThreads, 0, s>>>(p, t0, tcc, t0 > 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
