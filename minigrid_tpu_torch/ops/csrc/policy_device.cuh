// Network building blocks shared by the port's actor kernels
// (policy_kernel.cuh and grad_kernel.cu) on Hopper's warpgroup products:
// the ActorCritic torso's widths, the bf16 bias + relu epilogue, the
// mbarrier, bulk-copy and wgmma primitives, the weight ring, and the
// forward of one warpgroup's 64 lanes (`layer1`, `h1_fragments`,
// `layer2_head`).
//
// Orientation: D[lanes x 256] = Feat[lanes x K] . W1^T[K x 256]. The lanes
// are wgmma's M (64 a warpgroup), the hidden units its N. The A operand, the
// one-hot features, is built in registers from the lanes' feature bits in
// shared memory (`feature_fragment`); B, W1^T in chunks of 64 (K) x 128
// (N), comes from a ring of shared-memory slots filled with bulk copies
// (`cp.async.bulk` + mbarrier), each slot read by every consumer
// warpgroup of the block before it is refilled. Layer 1's f32
// accumulators are rounded (bias + relu) straight into layer 2's A
// fragments, which stay in registers (the accumulator layout of a row of
// n8 tiles is the A-fragment layout of a k16 slab); W2^T is layer 2's B.
//
// Every operand in shared memory is K-major in the 128-byte swizzle: rows
// of 64 bf16 (128 bytes), 8-row atoms of 1024 bytes whose rows permute
// their 16-byte groups by the row's index in the atom (`sw128_offset`), as
// the host lays the weights out (ops/policy_rollout.py::_b_chunks). A k16
// slab of such a tile starts 32 bytes further along each row. (The layout
// without swizzle ran the tensor cores at about a third of their rate on
// the card: its 16-byte groups of eight rows share banks.)
//
// Casts follow the reference forward (ops/policy_rollout.py::policy_logits):
// h = bf16(acc); bf16 + bf16 is an f32 add rounded once to bf16; relu.

#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>

namespace {

constexpr int kHidden = 256;
constexpr int kHeadRows = 8;
constexpr int kKTiles = kHidden / 16;
constexpr int kWidthType = 11;
constexpr int kWidthColor = 6;
constexpr int kWidthState = 3;
constexpr int kWG = 128;             // threads of a warpgroup
constexpr int kChunkBytes = 16384;   // one ring slot: a 64 (K) x 128 (N) bf16 chunk
constexpr int kW2Chunks = 8;         // W2^T in chunks: (N half, K chunk)
constexpr int kBarBytes = 1024;      // the ring's bookkeeping at the start of shared memory
constexpr int kMaxStages = 16;

// Features per lane: V*V*20 padded to a whole number of 16-deep k slabs (a
// multiple of 32 for an odd view): W1^T streams as 64-deep chunks and, where
// 32 features are left, a tail of two k slabs.
__host__ __device__ constexpr int padded_features(int view) { return (view * view * 20 + 15) / 16 * 16; }

// relu(bf16(bf16(acc) + bias)) as bf16 bits; `bias` is a bf16 value in f32.
__device__ __forceinline__ uint32_t bias_relu(float acc, float bias) {
  const float h = __bfloat162float(__float2bfloat16_rn(acc));
  const float s = __bfloat162float(__float2bfloat16_rn(__fadd_rn(h, bias)));
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(fmaxf(s, 0.0f))));
}

__device__ __forceinline__ float bf16_bits_to_float(uint32_t u) {
  return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(u)));
}

// ---- Hopper primitives ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed: one asm
// loop, with no branch of the program around it (a divergent path between
// the products makes ptxas serialize every wgmma). A wait that outlasts
// 2^26 polls (seconds, where a chunk takes microseconds) traps, so that a
// broken protocol ends the launch with an error instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      ".reg .u32 N;\n"
      "mov.u32 N, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "add.u32 N, N, 1;\n"
      "setp.ne.u32 P1, N, 67108864;\n"
      "@P1 bra WAIT;\n"
      "trap;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, counted on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// Shared-memory writes of the generic proxy (plain stores, cp.async) made
// visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_async_proxy() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// Named barrier `id` over `count` threads (the consumers, or one warpgroup).
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers in place around the asynchronous products: every register
// a wgmma reads (its A fragments, its accumulators) must be written before
// the wgmma.fence that precedes it, and the accumulators read only after
// the wait; without these the compiler may move a fragment's arithmetic
// past the fence, and ptxas then serializes every product.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// Byte offset of element (row, k), k < 64, in a K-major tile of 128-byte
// rows in the 128-byte swizzle.
__host__ __device__ inline int sw128_offset(int row, int k) {
  return row * 128 + ((((k >> 3) ^ row) & 7) << 4) + (k & 7) * 2;
}

// Matrix descriptor of a K-major operand without swizzle at shared address
// `addr`: `lbo` bytes between core matrices along K, `sbo` along M or N.
// Only W1^T's tail uses it: two 16 x 256 slabs in 8 x 8 core matrices of
// 128 bytes (`slab_desc`: 128 B along K, 256 B along N).
__device__ __forceinline__ uint64_t slab_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

// Matrix descriptor of a K-major operand in the 128-byte swizzle whose k16
// slab starts at shared address `addr` (an atom's base, 1024-aligned, plus
// 32 bytes a slab): 1024 bytes between 8-row atoms.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (1ull << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

// D (64 x 128, f32 in registers) += A (64 x 16 bf16, in registers, the
// mma.sync A-fragment layout per warp) . B (16 x 128 bf16, K-major in shared
// memory at `desc`); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// D (64 x 128, f32 in registers) += A (64 x 16 bf16) . B (16 x 128 bf16),
// both K-major in shared memory at `desc_a` and `desc_b`.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// ---- the weight ring ----
//
// Shared memory starts with kBarBytes of bookkeeping: the slots' full
// barriers (one arrival and the chunk's bytes each), a release counter per
// slot and the chunk sequence; the slots follow, 1024-aligned. Each slot
// holds one 16 KB chunk, moved by one bulk copy. No warp is set apart to
// feed the ring (a producer warp would cost the consumers' register budget
// a whole warpgroup's share): the first thread fills the first `stages`
// slots, and afterwards the warpgroup that hands a slot back last refills
// it with the chunk `stages` further on.

constexpr int kReleasedOffset = 8 * kMaxStages;
constexpr int kSequenceOffset = kReleasedOffset + 4 * kMaxStages;

// The chunks a block streams, in the order its products use them: each
// step count[0] chunks from src[0], then count[1] from src[1] and count[2]
// from src[2] (kChunkBytes apart), for `steps` steps.
struct ChunkSequence {
  const char* src[3];
  int count[3];
  int steps;

  __device__ __forceinline__ int per_step() const { return count[0] + count[1] + count[2]; }
  // Chunk `pos` of a step (selects, no branches).
  __device__ __forceinline__ const char* chunk(int pos) const {
    const bool first = pos < count[0];
    const bool second = pos < count[0] + count[1];
    const char* base = first ? src[0] : (second ? src[1] : src[2]);
    const int idx = first ? pos : (second ? pos - count[0] : pos - count[0] - count[1]);
    return base + static_cast<size_t>(idx) * kChunkBytes;
  }
};

__device__ __forceinline__ void fill_slot(const unsigned char* smem, int slot, const char* src) {
  const uint32_t full = smem_addr(smem) + 8 * slot;
  mbar_expect_tx(full, kChunkBytes);
  bulk_load(smem_addr(smem) + kBarBytes + slot * kChunkBytes, src, kChunkBytes, full);
}

// Thread 0, before the block's first __syncthreads: the barriers, the
// counters and the sequence, then the first `stages` chunks in flight.
// Shared memory must start 1024-aligned (the swizzle's atoms); it traps if
// it does not.
__device__ __forceinline__ void init_ring(unsigned char* smem, int stages, const ChunkSequence& sq) {
  const uint32_t bars = smem_addr(smem);
  if (bars & 1023u) __trap();
  int* released = reinterpret_cast<int*>(smem + kReleasedOffset);
  for (int s = 0; s < stages; ++s) {
    mbar_init(bars + 8 * s, 1);
    released[s] = 0;
  }
  *reinterpret_cast<ChunkSequence*>(smem + kSequenceOffset) = sq;
  mbar_init_fence();
  const int total = sq.steps * sq.per_step();
  for (int i = 0; i < stages && i < total; ++i) fill_slot(smem, i, sq.chunk(i % sq.per_step()));
}

// A slot in use: which, the chunk's index in the sequence and in its step.
struct Held {
  int slot, seq, pos;
};

// A consumer thread's walk over the ring. Every consumer thread walks the
// whole sequence; one thread per warpgroup (`elected`) hands slots back.
// `groups` (1 or 2) warpgroups read each chunk; `per_step` and `total` are
// the sequence's.
struct Ring {
  unsigned char* smem;
  int stages, groups, per_step, total;
  int slot = 0, seq = 0, pos = 0;
  uint32_t phase = 0;

  // Wait for the current chunk; returns its shared address.
  __device__ __forceinline__ uint32_t acquire() {
    mbar_wait(smem_addr(smem) + 8 * slot, phase);
    return smem_addr(smem) + kBarBytes + slot * kChunkBytes;
  }
  // Step to the next chunk; returns the one just acquired.
  __device__ __forceinline__ Held advance() {
    const Held h{slot, seq, pos};
    ++seq;
    if (++pos == per_step) pos = 0;
    if (++slot == stages) {
      slot = 0;
      phase ^= 1u;
    }
    return h;
  }
  // Hand `h` back once this warpgroup's products on it completed; the last
  // of the block's warpgroups to do so refills the slot. Predicated, not
  // branched: only `elected` (one thread a warpgroup) acts.
  __device__ __forceinline__ void release(Held h, bool elected) {
    const bool act = elected && h.slot >= 0 && h.seq + stages < total;
    const uint32_t counter = smem_addr(smem) + kReleasedOffset + 4 * (h.slot & (kMaxStages - 1));
    uint32_t old = 0;
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n@p atom.shared.add.u32 %0, [%1], 1;\n}\n"
        : "+r"(old)
        : "r"(counter), "r"(static_cast<int>(act))
        : "memory");
    const bool fill = act && ((old + 1) & (groups - 1)) == 0;
    int next = h.pos + stages;
    next -= next >= per_step ? per_step : 0;
    next -= next >= per_step ? per_step : 0;
    const ChunkSequence& sq = *reinterpret_cast<const ChunkSequence*>(smem + kSequenceOffset);
    const char* src = sq.chunk(next);
    const uint32_t full = smem_addr(smem) + 8 * (h.slot & (kMaxStages - 1));
    const uint32_t dst = smem_addr(smem) + kBarBytes + (h.slot & (kMaxStages - 1)) * kChunkBytes;
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %4, 0;\n"
        "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %3;\n"
        "@p cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%1], [%2], %3, [%0];\n}\n" ::"r"(full),
        "r"(dst), "l"(src), "r"(kChunkBytes), "r"(static_cast<int>(fill))
        : "memory");
  }
};

// ---- the forward of one warpgroup's 64 lanes ----
//
// Thread (warp w of the group, lane l; g = l / 4, t = l % 4) holds rows
// (lanes) 16 w + g and 16 w + g + 8 of every fragment; an accumulator's
// element 4 i + e is column 8 i + 2 t + (e & 1) of row g (e < 2) or g + 8.

// The feature code of packed feature row k (value-major: row off_ch + v *
// V*V + kv): kv | shift << 10 | v << 16; a padding row has v = 16, which
// no 4-bit field equals.
__host__ __device__ inline int feature_code(int k, int v2) {
  if (k >= 20 * v2) return 16 << 16;
  int off = k, shift = 0;
  if (off >= kWidthType * v2) {
    off -= kWidthType * v2;
    shift = 4;
    if (off >= kWidthColor * v2) {
      off -= kWidthColor * v2;
      shift = 8;
    }
  }
  return (off % v2) | (shift << 10) | ((off / v2) << 16);
}

// bf16 1.0 where the view word's field `code` names holds its value.
__device__ __forceinline__ uint32_t one_hot(uint32_t word, int code) {
  return ((word >> ((code >> 10) & 15)) & 15u) == static_cast<uint32_t>(code >> 16) ? 0x3F80u : 0u;
}

// A lane's one-hot features as a bitset: bit k of its words is feature row
// k (value-major), so a 16-deep k slab is half of one 32-bit word. Lane
// `col`'s words lie `stride` apart (stride = the block's lanes).
__device__ __forceinline__ void clear_feature_bits(uint32_t* col, int stride, int words) {
  for (int w = 0; w < words; ++w) col[w * stride] = 0u;
}

// Set the features of view cell kv holding packed word m: one bit per
// channel, none for a channel value at or above its width. Shared-memory
// reductions (atomicOr, whose result is unused), so that a thread does not
// wait on its own read-modify-write chain: a lane's cells hit the same few
// words one after another.
__device__ __forceinline__ void set_feature_bits(uint32_t* col, int stride, int kv, int v2, int m) {
  const int ty = m & 15;
  const int co = (m >> 4) & 15;
  const int st = (m >> 8) & 15;
  if (ty < kWidthType) {
    const int k = ty * v2 + kv;
    atomicOr(col + (k >> 5) * stride, 1u << (k & 31));
  }
  if (co < kWidthColor) {
    const int k = (kWidthType + co) * v2 + kv;
    atomicOr(col + (k >> 5) * stride, 1u << (k & 31));
  }
  if (st < kWidthState) {
    const int k = (kWidthType + kWidthColor + st) * v2 + kv;
    atomicOr(col + (k >> 5) * stride, 1u << (k & 31));
  }
}

// Two bf16 features from bits 0 and 1 of x: 1.0 where the bit is set.
__device__ __forceinline__ uint32_t one_hot_pair(uint32_t x) { return (x & 1u) * 0x3F80u | (x & 2u) * 0x1FC00000u; }

// The A fragment of k slab kt from word kt / 2 of the feature bits of this
// thread's rows (w0 for row r0, w1 for r0 + 8): columns 2 t, 2 t + 1,
// 2 t + 8 and 2 t + 9 of the slab.
__device__ __forceinline__ void feature_fragment(uint32_t (&a)[4], uint32_t w0, uint32_t w1, int kt, int t4) {
  const int o = 16 * (kt & 1) + 2 * t4;
  const uint32_t x0 = w0 >> o;
  const uint32_t x1 = w1 >> o;
  a[0] = one_hot_pair(x0);
  a[1] = one_hot_pair(x1);
  a[2] = one_hot_pair(x0 >> 8);
  a[3] = one_hot_pair(x1 >> 8);
}

// The A fragments of the four k16 slabs of a 64-deep K chunk from the
// feature words of this thread's rows (w0x for row r0, w1x for r0 + 8; x = 0
// for the chunk's first 32 features, 1 for the rest).
__device__ __forceinline__ void chunk_fragments(uint32_t (&a)[4][4], uint32_t w00, uint32_t w10, uint32_t w01,
                                                uint32_t w11, int t4) {
#pragma unroll
  for (int j = 0; j < 4; ++j) feature_fragment(a[j], j < 2 ? w00 : w01, j < 2 ? w10 : w11, j, t4);
}

// Layer 1 on the tensor cores: acc[n half] = Feat . W1^T over the ring's
// `k_chunks` 64-deep K chunks (N half 0, then 1, for each) and, where the
// features leave 32 over (`tail`), one chunk of two 16 x 256 slabs. The
// fragments of a K chunk are built from the lanes' feature bits (`bits`,
// words `stride` apart) before one wgmma.fence, and each N half is one
// commit group of four products; a K chunk's slots are handed back, and
// the fragments rebuilt, once its products completed.
__device__ __forceinline__ void layer1(float (&acc)[2][64], Ring& ring, const uint32_t* bits, int stride,
                                       int k_chunks, bool tail, int r0, int t4, bool elected) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.0f;
  fence_acc(acc[0]);
  fence_acc(acc[1]);
  uint32_t a[4][4];
  Held held[2] = {{-1, 0, 0}, {-1, 0, 0}};
  for (int kc = 0; kc < k_chunks; ++kc) {
    const uint32_t* wrow = bits + 2 * kc * stride + r0;
    const uint32_t w00 = wrow[0];
    const uint32_t w10 = wrow[8];
    const uint32_t w01 = wrow[stride];
    const uint32_t w11 = wrow[stride + 8];
    wgmma_wait<0>();
    ring.release(held[0], elected);
    ring.release(held[1], elected);
    chunk_fragments(a, w00, w10, w01, w11, t4);
    fence_frags(a);
    const uint32_t lo = ring.acquire();
    held[0] = ring.advance();
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) wgmma_rs(acc[0], a[j], sw128_desc(lo + 32 * j), kc + j > 0);
    wgmma_commit();
    const uint32_t hi = ring.acquire();
    held[1] = ring.advance();
#pragma unroll
    for (int j = 0; j < 4; ++j) wgmma_rs(acc[1], a[j], sw128_desc(hi + 32 * j), kc + j > 0);
    wgmma_commit();
  }
  if (tail) {
    const uint32_t w0 = bits[2 * k_chunks * stride + r0];
    const uint32_t w1 = bits[2 * k_chunks * stride + r0 + 8];
    wgmma_wait<0>();
    ring.release(held[0], elected);
    ring.release(held[1], elected);
    held[1] = Held{-1, 0, 0};
    feature_fragment(a[0], w0, w1, 0, t4);
    feature_fragment(a[1], w0, w1, 1, t4);
    fence_frags(a);
    const uint32_t chunk = ring.acquire();
    held[0] = ring.advance();
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wgmma_rs(acc[0], a[j], slab_desc(chunk + 8192 * j), 1);
      wgmma_rs(acc[1], a[j], slab_desc(chunk + 8192 * j + 4096), 1);
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
  ring.release(held[0], elected);
  ring.release(held[1], elected);
  fence_acc(acc[0]);
  fence_acc(acc[1]);
}

// W1^T's chunks a step streams at view `v`: two a 64-deep K chunk, and the
// tail of two k slabs where there is one.
__device__ __forceinline__ int w1_chunks(int v) { return padded_features(v) / 64 * 2 + (padded_features(v) % 64 ? 1 : 0); }

// h1 = relu(bf16(bf16(acc) + b1)) as layer 2's A fragments: h[kt] is k slab
// kt (hidden units 16 kt .. 16 kt + 15), taken from n8 tiles 2 p and 2 p + 1
// of accumulator half kt / 8 (p = kt % 8).
__device__ __forceinline__ void h1_fragments(uint32_t (&h)[kKTiles][4], const float (&acc)[2][64], const float* b1,
                                             int t4) {
#pragma unroll
  for (int kt = 0; kt < kKTiles; ++kt) {
    const int c0 = (kt / 8) * 128 + 16 * (kt % 8) + 2 * t4;
    const float2 ba = *reinterpret_cast<const float2*>(b1 + c0);
    const float2 bb = *reinterpret_cast<const float2*>(b1 + c0 + 8);
    const float* x = acc[kt / 8] + 8 * (kt % 8);
    h[kt][0] = bias_relu(x[0], ba.x) | bias_relu(x[1], ba.y) << 16;
    h[kt][1] = bias_relu(x[2], ba.x) | bias_relu(x[3], ba.y) << 16;
    h[kt][2] = bias_relu(x[4], bb.x) | bias_relu(x[5], bb.y) << 16;
    h[kt][3] = bias_relu(x[6], bb.x) | bias_relu(x[7], bb.y) << 16;
  }
}

// One 128-unit half of a 64 x 256 . 256 x 256 product whose A fragments
// are `h` (k slab kt = h[kt]) and whose B is the next 4 chunks of the ring
// (K chunks 0..3 of that N half): one commit group of four products a
// chunk, each chunk handed back once its products completed.
__device__ __forceinline__ void product_half(float (&acc)[64], const uint32_t (&h)[kKTiles][4], Ring& ring,
                                             bool elected) {
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
    for (int j = 0; j < 4; ++j) wgmma_rs(acc, h[4 * kc + j], sw128_desc(chunk + 32 * j), kc + j > 0);
    wgmma_commit();
    if (kc > 0) wgmma_wait<1>();
    ring.release(held, elected);
    held = now;
  }
  wgmma_wait<0>();
  ring.release(held, elected);
  fence_acc(acc);
}

// Layer 2 and the f32 head: for each N half, h2 = relu(bf16(bf16(h1 . W2^T)
// + b2)), `on_h2(row, col, bits)` for every element (row 0 is lane g, 1 is
// g + 8), and the head's partial dots of this thread's columns, in column
// order, into head[row][a] (wta_s is [256][8] f32).
template <class OnH2>
__device__ __forceinline__ void layer2_head(float (&head)[2][kHeadRows], uint32_t (&h)[kKTiles][4], Ring& ring,
                                            const float* b2, const float* wta_s, int t4, bool elected, OnH2&& on_h2) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int a = 0; a < kHeadRows; ++a) head[r][a] = 0.0f;
  fence_frags(h);
#pragma unroll 1
  for (int hn = 0; hn < 2; ++hn) {
    float acc[64];
    product_half(acc, h, ring, elected);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = hn * 128 + 8 * i + 2 * t4 + c;
        const float4 w0 = *reinterpret_cast<const float4*>(wta_s + col * kHeadRows);
        const float4 w1 = *reinterpret_cast<const float4*>(wta_s + col * kHeadRows + 4);
        const float w[kHeadRows] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t bits = bias_relu(acc[4 * i + 2 * r + c], b2[col]);
          on_h2(r, col, bits);
          const float x = bf16_bits_to_float(bits);
#pragma unroll
          for (int a = 0; a < kHeadRows; ++a) head[r][a] = fmaf(w[a], x, head[r][a]);
        }
      }
    }
  }
}

// The head's partial dots summed over the four threads of a quad (which
// together hold all 256 columns of rows g and g + 8), in a fixed order that
// leaves the same sums in all four.
__device__ __forceinline__ void quad_sum(float (&head)[2][kHeadRows]) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int a = 0; a < kHeadRows; ++a) {
      head[r][a] = __fadd_rn(head[r][a], __shfl_xor_sync(0xFFFFFFFFu, head[r][a], 1));
      head[r][a] = __fadd_rn(head[r][a], __shfl_xor_sync(0xFFFFFFFFu, head[r][a], 2));
    }
}

}  // namespace
