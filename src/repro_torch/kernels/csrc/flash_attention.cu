// K7: causal, optionally sliding-window, flash attention forward, sm_90a.
//
// Replaces the Pallas TPU kernel of the JAX package's
// src/repro/kernels/flash_attention.py: `flash_attention_bhld` (body
// `_kernel`). For each batch b, query head h and row q < l_real, the
// output is softmax(q k^T * scale) v over the keys k <= q, k < l_real and,
// with a window, k > q - window, where k and v are those of KV head
// h / (H / KV): grouped-query attention is read in place, never expanded.
// q and o are (B, L, H, D), k and v (B, L, KV, D), each with its own
// strides (the merged (B*H, Lpad, D) layout is B*H batches of one head).
// Rows >= l_real are not written. The numerics are the reference's:
// scores in float32, masked scores -1e30 (never -inf, so a block with no
// valid key cannot give inf - inf), the running max, sum and accumulator
// in float32, p rounded to v's dtype before P.V, and the output divided
// by max(l, 1e-30).
//
// bf16 design (D in {16, 32, 64, 128}; D = 256 below). The TPU's sequential (B*H,
// L/bq, L/bk) grid becomes one CTA per (b, h, 128-row q tile), looping
// over only the 128-key blocks that the causal and window masks leave.
// CTAs run in groups of 16 heads, each group's tiles heaviest first: the
// group's K and V stay in L2, and the lightest tiles come last. A CTA is
// two consumer warpgroups of 64 query rows and one producer warp, one
// thread of which loads Q once and K, V block by block with TMA
// (cp.async.bulk.tensor on 4-D tensor maps over the operands' real
// strides, L's extent l_real, so the ragged edge is zero-filled by the
// hardware and a tile never crosses a batch) into a ring of as many
// stages as shared memory holds (3 at D = 128); each stage's K and V
// complete on their own mbarrier, and the consumers free the stage
// through a third. Per block a consumer warpgroup runs S = Q K^T as one
// wgmma.mma_async chain (m64n128k16, both operands read from shared
// memory through matrix descriptors whose swizzle is the tensor maps':
// 128 bytes at D >= 64, in 64-column boxes, 64 bytes at D = 32, 32 bytes
// at D = 16); the online softmax on the accumulator registers (each
// thread holds two rows, so a row's max takes two quad shuffles and its
// sum is reduced once at the end); and O += P V as a second chain, whose
// A operand is the f32 -> bf16 P fragment in registers (already wgmma's
// A layout) and whose B operand is V in its natural (key, D) layout,
// read transposed (MN-major). O stays in registers through the key loop
// and is written once. The two warpgroups take turns to issue S = Q K^T
// (a named barrier passes the turn), so one's softmax runs while the
// other's products hold the tensor cores. ptxas holds every thread to
// 168 registers (warpgroup-granular allocation at 288 threads), which
// rules out overlapping one block's softmax with the next block's
// products inside a warpgroup at 128-key blocks: the attempts spilled.
//
// D = 256 (RecurrentGemma's local attention; Tile<256>). O is then 64
// rows x 256 float32 columns, 128 registers a thread, before S and P: at
// 288 threads and 168 registers it cannot fit. So a CTA is one consumer
// warpgroup of 64 query rows and the producer warp (160 threads, up to
// 255 registers each), over 64-key blocks: S is 32 registers, P 16, and
// O is held in two parts of 128 columns, each its own m64n128k16 chain
// against V's second pair of 64-column boxes. Q (64 x 256) and each K and
// V block are 32 KB, so the ring holds 3 stages beside Q. With one
// consumer warpgroup there is no turn to pass: a block's softmax leaves
// the tensor cores idle, the price of a simple layout.
//
// float32 (the tests' and the smoke's small cases) keeps a simple
// CUDA-core kernel: one CTA of 4 warps per (b, h, 64-row q tile; 32 rows
// at D = 256, to fit shared memory), K and V copied with cp.async, a
// row-at-a-time online softmax and FMA products (no TF32: the reference's
// float32 tolerance is 2e-5).
//
// Bound on this card. 4 * (valid (q, k) pairs) * D flops at the bf16
// tensor-core rate (989 TFLOP/s dense), against Q, K, V and O each moved
// once (K and V at KV heads): at the qwen2-1.5b prefill shape (B = 8,
// H = 12, KV = 2, L = 2048, D = 128) the operations bound it, 0.104 ms
// against 0.035 ms for the bytes; at RecurrentGemma's (B = 4, H = 10,
// KV = 1, L = 4096, D = 256, window 2048) about 0.26 ms against 0.055 ms
// (chip_smoke.py computes both each run).
#include <cuda.h>  // CUtensorMap and its enums only: no driver call is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr float kNeg = -1e30f;

// Strides in elements of one operand: batch, row (L) and head.
struct Strides {
  long long b, l, h;
};

// ===================================================================== //
// bf16: TMA ring + wgmma
// ===================================================================== //
constexpr int kWgThreads = 128;
constexpr int kHeadGroup = 16;  // CTAs run in groups of this many heads

constexpr int kSmemMax = 232448;  // bytes of shared memory a CTA may use

// The bf16 kernel's tiling by head dim. D <= 128: two consumer
// warpgroups (wgmma wants them warpgroup-aligned) of 64 query rows and
// 128-key blocks. D = 256: one consumer warpgroup and 64-key blocks: its
// O accumulator alone is 128 registers a thread, and a 128-key block's S
// and P beside it would not fit in 255. Either way one producer warp
// follows the consumers. O is held in parts of at most 128 columns, one
// wgmma chain (m64n128k16 at most) each.
template <int D>
struct Tile {
  static constexpr int kWgs = D <= 128 ? 2 : 1;  // consumer warpgroups
  static constexpr int kBm = 64 * kWgs;          // query rows per CTA
  static constexpr int kBk = D <= 128 ? 128 : 64;  // keys per block
  static constexpr int kThreads = kWgs * kWgThreads + 32;
  static constexpr int kConsumerWarps = 4 * kWgs;
  static constexpr int kParts = D > 128 ? D / 128 : 1;  // O's column parts
  static constexpr int kN = D / kParts;                 // columns a part
};

// Shared memory of one CTA (byte offsets from a 1024-byte aligned base;
// every tile starts on a 1024-byte boundary, as the 128-byte swizzle
// wants). A tile of R rows x D columns is D / kCols boxes of R rows x
// kCols columns, one after the other; a box row is kSwizzle bytes. The
// K/V ring has as many stages as fit, up to 4 (3 at D = 128 and at
// D = 256, whose Q tile and K, V blocks are 32 KB each).
template <int D>
struct Smem {
  static constexpr int kCols = D < 64 ? D : 64;
  static constexpr int kSwizzle = 2 * kCols;  // 32, 64 or 128 bytes
  static constexpr int kBoxes = D / kCols;
  static constexpr int kQBytes = Tile<D>::kBm * D * 2;
  static constexpr int kKVBytes = Tile<D>::kBk * D * 2;
  static constexpr int kFit = (kSmemMax - 2048 - kQBytes) / (2 * kKVBytes);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;  // + stage * kKVBytes
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBar = kV + kStages * kKVBytes;  // barriers, then
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages) + 1024;  // slack
  static_assert(kStages >= 2 && kBytes <= kSmemMax, "shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle mode (1: 128 B, 2: 64 B, 3: 32 B)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, int swizzle) {
  const uint64_t mode = swizzle == 128 ? 1 : swizzle == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (mode << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// wait until the barrier's phase of this parity has completed; a phase
// that never completes (a missed arrival) traps, failing the launch,
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one TMA box (col, row, head, batch) of a 4-D tensor map into shared
// memory, completing `bytes` of the barrier's transaction count
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(head), "r"(batch)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most n of this thread's committed wgmma groups are
// pending (groups complete in order)
template <int n>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(n) : "memory");
}
// keep the compiler from moving accesses of wgmma's registers across the
// asynchronous instructions, or reusing them while a wgmma reads them
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D (64 x N, float32) = A (64 x 16) B (16 x N) [+ D]: m64nNk16, bf16.
// wgmma_ss: A and B from shared memory, both K-major; D is overwritten
// when scale_d is 0. wgmma_rs: A from registers, B MN-major (transposed),
// accumulating.
#define F8(i)                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : F8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
#undef F8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x (MUFU.EX2: relative error 2^-22, far below p's bf16 rounding, 2^-8)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// mbarriers: q, then full_k[n], full_v[n], empty[n] for a ring of n stages
struct Bars {
  uint32_t q;
  int n;
  __device__ __forceinline__ uint32_t full_k(int s) const {
    return q + 8 * (1 + s);
  }
  __device__ __forceinline__ uint32_t full_v(int s) const {
    return q + 8 * (1 + n + s);
  }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return q + 8 * (1 + 2 * n + s);
  }
};

// named barriers (0 is __syncthreads) that hand the turn to issue wgmma
// from one consumer warpgroup to the other
constexpr int kTurnBarrier = 1;  // + consumer warpgroup
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(kTurnBarrier + wg),
               "n"(2 * kWgThreads)
               : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(kTurnBarrier + (1 - wg)),
               "n"(2 * kWgThreads)
               : "memory");
}

// S = Q K^T of one warpgroup's 64 rows against a key block: D / 16
// chained wgmmas, both operands K-major in shared memory
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[Tile<D>::kBk / 2],
                                         uint32_t q_tile, uint32_t k_tile) {
  using S = Smem<D>;
  using T = Tile<D>;
  constexpr int kSw = S::kSwizzle;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int box = 16 * kk / S::kCols;
    const int col_bytes = 2 * (16 * kk % S::kCols);
    wgmma_ss(s,
             desc(q_tile + box * T::kBm * kSw + col_bytes, 16, 8 * kSw, kSw),
             desc(k_tile + box * T::kBk * kSw + col_bytes, 16, 8 * kSw, kSw),
             kk > 0);
  }
}

// O += P V: per column part of O, kBk / 16 chained wgmmas, P from
// registers, V (key, D) read as the MN-major B operand, its 64-column
// boxes kSwizzle * kBk apart (a part of 128 columns starts 2 boxes on)
template <int D>
__device__ __forceinline__ void issue_pv(
    float (&o)[Tile<D>::kParts][Tile<D>::kN / 2],
    const uint32_t (&p)[Tile<D>::kBk / 16][4], uint32_t v_tile) {
  using T = Tile<D>;
  constexpr int kSw = Smem<D>::kSwizzle;
  constexpr int kPartBytes = T::kN / Smem<D>::kCols * T::kBk * kSw;
#pragma unroll
  for (int part = 0; part < T::kParts; ++part)
#pragma unroll
    for (int j = 0; j < T::kBk / 16; ++j)
      wgmma_rs(o[part], p[j],
               desc(v_tile + part * kPartBytes + j * 16 * kSw, T::kBk * kSw,
                    8 * kSw, kSw));
}

// The online softmax of one block on the accumulator registers: the
// running max m (log2 domain) and the thread's share of the running sum
// l are updated, p = exp2(s * scale - m) is packed to bf16 as it is
// made (the accumulator's (row, 8-column) fragment is already the A
// operand's), and alpha is the factor by which the earlier blocks'
// accumulator shrinks. kMasked: the block holds a key some row must not
// see, whose score becomes -1e30 (the reference's); else the max is
// taken on the raw scores and the scale folded into one FFMA.
template <bool kMasked, int kBk>
__device__ __forceinline__ void softmax_block(float (&s)[kBk / 2],
                                              uint32_t (&p)[kBk / 16][4],
                                              float (&m)[2], float (&l)[2],
                                              float (&alpha)[2], int r0,
                                              int c2, int k0, int l_real,
                                              int window, float scale_log2) {
  float mx[2];
  if (kMasked) {
    mx[0] = m[0];
    mx[1] = m[1];
#pragma unroll
    for (int i = 0; i < kBk / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = r0 + 8 * (e / 2), kpos = k0 + 8 * i + c2 + e % 2;
        const bool ok = kpos <= qpos && kpos < l_real &&
                        (window <= 0 || kpos > qpos - window);
        const float x = ok ? s[4 * i + e] * scale_log2 : kNeg;
        s[4 * i + e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }
  } else {
    mx[0] = s[0];
    mx[1] = s[2];
#pragma unroll
    for (int i = 0; i < kBk / 2; ++i)
      mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], s[i]);
    mx[0] = fmaxf(m[0], mx[0] * scale_log2);
    mx[1] = fmaxf(m[1], mx[1] * scale_log2);
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = quad_max(mx[r]);
    alpha[r] = ex2(m[r] - mx[r]);
    m[r] = mx[r];
  }
#pragma unroll
  for (int i = 0; i < kBk / 8; ++i) {
    float e4[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s[4 * i + e], mi = m[e / 2];
      e4[e] = kMasked ? ex2(x - mi) : ex2(fmaf(x, scale_log2, -mi));
      sum[e / 2] += e4[e];
    }
    p[i / 2][2 * (i % 2)] = pack_bf16(e4[0], e4[1]);
    p[i / 2][2 * (i % 2) + 1] = pack_bf16(e4[2], e4[3]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
}

// One consumer warpgroup: 64 query rows from q_lo, the key blocks
// kb0 .. kb0 + nblk - 1 of kBk keys. Thread (warp, lane) holds rows
// r0 = q_lo + 16 warp + lane / 4 and r0 + 8; of each 8 columns of an
// accumulator it holds 2 (lane % 4) and the next, at indices 4 i + {0, 1}
// (row r0) and 4 i + {2, 3} (row r0 + 8).
//
// The blocks this warpgroup skips (every key masked for its rows) are a
// prefix (before the window) and a suffix (past the diagonal). With two
// consumer warpgroups (D <= 128) they take turns to issue S = Q K^T (a
// named barrier passes the turn once per block), so one's softmax runs
// while the other's products hold the tensor cores. Each wgmma chain is
// issued, committed and waited for inside one branch: ptxas serialises
// chains whose issue and wait lie in different branches.
template <int D>
__device__ __forceinline__ void consume(uint32_t base, int wg, int q_lo,
                                        int kb0, int nblk, int l_real,
                                        int window, float scale_log2,
                                        bf16* __restrict__ o_row0,
                                        long long sol) {
  using S = Smem<D>;
  using T = Tile<D>;
  constexpr int kBk = T::kBk;
  constexpr bool kTurns = T::kWgs == 2;
  const Bars bars{base + S::kBar, S::kStages};
  const uint32_t q_tile = base + S::kQ + wg * 64 * S::kSwizzle;
  const int tid = threadIdx.x % kWgThreads, warp = tid / 32, lane = tid % 32;
  const int r0 = q_lo + 16 * warp + lane / 4;
  const int c2 = 2 * (lane % 4);
  const int q_hi = min(q_lo + 63, l_real - 1);  // last real row
  // the blocks [first, last) hold a key some row of this warpgroup keeps
  int first = 0, last = nblk;
  if (q_lo > q_hi) {
    first = last = nblk;
  } else {
    while (first < nblk && window > 0 &&
           (kb0 + first) * kBk + kBk - 1 <= q_lo - window)
      ++first;
    while (last > first && (kb0 + last - 1) * kBk > q_hi) --last;
  }

  float o[T::kParts][T::kN / 2];
#pragma unroll
  for (int part = 0; part < T::kParts; ++part)
#pragma unroll
    for (int i = 0; i < T::kN / 2; ++i) o[part][i] = 0.0f;
  // running max (log2 domain) and this thread's share of the running sum
  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};

  if (kTurns && wg == 1) turn_pass(wg);  // warpgroup 0 issues first
  mbar_wait(bars.q, 0);
  for (int it = 0; it < nblk; ++it) {
    const int stage = it % S::kStages;
    const uint32_t parity = (it / S::kStages) & 1;
    const int k0 = (kb0 + it) * kBk;
    // every thread waits on both barriers of every block, used or not,
    // so that its parities stay in step with the ring; the turn passes
    // once per block (warpgroup 1's last pass would have no taker)
    mbar_wait(bars.full_k(stage), parity);
    const bool pass = kTurns && (wg == 0 || it + 1 < nblk);
    if (kTurns) turn_wait(wg);
    if (it >= first && it < last) {
      // ---- S = Q K^T -------------------------------------------------
      float s[kBk / 2];
      wgmma_fence();
      issue_qk<D>(s, q_tile, base + S::kK + stage * S::kKVBytes);
      wgmma_commit();
      if (pass) turn_pass(wg);
      wgmma_wait<0>();
      fence_regs(s);
      // ---- the online softmax, in registers; rescale O -----------------
      const bool masked = k0 + kBk - 1 > q_lo || k0 + kBk > l_real ||
                          (window > 0 && k0 <= q_lo + 63 - window);
      float alpha[2];
      uint32_t p[kBk / 16][4];
      if (masked)
        softmax_block<true, kBk>(s, p, m, l, alpha, r0, c2, k0, l_real,
                                 window, scale_log2);
      else
        softmax_block<false, kBk>(s, p, m, l, alpha, r0, c2, k0, l_real,
                                  window, scale_log2);
#pragma unroll
      for (int part = 0; part < T::kParts; ++part)
#pragma unroll
        for (int i = 0; i < T::kN / 2; ++i) o[part][i] *= alpha[(i % 4) / 2];
      // ---- O += P V --------------------------------------------------
      mbar_wait(bars.full_v(stage), parity);
#pragma unroll
      for (int part = 0; part < T::kParts; ++part) fence_regs(o[part]);
      wgmma_fence();
      issue_pv<D>(o, p, base + S::kV + stage * S::kKVBytes);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int part = 0; part < T::kParts; ++part) fence_regs(o[part]);
      fence_regs(p);
    } else {
      if (pass) turn_pass(wg);
      mbar_wait(bars.full_v(stage), parity);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars.empty(stage));
  }

  // ---- epilogue: O / max(l, 1e-30), rows < l_real --------------------
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    const float den = fmaxf(quad_sum(l[r]), 1e-30f);
    if (row > q_hi) continue;
    bf16* dst = o_row0 + static_cast<long long>(row) * sol + c2;
#pragma unroll
    for (int part = 0; part < T::kParts; ++part)
#pragma unroll
      for (int i = 0; i < T::kN / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(dst + part * T::kN + 8 * i) =
            __floats2bfloat162_rn(o[part][4 * i + 2 * r] / den,
                                  o[part][4 * i + 2 * r + 1] / den);
  }
}

template <int D>
__global__ void __launch_bounds__(Tile<D>::kThreads, 1)
flash_attention_wgmma(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      bf16* __restrict__ o, Strides so, int n_heads,
                      int group_size, int l_real, int window,
                      float scale_log2) {
  using S = Smem<D>;
  using T = Tile<D>;
  constexpr int kSw = S::kSwizzle;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const Bars bars{base + S::kBar, S::kStages};

  // CTAs in groups of kHeadGroup (batch, head) pairs, each group's q
  // tiles heaviest first across its heads: the group's K and V stay in
  // L2 while it runs, and the lightest tiles come last
  const int n_tiles = (l_real + T::kBm - 1) / T::kBm;
  const int n_bh = gridDim.x / n_tiles;
  const int group = blockIdx.x / (kHeadGroup * n_tiles);
  const int in_group = min(kHeadGroup, n_bh - group * kHeadGroup);
  const int rank = blockIdx.x - group * kHeadGroup * n_tiles;
  const int bh = group * kHeadGroup + rank % in_group;
  const int b = bh / n_heads, h = bh % n_heads;
  const int q0 = (n_tiles - 1 - rank / in_group) * T::kBm;
  const int q_last = min(q0 + T::kBm - 1, l_real - 1);
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kb0 = k_first / T::kBk, nblk = q_last / T::kBk - kb0 + 1;

  if (threadIdx.x == 0) {
    mbar_init(bars.q, 1);
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(bars.full_k(s), 1);
      mbar_init(bars.full_v(s), 1);
      mbar_init(bars.empty(s), T::kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWgThreads;
  if (wg < T::kWgs) {
    consume<D>(base, wg, q0 + 64 * wg, kb0, nblk, l_real, window,
               scale_log2, o + b * so.b + h * so.h, so.l);
  } else if (threadIdx.x == T::kWgs * kWgThreads) {
    // ---- producer: one thread issues every copy ----------------------
    const int kvh = h / group_size;
    mbar_expect_tx(bars.q, S::kQBytes);
    for (int c = 0; c < S::kBoxes; ++c)
      tma_load(base + S::kQ + c * T::kBm * kSw, &tq, bars.q, c * S::kCols,
               q0, h, b);
    for (int it = 0; it < nblk; ++it) {
      const int stage = it % S::kStages;
      if (it >= S::kStages)
        mbar_wait(bars.empty(stage), (it / S::kStages - 1) & 1);
      const int k0 = (kb0 + it) * T::kBk;
      const uint32_t off = stage * S::kKVBytes;
      mbar_expect_tx(bars.full_k(stage), S::kKVBytes);
      for (int c = 0; c < S::kBoxes; ++c)
        tma_load(base + S::kK + off + c * T::kBk * kSw, &tk,
                 bars.full_k(stage), c * S::kCols, k0, kvh, b);
      mbar_expect_tx(bars.full_v(stage), S::kKVBytes);
      for (int c = 0; c < S::kBoxes; ++c)
        tma_load(base + S::kV + off + c * T::kBk * kSw, &tv,
                 bars.full_v(stage), c * S::kCols, k0, kvh, b);
    }
  }
}

// ===================================================================== //
// float32: CUDA-core FMAs, cp.async
// ===================================================================== //
constexpr int kThreadsF32 = 128;  // 4 warps
constexpr int kBkF32 = 64;        // keys per block

// query rows per CTA: 64 (16 a warp), 32 at D = 256, where 64 rows of Q
// and O beside the K and V blocks would pass the shared memory
__host__ __device__ constexpr int rows_f32(int d) { return d <= 128 ? 64 : 32; }

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) / 128 * 128;
}

// Shared memory of the float32 kernel: byte offsets (128-byte aligned)
// and row strides in elements, each row padded by 16 bytes; bq query rows.
struct LayoutF32 {
  int bq, ldt, lds, ldo;
  size_t q, k, v, s, o, m, l, a, total;
};

__host__ __device__ LayoutF32 layout_f32(int d) {
  LayoutF32 L;
  L.bq = rows_f32(d);
  L.ldt = d + 4;       // Q, K, V tiles
  L.lds = kBkF32 + 4;  // scores, then P
  L.ldo = d + 4;       // O
  size_t off = 0;
  L.q = off;
  off = align128(off + 4 * L.bq * L.ldt);
  L.k = off;
  off = align128(off + 4 * kBkF32 * L.ldt);
  L.v = off;
  off = align128(off + 4 * kBkF32 * L.ldt);
  L.s = off;
  off = align128(off + 4 * L.bq * L.lds);
  L.o = off;
  off = align128(off + 4 * L.bq * L.ldo);
  L.m = off;
  off = align128(off + 4 * L.bq);
  L.l = off;
  off = align128(off + 4 * L.bq);
  L.a = off;
  off = align128(off + 4 * L.bq);
  L.total = off;
  return L;
}

// rows [row0, row0 + rows) of a strided (rows, d) matrix into a shared
// tile of row stride ld with cp.async, 16 bytes a copy; rows >= lim are
// zero-filled (source size 0). Commits one group.
__device__ void load_tile_f32(float* dst, int ld, const float* __restrict__ src,
                              long long row_stride, int row0, int lim, int d,
                              int rows) {
  const int chunks = d / 4;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += kThreadsF32) {
    const int r = idx / chunks, c = idx - r * chunks;
    const bool ok = row0 + r < lim;
    const float* g = ok ? src + (row0 + r) * row_stride + c * 4 : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst + r * ld + c * 4)),
                 "l"(g), "r"(ok ? 16 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

__global__ void __launch_bounds__(kThreadsF32)
flash_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    Strides sq, Strides sk, Strides sv, Strides so,
                    int n_heads, int group, int d, int l_real, int window,
                    float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const LayoutF32 L = layout_f32(d);
  float* tq = reinterpret_cast<float*>(smem + L.q);
  float* tk = reinterpret_cast<float*>(smem + L.k);
  float* tv = reinterpret_cast<float*>(smem + L.v);
  float* ts = reinterpret_cast<float*>(smem + L.s);
  float* to = reinterpret_cast<float*>(smem + L.o);
  float* tm = reinterpret_cast<float*>(smem + L.m);
  float* tl = reinterpret_cast<float*>(smem + L.l);
  float* ta = reinterpret_cast<float*>(smem + L.a);

  const int b = blockIdx.x / n_heads, h = blockIdx.x % n_heads;
  const int kvh = h / group;
  q += b * sq.b + h * sq.h;
  k += b * sk.b + kvh * sk.h;
  v += b * sv.b + kvh * sv.h;
  o += b * so.b + h * so.h;
  const int bq = L.bq, rw = bq / 4;  // query rows: per CTA, per warp
  const int q0 = (gridDim.y - 1 - blockIdx.y) * bq;  // heaviest first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_tile_f32(tq, L.ldt, q, sq.l, q0, l_real, d, bq);
  for (int i = threadIdx.x; i < bq * L.ldo; i += kThreadsF32) to[i] = 0.0f;
  if (threadIdx.x < bq) {
    tm[threadIdx.x] = kNeg;
    tl[threadIdx.x] = 0.0f;
  }
  const int q_last = min(q0 + bq - 1, l_real - 1);
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int kb = k_first / kBkF32; kb <= q_last / kBkF32; ++kb) {
    const int k0 = kb * kBkF32;
    __syncthreads();  // the last block's K, V are read; the init is seen
    load_tile_f32(tk, L.ldt, k, sk.l, k0, l_real, d, kBkF32);
    load_tile_f32(tv, L.ldt, v, sv.l, k0, l_real, d, kBkF32);
    cp_async_wait<1>();  // Q and K have landed; V may still be in flight
    __syncthreads();
    // scores of the warp's rw rows, two keys a lane
    for (int r = 0; r < rw; ++r) {
      const float* qr = tq + (warp * rw + r) * L.ldt;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float* kr = tk + (lane + 32 * e) * L.ldt;
        float acc = 0.0f;
        for (int c = 0; c < d; ++c) acc = fmaf(qr[c], kr[c], acc);
        ts[(warp * rw + r) * L.lds + lane + 32 * e] = acc;
      }
    }
    __syncwarp();
    // the online softmax, a row at a time; P overwrites the scores
    for (int r = 0; r < rw; ++r) {
      const int row = warp * rw + r, qpos = q0 + row;
      float x[2], mx = kNeg;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = lane + 32 * e, kpos = k0 + col;
        const bool ok = kpos <= qpos && kpos < l_real &&
                        (window <= 0 || kpos > qpos - window);
        x[e] = ok ? ts[row * L.lds + col] * scale : kNeg;
        mx = fmaxf(mx, x[e]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = tm[row];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = expf(x[e] - m_new);
        sum += p;
        ts[row * L.lds + lane + 32 * e] = p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        tl[row] = tl[row] * alpha + sum;
        tm[row] = m_new;
        ta[row] = alpha;
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // V has landed (and every warp's P, alpha are its own)
    // O = O * alpha + P V on the warp's rw rows
    for (int idx = lane; idx < rw * d; idx += 32) {
      const int r = warp * rw + idx / d, c = idx % d;
      float acc = to[r * L.ldo + c] * ta[r];
      const float* pr = ts + r * L.lds;
      for (int j = 0; j < kBkF32; ++j)
        acc = fmaf(pr[j], tv[j * L.ldt + c], acc);
      to[r * L.ldo + c] = acc;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < bq * d; idx += kThreadsF32) {
    const int r = idx / d, c = idx - r * d;
    if (q0 + r < l_real)
      o[(q0 + r) * so.l + c] = to[r * L.ldo + c] / fmaxf(tl[r], 1e-30f);
  }
}

// ===================================================================== //
// host side
// ===================================================================== //
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so
// the library needs no -lcuda; null if the driver does not offer it
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 tensor map over (D, L = l_real, heads, batch) with the operand's
// strides; boxes of `cols` x `rows`, swizzled by 2 * cols bytes
bool make_map(CUtensorMap* map, const void* ptr, Strides st, int d,
              int l_real, int heads, int batch, int cols, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(l_real),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.l) * 2,
                                 static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                 : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                              : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                const Strides* st, int batch, int l_real, int n_heads,
                int n_kv, int window, float scale, cudaStream_t stream) {
  using S = Smem<D>;
  using T = Tile<D>;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, st[0], D, l_real, n_heads, batch, S::kCols,
                T::kBm) ||
      !make_map(&tk, k, st[1], D, l_real, n_kv, batch, S::kCols, T::kBk) ||
      !make_map(&tv, v, st[2], D, l_real, n_kv, batch, S::kCols, T::kBk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid =
      static_cast<long long>(batch) * n_heads *
      ((l_real + T::kBm - 1) / T::kBm);
  if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  flash_attention_wgmma<D><<<static_cast<unsigned>(grid), T::kThreads,
                             S::kBytes, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), st[3], n_heads, n_heads / n_kv,
      l_real, window, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* q, const void* k, const void* v, void* o,
               const Strides* st, int batch, int l_real, int n_heads,
               int n_kv, int d, int window, float scale,
               cudaStream_t stream) {
  const size_t bytes = layout_f32(d).total;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (l_real + rows_f32(d) - 1) / rows_f32(d);
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(batch * n_heads, tiles);
  flash_attention_f32<<<grid, kThreadsF32, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), st[0], st[1],
      st[2], st[3], n_heads, n_heads / n_kv, d, l_real, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). q and o are (batch, L, n_heads,
// d), k and v (batch, L, n_kv, d), n_kv dividing n_heads; `strides` holds
// 12 element strides, (batch, row, head) for q, k, v and o in turn, each a
// multiple of 16 bytes, the last dimension contiguous, the pointers 16-byte
// aligned. Rows >= l_real are neither read nor written. bf16 (is_bf16 = 1)
// or float32; window <= 0 means none. Launches on `stream` without
// synchronising and returns the launch's cudaError_t (0 on success); a
// head dim or head count the kernel does not take, or a tensor map the
// driver refuses, returns cudaErrorInvalidValue and launches nothing.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const long long* strides, int batch,
                                      int l_real, int n_heads, int n_kv,
                                      int d, int window, float scale,
                                      int is_bf16, void* stream) {
  if ((d != 16 && d != 32 && d != 64 && d != 128 && d != 256) || n_kv <= 0 ||
      n_heads % n_kv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0 || n_heads <= 0 || l_real <= 0) return 0;
  const Strides st[4] = {{strides[0], strides[1], strides[2]},
                         {strides[3], strides[4], strides[5]},
                         {strides[6], strides[7], strides[8]},
                         {strides[9], strides[10], strides[11]}};
  auto s = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return launch_f32(q, k, v, o, st, batch, l_real, n_heads, n_kv, d, window,
                      scale, s);
  switch (d) {
    case 16:
      return launch_bf16<16>(q, k, v, o, st, batch, l_real, n_heads, n_kv,
                             window, scale, s);
    case 32:
      return launch_bf16<32>(q, k, v, o, st, batch, l_real, n_heads, n_kv,
                             window, scale, s);
    case 64:
      return launch_bf16<64>(q, k, v, o, st, batch, l_real, n_heads, n_kv,
                             window, scale, s);
    case 128:
      return launch_bf16<128>(q, k, v, o, st, batch, l_real, n_heads, n_kv,
                              window, scale, s);
    default:
      return launch_bf16<256>(q, k, v, o, st, batch, l_real, n_heads, n_kv,
                              window, scale, s);
  }
}
