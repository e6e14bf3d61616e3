// K4 / K5: the one-hot membership-product join over (live) tiles, sm_90a.
//
// Replaces the Pallas TPU kernels of the JAX package's
// src/repro/kernels/onehot_join.py: `onehot_join_live_tiled` (K4, body
// `_live_kernel`) and `onehot_join_tiled` (K5, body `_kernel`). They
// compute what K2 / K3 compute (bitmap_join.cu): per (TM, TN) tile, the
// intersection sizes, then the measure predicate and the [lo, hi) window;
// K4 over the live tiles with a mask and an exact count per tile, K5 over
// every tile into the dense mask, skipped tiles all False. The intersection
// sizes come from a matrix product instead of popcounts: the TPU kernel
// unpacks TW words into 0/1 membership matrices and accumulates
// F = B_R B_S^T on its matrix unit in bf16 -> f32. Here the product runs on
// the int8 tensor cores with int32 accumulators, exact at any size (no
// 2^24 limit); bit b of word k is universe column 32 k + b.
//
// Bound on this card. 2 int8 operations per in-window cell and universe
// bit at the int8 tensor-core rate (1 979 TOP/s dense), against each
// bitmap word read once and each mask byte written once; on the
// livej-shaped join's 1024-row blocks the operations bound it
// (chip_smoke.py computes both for each run). The products are not what
// costs: turning bits into int8 operands is. Expanded, a 128-bit stage of
// a (128, 256) tile is 48 KB of shared-memory stores for 1 024 clocks of
// tensor-core work, which then reads 80 KB of it; and the block's rows
// come in input order, so nearly every tile is live and most of its
// cells lie outside the rows' windows.
//
// Design. One CTA per Pallas tile (1 <= TM <= 128 rows, TN in {128, 256}
// columns): one expander warpgroup, and one or two consumer warpgroups
// of 64 rows (rows past TM are never written and their results never
// read).
//   * The expander's thread 0 brings the tile's words in by TMA, 16 words
//     (4 stages) a row at a time, into a ring of 3 packed groups (64-byte
//     swizzled rows, words past W zero-filled; one mbarrier per group).
//     Each expander thread owns A row tid and B rows tid + 128 i. Per
//     group the warps vote, and a named barrier gathers the votes: a
//     128-bit stage in which the tile's R words or its S words are all
//     zero adds nothing to any count and is skipped (on the livej block
//     about half of them). The barrier also frees the packed slot, which
//     thread 0 refills at once.
//   * A needed stage is expanded once per CTA, 4 bits to 4 bytes with one
//     multiply (((x >> 4g) & 0xF) * 0x00204081 & 0x01010101), with 16-byte
//     stores into a ring of 3 int8 stages (48 KB each at the default
//     tile) in the layout the wgmma descriptors read: K-major rows of 128
//     bytes, 128-byte swizzle. A warp whose 32 rows are all zero in the
//     stage skips the arithmetic, and the stores too when its copy of
//     those rows in the slot is zero already. After a proxy fence each
//     expander warp arrives on the stage's mbarrier; a flag beside it
//     says "multiply" or "end".
//   * Each consumer warpgroup issues four wgmma.mma_async m64nTNk32
//     s32.s8.s8 per stage into int32 accumulators in registers, keeps one
//     group in flight, and frees a stage through a second mbarrier once
//     the group that read it has completed.
//   * The epilogue runs from the accumulators (thread (warp w, lane l) of
//     a warpgroup holds rows 16 w + l/4 and + 8, columns 2 (l % 4) +
//     {0, 1} of every 8): the window, `qualify` (qualify.cuh), and two
//     mask bytes a store; K4's count is a reduction in the CTA and one
//     plain store per tile. Tiles that K5's skip mask drops, or whose
//     rows' windows all miss the tile's columns, run no products and
//     write zeros.
//   * CTAs take the tiles column tile by column tile (K5 walks a
//     column-major raster, K4 the `order` its wrapper sorts), so each S
//     word comes from device memory about once a block while the block's
//     R words stay in L2.
#include <cuda.h>  // CUtensorMap and its enums only: no driver call is linked
#include <cuda_runtime.h>
#include <stdint.h>

#include "qualify.cuh"

namespace {

constexpr int kWg = 128;          // threads of a warpgroup
constexpr int kRowBytes = 128;    // a stage row: 128 universe bits as int8
constexpr int kStageWords = 4;    // bitmap words a stage covers
constexpr int kGroupStages = 4;   // stages a packed group of words covers
constexpr int kGroupWords = kGroupStages * kStageWords;  // 16: 64 bytes
constexpr int kMaxStages = 4;
constexpr int kPackSlots = 3;     // packed groups in flight
constexpr int kSmemMax = 232448;  // bytes of shared memory a CTA may use
constexpr int kStatic = 2048;     // room left for the static shared memory

// One configuration: kCons consumer warpgroups (64 rows each), kTN columns.
// Dynamic shared memory: the ring of expanded int8 stages, then the ring
// of packed word groups that TMA fills (A rows, then B rows, 64 bytes a
// row, 64-byte swizzle).
template <int kCons, int kTN>
struct Cfg {
  static constexpr int kThreads = (kCons + 1) * kWg;
  static constexpr int kARows = 64 * kCons;
  static constexpr int kABytes = kARows * kRowBytes;
  static constexpr int kStageBytes = (kARows + kTN) * kRowBytes;
  static constexpr int kPackA = kARows * kGroupWords * 4;
  static constexpr int kPackBytes = (kARows + kTN) * kGroupWords * 4;
  static constexpr int kFit =
      (kSmemMax - kStatic - 1024 - kPackSlots * kPackBytes) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kPack = kStages * kStageBytes;  // packed ring offset
  static constexpr int kBytes = kPack + kPackSlots * kPackBytes + 1024;
  static constexpr int kBRows = kTN / kWg;  // B rows an expander thread owns
  static_assert(kStages >= 2, "shared memory");
};

struct Args {
  const int* ti;      // K4: live tile coordinates
  const int* tj;
  const int* order;   // K4: CTA b takes live tile order[b]
  const int* skip;    // K5: (m_tiles, n_tiles)
  const uint32_t* r_bm;
  const uint32_t* s_bm;
  const int* rsz;
  const int* ssz;
  const int* lo;
  const int* hi;
  uint8_t* out;       // K5: (M, N); K4: (L, TM, TN)
  int* counts;        // K4: (L, 1)
  int m_tiles, n_tiles, n_cols, words, tm, measure, p, q;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma matrix descriptor of a K-major operand in 128-byte swizzled rows:
// start address, leading byte offset (unused by this layout: 16) and the
// stride between 8-row groups (1 024 bytes), all in 16-byte units
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
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

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int n>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(n) : "memory");
}
// keep the compiler from touching the accumulators while a wgmma owns them
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D (64 x N, int32) += A (64 x 32) B (32 x N): m64nNk32, s8 x s8, both
// operands K-major in shared memory
#define R8(i)                                                            \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),            \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[64], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : R8(0), R8(8), R8(16), R8(24), R8(32), R8(40), R8(48), R8(56)
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[128], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : R8(0), R8(8), R8(16), R8(24), R8(32), R8(40), R8(48), R8(56),
        R8(64), R8(72), R8(80), R8(88), R8(96), R8(104), R8(112), R8(120)
      : "l"(a), "l"(b), "r"(1));
}
#undef R8

// one TMA box (word, row) of a 2-D tensor map of bitmap words into shared
// memory, completing its bytes on the barrier's transaction count
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int word, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(word), "r"(row)
      : "memory");
}

// stage s (words 4 s .. 4 s + 3) of row r of a packed group: 64-byte rows
// in TMA's 64-byte swizzle (16-byte chunk s of row r at s ^ (r / 2 % 4)).
// A plain load, so that the compiler batches a group's loads.
__device__ __forceinline__ uint4 packed_stage(const unsigned char* region,
                                              int r, int s) {
  return *reinterpret_cast<const uint4*>(region + 64 * r +
                                         ((s ^ ((r >> 1) & 3)) << 4));
}

__device__ __forceinline__ bool any_word(uint4 x) {
  return (x.x | x.y | x.z | x.w) != 0;
}

// bits 4g .. 4g + 3 of x -> four 0/1 bytes
__device__ __forceinline__ uint32_t spread4(uint32_t x, int g) {
  return ((x >> (4 * g)) & 0xFu) * 0x00204081u & 0x01010101u;
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint32_t a,
                                             uint32_t b, uint32_t c,
                                             uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

// one stage of row r (4 words, 128 universe bits) as 128 int8 bytes: word
// w is 16-byte chunks 2 w and 2 w + 1 of the row, swizzled (chunk c of row
// r lives at chunk c ^ (r % 8); regions are 1 024-byte aligned)
__device__ __forceinline__ void expand_row(uint32_t region, int r, uint4 x) {
  const uint32_t row = region + r * kRowBytes;
  const int sw = r & 7;
  const uint32_t words[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const uint32_t v = words[w];
    st_shared_v4(row + (((2 * w) ^ sw) << 4), spread4(v, 0), spread4(v, 1),
                 spread4(v, 2), spread4(v, 3));
    st_shared_v4(row + (((2 * w + 1) ^ sw) << 4), spread4(v, 4),
                 spread4(v, 5), spread4(v, 6), spread4(v, 7));
  }
}

// This thread's rows of one packed group: A row tid (zero past TM) and B
// rows tid + 128 i, each as its 4 stages of 4 words
template <int kCons, int kTN>
__device__ __forceinline__ void read_group(
    uint4 (&xa)[kGroupStages],
    uint4 (&xb)[Cfg<kCons, kTN>::kBRows][kGroupStages],
    const unsigned char* src, int tid, int tm) {
  using C = Cfg<kCons, kTN>;
#pragma unroll
  for (int st = 0; st < kGroupStages; ++st) {
    xa[st] = tid < tm ? packed_stage(src, tid, st) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int i = 0; i < C::kBRows; ++i)
      xb[i][st] = packed_stage(src + C::kPackA, tid + kWg * i, st);
  }
}

// One stage of this warp's 32 rows (row r for this thread, `mine` if it
// is a real row): expanded, unless all 32 are zero words; then zeros are
// stored only if the slot's copy of these rows is not zero already (bit
// `bit` of the warp-uniform `zeroed`).
__device__ __forceinline__ void expand_rows(uint32_t region, int r, uint4 x,
                                            bool mine, uint32_t& zeroed,
                                            uint32_t bit) {
  if (__any_sync(0xffffffffu, mine && any_word(x))) {
    if (mine) expand_row(region, r, x);
    zeroed &= ~bit;
  } else if ((zeroed & bit) == 0) {
    if (mine) expand_row(region, r, make_uint4(0, 0, 0, 0));
    zeroed |= bit;
  }
}

// one thread: group g of the tile's words (R rows row0 .., S rows col0 ..,
// words 16 g .. 16 g + 15) by TMA into its packed slot, completing `tx`
// bytes on the slot's barrier
template <int kCons, int kTN>
__device__ __forceinline__ void load_group(uint32_t pack, uint32_t pfull0,
                                           const CUtensorMap* tr,
                                           const CUtensorMap* ts, int g,
                                           int row0, int col0, uint32_t tx) {
  using C = Cfg<kCons, kTN>;
  const int slot = g % kPackSlots;
  const uint32_t dst = pack + slot * C::kPackBytes;
  const uint32_t bar = pfull0 + 8 * slot;
  mbar_expect_tx(bar, tx);
  tma_load(dst, tr, bar, g * kGroupWords, row0);
  tma_load(dst + C::kPackA, ts, bar, g * kGroupWords, col0);
}

template <bool kLive, int kCons, int kTN>
__global__ void __launch_bounds__(Cfg<kCons, kTN>::kThreads, 1)
onehot_join_kernel(const __grid_constant__ CUtensorMap tr,
                   const __grid_constant__ CUtensorMap ts, const Args a) {
  using C = Cfg<kCons, kTN>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int s_ssz[kTN];
  __shared__ int s_part[4 * kCons];  // per consumer warp
  __shared__ int s_lo, s_hi;
  __shared__ int s_flag[kMaxStages];    // 1: a stage to multiply, 0: end
  __shared__ int s_vote[2][4];          // expander warps' votes, by parity
  __shared__ __align__(8) uint64_t s_bars[2 * kMaxStages + kPackSlots];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const unsigned char* ring_ptr = smem_raw + (ring - smem_u32(smem_raw));
  const uint32_t full0 = smem_u32(s_bars), empty0 = full0 + 8 * kMaxStages;
  const uint32_t pfull0 = empty0 + 8 * kMaxStages;

  int tile, tile_i, tile_j;
  if (kLive) {
    tile = a.order[blockIdx.x];
    tile_i = a.ti[tile];
    tile_j = a.tj[tile];
  } else {  // column-major raster: a column tile's rows run together
    tile_j = blockIdx.x / a.m_tiles;
    tile_i = blockIdx.x % a.m_tiles;
    tile = tile_i * a.n_tiles + tile_j;
  }
  const int tm = a.tm;
  const int row0 = tile_i * tm, col0 = tile_j * kTN;

  if (threadIdx.x == 0) {
    s_lo = 0x7fffffff;
    s_hi = -1;
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full0 + 8 * s, kWg / 32);     // every expander warp
      mbar_init(empty0 + 8 * s, 4 * kCons);   // every consumer warp
    }
    for (int s = 0; s < kPackSlots; ++s)
      mbar_init(pfull0 + 8 * s, 1);           // TMA's bytes
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int c = threadIdx.x; c < kTN; c += C::kThreads)
    s_ssz[c] = a.ssz[col0 + c];
  __syncthreads();
  if (threadIdx.x < tm) {
    atomicMin(&s_lo, a.lo[row0 + threadIdx.x]);
    atomicMax(&s_hi, a.hi[row0 + threadIdx.x]);
  }
  __syncthreads();
  const bool live = (kLive || a.skip[tile] == 0) && s_lo < col0 + kTN &&
                    s_hi > col0;

  if (!live) {  // no products: zeros (and a zero count)
    constexpr int kChunks = kTN / 16;
    for (int idx = threadIdx.x; idx < tm * kChunks; idx += C::kThreads) {
      const int r = idx / kChunks, c = (idx - r * kChunks) * 16;
      uint8_t* dst =
          kLive ? a.out + (static_cast<size_t>(tile) * tm + r) * kTN + c
                : a.out + static_cast<size_t>(row0 + r) * a.n_cols + col0 + c;
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    if (kLive && threadIdx.x == 0) a.counts[tile] = 0;
    return;
  }

  const int wg = threadIdx.x / kWg, tid = threadIdx.x % kWg;
  const int warp = tid / 32, lane = tid % 32;
  if (wg == kCons) {
    // ---- expander ------------------------------------------------------
    // thread tid owns A row tid (if it is < TM) and B rows tid + 128 i
    const int n_groups = (a.words + kGroupWords - 1) / kGroupWords;
    const uint32_t pack = ring + C::kPack;
    const uint32_t tx = (tm + kTN) * kGroupWords * 4;
    if (tid == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&tr))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&ts))
                   : "memory");
      for (int g = 0; g < kPackSlots && g < n_groups; ++g)
        load_group<kCons, kTN>(pack, pfull0, &tr, &ts, g, row0, col0, tx);
    }
    int filled = 0;       // stages handed to the consumers
    uint32_t zeroed = 0;  // (slot, row group) copies known to be all zero
    for (int g = 0; g < n_groups; ++g) {
      const int pslot = g % kPackSlots;
      mbar_wait(pfull0 + 8 * pslot, (g / kPackSlots) & 1);
      uint4 xa[kGroupStages], xb[C::kBRows][kGroupStages];
      read_group<kCons, kTN>(
          xa, xb, ring_ptr + C::kPack + pslot * C::kPackBytes, tid, tm);
      // a stage with no word on the R side or none on the S side adds
      // nothing to any count: it is neither expanded nor multiplied.
      // Bit st: some R word of stage st is set; bit 4 + st: some S word.
      int vote = 0;
#pragma unroll
      for (int st = 0; st < kGroupStages; ++st) {
        bool s_any = false;
#pragma unroll
        for (int i = 0; i < C::kBRows; ++i) s_any |= any_word(xb[i][st]);
        vote |= (__any_sync(0xffffffffu, any_word(xa[st])) ? 1 : 0) << st;
        vote |= (__any_sync(0xffffffffu, s_any) ? 1 : 0) << (4 + st);
      }
      if (lane == 0) s_vote[g & 1][warp] = vote;
      asm volatile("bar.sync 2, %0;\n" ::"n"(kWg) : "memory");
      const int v = s_vote[g & 1][0] | s_vote[g & 1][1] | s_vote[g & 1][2] |
                    s_vote[g & 1][3];
      // every warp has read the packed slot (the barrier orders it): refill
      if (tid == 0 && g + kPackSlots < n_groups)
        load_group<kCons, kTN>(pack, pfull0, &tr, &ts, g + kPackSlots, row0,
                               col0, tx);
#pragma unroll
      for (int st = 0; st < kGroupStages; ++st) {
        if (((v >> st) & (v >> (4 + st)) & 1) == 0) continue;
        const int slot = filled % C::kStages;
        if (filled >= C::kStages)
          mbar_wait(empty0 + 8 * slot, (filled / C::kStages - 1) & 1);
        const uint32_t stage = ring + slot * C::kStageBytes;
        const uint32_t bits = 1u << (slot * (1 + C::kBRows));
        expand_rows(stage, tid, xa[st], tid < tm, zeroed, bits);
#pragma unroll
        for (int i = 0; i < C::kBRows; ++i)
          expand_rows(stage + C::kABytes, tid + kWg * i, xb[i][st], true,
                      zeroed, bits << (1 + i));
        if (tid == 0) s_flag[slot] = 1;
        // the stores must reach the async proxy that wgmma reads through
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncwarp();
        if (lane == 0) mbar_arrive(full0 + 8 * slot);
        ++filled;
      }
    }
    // the end: a stage whose flag is 0
    const int slot = filled % C::kStages;
    if (filled >= C::kStages)
      mbar_wait(empty0 + 8 * slot, (filled / C::kStages - 1) & 1);
    if (tid == 0) s_flag[slot] = 0;
    __syncwarp();
    if (lane == 0) mbar_arrive(full0 + 8 * slot);
    return;
  }

  // ---- consumer warpgroup wg: rows 64 wg .. 64 wg + 63 of the tile ----
  uint32_t acc[kTN / 2];
#pragma unroll
  for (int i = 0; i < kTN / 2; ++i) acc[i] = 0;
  const uint32_t a_off = wg * 64 * kRowBytes;
  for (int it = 0;; ++it) {
    const int slot = it % C::kStages;
    mbar_wait(full0 + 8 * slot, (it / C::kStages) & 1);
    if (s_flag[slot] == 0) break;
    const uint32_t stage = ring + slot * C::kStageBytes;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRowBytes / 32; ++kk)
      wgmma_s8(acc, desc_sw128(stage + a_off + 32 * kk),
               desc_sw128(stage + C::kABytes + 32 * kk));
    wgmma_commit();
    fence_regs(acc);
    wgmma_wait<1>();  // the previous stage's group has completed
    fence_regs(acc);
    if (it > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % C::kStages));
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // ---- epilogue from the registers: window, predicate, mask bytes -----
  const int c2 = 2 * (lane % 4);
  int count = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 64 * wg + 16 * warp + lane / 4 + 8 * h;
    if (r < tm) {
      const int grow = row0 + r;
      const int w_lo = a.lo[grow], w_hi = a.hi[grow], rs = a.rsz[grow];
      uint8_t* dst =
          kLive ? a.out + (static_cast<size_t>(tile) * tm + r) * kTN
                : a.out + static_cast<size_t>(grow) * a.n_cols + col0;
#pragma unroll
      for (int i = 0; i < kTN / 8; ++i) {
        const int c = 8 * i + c2, gc = col0 + c;
        const bool ok0 = gc >= w_lo && gc < w_hi &&
                         qualify(static_cast<int>(acc[4 * i + 2 * h]), rs,
                                 s_ssz[c], a.measure, a.p, a.q);
        const bool ok1 = gc + 1 >= w_lo && gc + 1 < w_hi &&
                         qualify(static_cast<int>(acc[4 * i + 2 * h + 1]),
                                 rs, s_ssz[c + 1], a.measure, a.p, a.q);
        *reinterpret_cast<uint16_t*>(dst + c) =
            static_cast<uint16_t>(ok0 | (ok1 << 8));
        count += ok0 + ok1;
      }
    }
  }
  if (kLive) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      count += __shfl_xor_sync(0xffffffffu, count, off);
    if (lane == 0) s_part[4 * wg + warp] = count;
    // named barrier 1 over the consumer warpgroups only
    asm volatile("bar.sync 1, %0;\n" ::"n"(kCons * kWg) : "memory");
    if (threadIdx.x == 0) {
      int total = 0;
      for (int k = 0; k < 4 * kCons; ++k) total += s_part[k];
      a.counts[tile] = total;
    }
  }
}

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

// a tensor map over (words, rows) uint32 bitmap words, in boxes of one
// group of words by box_rows rows, 64-byte swizzle; words past `words`
// read as zero
bool make_map(CUtensorMap* map, const void* ptr, int words, int rows,
              int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(words),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(words) * 4};
  const cuuint32_t box[2] = {kGroupWords, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kLive, int kCons, int kTN>
int launch_cfg(unsigned grid, const Args& a, int m, cudaStream_t stream) {
  using C = Cfg<kCons, kTN>;
  CUtensorMap tr, ts;
  if (!make_map(&tr, a.r_bm, a.words, m, a.tm) ||
      !make_map(&ts, a.s_bm, a.words, a.n_cols, kTN))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = onehot_join_kernel<kLive, kCons, kTN>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, C::kThreads, C::kBytes, stream>>>(tr, ts, a);
  return static_cast<int>(cudaGetLastError());
}

bool tiles_ok(int tm, int tn) {
  return tm >= 1 && tm <= 128 && (tn == 128 || tn == 256);
}

// the configuration of a (tm, tn) tile: one consumer warpgroup up to 64
// rows, two up to 128
template <bool kLive>
int launch(unsigned grid, const Args& a, int m, int tn, cudaStream_t stream) {
  if (a.tm > 64)
    return tn == 256 ? launch_cfg<kLive, 2, 256>(grid, a, m, stream)
                     : launch_cfg<kLive, 2, 128>(grid, a, m, stream);
  return tn == 256 ? launch_cfg<kLive, 1, 256>(grid, a, m, stream)
                   : launch_cfg<kLive, 1, 128>(grid, a, m, stream);
}

Args make_args(const void* r_bm, const void* s_bm, const void* rsz,
               const void* ssz, const void* lo, const void* hi, int n,
               int words, int tm, int measure, int p, int q, void* out) {
  Args a{};
  a.r_bm = static_cast<const uint32_t*>(r_bm);
  a.s_bm = static_cast<const uint32_t*>(s_bm);
  a.rsz = static_cast<const int*>(rsz);
  a.ssz = static_cast<const int*>(ssz);
  a.lo = static_cast<const int*>(lo);
  a.hi = static_cast<const int*>(hi);
  a.out = static_cast<uint8_t*>(out);
  a.n_cols = n;
  a.words = words;
  a.tm = tm;
  a.measure = measure;
  a.p = p;
  a.q = q;
  return a;
}

}  // namespace

// Plain C entry points (bound with ctypes), with the arguments of
// bitmap_join.cu's (K4 adds the CTA order); each launches on `stream`
// without synchronising and returns the launch's cudaError_t (0 on
// success). Tiles other than 1 <= tm <= 128 rows by tn in {128, 256}
// columns, a word count that is not a multiple of 4 (TMA reads rows of
// 16-byte multiples), or a tensor map the driver refuses return
// cudaErrorInvalidValue and launch nothing.

// K5: the dense (M, N) mask over every tile, gated by skip (M/tm, N/tn).
extern "C" int onehot_join_tiled_launch(
    const void* r_bm, const void* s_bm, const void* rsz, const void* ssz,
    const void* lo, const void* hi, const void* skip, int m, int n,
    int words, int tm, int tn, int measure, int p, int q, void* out,
    void* stream) {
  if (!tiles_ok(tm, tn) || words % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int m_tiles = m / tm, n_tiles = n / tn;
  if (m_tiles <= 0 || n_tiles <= 0) return 0;
  Args a = make_args(r_bm, s_bm, rsz, ssz, lo, hi, n, words, tm, measure, p,
                     q, out);
  a.skip = static_cast<const int*>(skip);
  a.m_tiles = m_tiles;
  a.n_tiles = n_tiles;
  return launch<false>(static_cast<unsigned>(m_tiles * n_tiles), a, m, tn,
                       static_cast<cudaStream_t>(stream));
}

// K4: the live tiles (ti, tj) only -> mask (L, tm, tn) and counts (L, 1);
// CTA b computes live tile order[b] (a permutation of 0 .. L - 1), and
// writes it at that index.
extern "C" int onehot_join_live_tiled_launch(
    const void* ti, const void* tj, const void* order, int n_live,
    const void* r_bm, const void* s_bm, const void* rsz, const void* ssz,
    const void* lo, const void* hi, int n, int words, int tm, int tn,
    int measure, int p, int q, void* mask, void* counts, void* stream) {
  if (!tiles_ok(tm, tn) || words % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_live <= 0) return 0;
  Args a = make_args(r_bm, s_bm, rsz, ssz, lo, hi, n, words, tm, measure, p,
                     q, mask);
  a.ti = static_cast<const int*>(ti);
  a.tj = static_cast<const int*>(tj);
  a.order = static_cast<const int*>(order);
  a.counts = static_cast<int*>(counts);
  // the entry point is not given M: R's map spans the int32 row range,
  // and every box read lies in a live tile the caller names (tile_i * tm
  // + tm <= M, as the plain version requires too)
  return launch<true>(static_cast<unsigned>(n_live), a, 0x7fffffff, tn,
                      static_cast<cudaStream_t>(stream));
}

// The dynamic shared memory one CTA of a (tm, tn) tile asks for (0 for a
// tile the kernel does not take).
extern "C" int onehot_join_smem_bytes(int tm, int tn) {
  if (!tiles_ok(tm, tn)) return 0;
  if (tm > 64) return tn == 256 ? Cfg<2, 256>::kBytes : Cfg<2, 128>::kBytes;
  return tn == 256 ? Cfg<1, 256>::kBytes : Cfg<1, 128>::kBytes;
}
