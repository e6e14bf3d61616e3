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
// F += B_R @ B_S^T on its matrix unit in bf16 -> f32.
//
// Design. The TPU's bf16 -> f32 product is not carried over: the card's
// integer tensor cores are exact with no 2^24 limit. Each Pallas tile is
// split into CTA sub-tiles of min(TM, 64) rows (padded with zero rows to
// 16 when TM = 8) x 64 columns; the grid is (tiles, sub-tiles). A CTA of
// 4 warps walks the universe in chunks of 256 bits (8 words): it unpacks
// the sub-tile's R and S words to int8 0/1 tiles in shared memory, laid
// out as 16 x 16 blocks so that every fragment load is 256-bit aligned,
// and accumulates with nvcuda::wmma signed-char fragments (m16n16k16,
// int32 accumulator); warp w owns columns 16w..16w+15 of every row
// fragment. The accumulators then go to shared memory, and the CTA applies
// `qualify` (qualify.cuh) and the window. Sub-tiles whose columns miss
// every row's window, or whose tile is skipped (K5), do no products and
// write zeros; K4's CTAs add their qualifying cells into the tile's count
// with one integer atomicAdd each.
//
// Bound on this card. 2 int8 operations per in-window cell and universe
// bit, at the int8 tensor-core rate (1 979 TOP/s dense), against each
// bitmap word read once and each mask byte written once; on the
// livej-shaped join's 1024-row blocks the operations bound it
// (chip_smoke.py computes both for each run). This design uses the
// warp-level mma.sync path (wmma), not Hopper's warpgroup wgmma, unpacks
// every word for every sub-tile it meets, and does not overlap the unpack
// with the products; making it fast is later work.
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "qualify.cuh"

namespace {

using namespace nvcuda;

constexpr int kThreads = 128;     // 4 warps
constexpr int kSubCols = 64;      // columns of a CTA sub-tile
constexpr int kMaxSubRows = 64;   // rows of a CTA sub-tile (TM if smaller)
constexpr int kChunkWords = 8;    // 256 universe bits per step
constexpr int kKBlocks = kChunkWords * 32 / 16;  // 16-bit k blocks per step
constexpr int kABytes = kKBlocks * kMaxSubRows * 16;
constexpr int kBBytes = kKBlocks * kSubCols * 16;

// 16 membership bits -> 16 int8 0/1 bytes, as one 16-byte store
__device__ __forceinline__ void unpack16(uint32_t bits, int8_t* dst) {
  uint32_t v[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    v[g] = ((bits >> (4 * g)) & 1u) | (((bits >> (4 * g + 1)) & 1u) << 8) |
           (((bits >> (4 * g + 2)) & 1u) << 16) |
           (((bits >> (4 * g + 3)) & 1u) << 24);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
}

template <bool kLive>
__global__ void __launch_bounds__(kThreads)
onehot_join_kernel(const int* __restrict__ ti, const int* __restrict__ tj,
                   const int* __restrict__ skip, int n_tiles,
                   const uint32_t* __restrict__ r_bm,
                   const uint32_t* __restrict__ s_bm,
                   const int* __restrict__ rsz, const int* __restrict__ ssz,
                   const int* __restrict__ lo, const int* __restrict__ hi,
                   int n_cols, int words, int tm, int tn, int measure, int p,
                   int q, uint8_t* __restrict__ out,
                   int* __restrict__ counts) {
  // A blocks [k block][row][16 k], B blocks [k block][column][16 k]; after
  // the products the same bytes hold the (rows, 64) int32 accumulators
  __shared__ __align__(128) unsigned char smem[kABytes + kBBytes];
  __shared__ int s_lo, s_hi, s_count;
  int8_t* s_a = reinterpret_cast<int8_t*>(smem);
  int8_t* s_b = reinterpret_cast<int8_t*>(smem + kABytes);
  int* s_c = reinterpret_cast<int*>(smem);

  const int tile = blockIdx.x;
  const int tile_i = kLive ? ti[tile] : tile / n_tiles;
  const int tile_j = kLive ? tj[tile] : tile % n_tiles;
  const int sub_rows = min(tm, kMaxSubRows);
  const int pad_rows = (sub_rows + 15) / 16 * 16;  // 16-row fragments
  const int row_frags = pad_rows / 16;
  const int subs_per_row = tn / kSubCols;
  const int sr = blockIdx.y / subs_per_row;
  const int sc = blockIdx.y % subs_per_row;
  const int row0 = tile_i * tm + sr * sub_rows;
  const int col0 = tile_j * tn + sc * kSubCols;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    s_lo = 0x7fffffff;
    s_hi = -1;
    s_count = 0;
  }
  __syncthreads();
  if (threadIdx.x < sub_rows) {
    atomicMin(&s_lo, lo[row0 + threadIdx.x]);
    atomicMax(&s_hi, hi[row0 + threadIdx.x]);
  }
  __syncthreads();
  const bool live = (kLive || skip[tile] == 0) && s_lo < col0 + kSubCols &&
                    s_hi > col0;

  if (live) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) wmma::fill_fragment(acc[i], 0);
    for (int k0 = 0; k0 < words; k0 += kChunkWords) {
      // unpack: thread -> (row, word); rows past the sub-tile and words
      // past W are zeros
      for (int idx = threadIdx.x; idx < pad_rows * kChunkWords;
           idx += kThreads) {
        const int r = idx / kChunkWords, w = idx - r * kChunkWords;
        const uint32_t x =
            (r < sub_rows && k0 + w < words)
                ? r_bm[static_cast<size_t>(row0 + r) * words + k0 + w]
                : 0u;
        unpack16(x & 0xffffu, s_a + ((2 * w) * kMaxSubRows + r) * 16);
        unpack16(x >> 16, s_a + ((2 * w + 1) * kMaxSubRows + r) * 16);
      }
      for (int idx = threadIdx.x; idx < kSubCols * kChunkWords;
           idx += kThreads) {
        const int c = idx / kChunkWords, w = idx - c * kChunkWords;
        const uint32_t x =
            k0 + w < words
                ? s_bm[static_cast<size_t>(col0 + c) * words + k0 + w]
                : 0u;
        unpack16(x & 0xffffu, s_b + ((2 * w) * kSubCols + c) * 16);
        unpack16(x >> 16, s_b + ((2 * w + 1) * kSubCols + c) * 16);
      }
      __syncthreads();
#pragma unroll 4
      for (int kb = 0; kb < kKBlocks; ++kb) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                       wmma::col_major>
            b_frag;
        wmma::load_matrix_sync(
            b_frag, reinterpret_cast<const signed char*>(
                        s_b + (kb * kSubCols + 16 * warp) * 16),
            16);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i < row_frags) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                           wmma::row_major>
                a_frag;
            wmma::load_matrix_sync(
                a_frag, reinterpret_cast<const signed char*>(
                            s_a + (kb * kMaxSubRows + 16 * i) * 16),
                16);
            wmma::mma_sync(acc[i], a_frag, b_frag, acc[i]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < row_frags)
        wmma::store_matrix_sync(s_c + (16 * i) * kSubCols + 16 * warp,
                                acc[i], kSubCols, wmma::mem_row_major);
    }
  }
  __syncthreads();

  // predicate and window: thread -> 4 columns of rows tr, tr + 8, ...
  const int tx = threadIdx.x % 16, tr = threadIdx.x / 16;
  int my_count = 0;
  for (int r = tr; r < sub_rows; r += kThreads / 16) {
    const int grow = row0 + r;
    const int a_lo = lo[grow], a_hi = hi[grow], rs = rsz[grow];
    uint8_t v[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = col0 + 4 * tx + b;
      const bool ok = live && c >= a_lo && c < a_hi &&
                      qualify(s_c[r * kSubCols + 4 * tx + b], rs, ssz[c],
                              measure, p, q);
      v[b] = ok;
      my_count += ok;
    }
    uint8_t* dst =
        kLive ? out + (static_cast<size_t>(tile) * tm + sr * sub_rows + r) *
                          tn + sc * kSubCols + 4 * tx
              : out + static_cast<size_t>(grow) * n_cols + col0 + 4 * tx;
    *reinterpret_cast<uchar4*>(dst) = make_uchar4(v[0], v[1], v[2], v[3]);
  }
  if (kLive) {
    for (int off = 16; off > 0; off >>= 1)
      my_count += __shfl_down_sync(0xffffffffu, my_count, off);
    if ((threadIdx.x & 31) == 0 && my_count) atomicAdd(&s_count, my_count);
    __syncthreads();
    if (threadIdx.x == 0 && s_count) atomicAdd(counts + tile, s_count);
  }
}

dim3 sub_grid(int n_tiles_total, int tm, int tn) {
  return dim3(n_tiles_total, (tm / min(tm, kMaxSubRows)) * (tn / kSubCols));
}

}  // namespace

// Plain C entry points (bound with ctypes), with the arguments of
// bitmap_join.cu's; each launches on `stream` without synchronising and
// returns the launch's cudaError_t (0 on success).

// K5: the dense (M, N) mask over every tile, gated by skip (M/tm, N/tn).
extern "C" int onehot_join_tiled_launch(
    const void* r_bm, const void* s_bm, const void* rsz, const void* ssz,
    const void* lo, const void* hi, const void* skip, int m, int n,
    int words, int tm, int tn, int measure, int p, int q, void* out,
    void* stream) {
  const int n_tiles = n / tn, total = (m / tm) * n_tiles;
  if (total <= 0) return 0;
  onehot_join_kernel<false>
      <<<sub_grid(total, tm, tn), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          nullptr, nullptr, static_cast<const int*>(skip), n_tiles,
          static_cast<const uint32_t*>(r_bm),
          static_cast<const uint32_t*>(s_bm), static_cast<const int*>(rsz),
          static_cast<const int*>(ssz), static_cast<const int*>(lo),
          static_cast<const int*>(hi), n, words, tm, tn, measure, p, q,
          static_cast<uint8_t*>(out), nullptr);
  return static_cast<int>(cudaGetLastError());
}

// K4: the live tiles (ti, tj) only -> mask (L, tm, tn) and counts (L, 1),
// which the wrapper zeroes.
extern "C" int onehot_join_live_tiled_launch(
    const void* ti, const void* tj, int n_live, const void* r_bm,
    const void* s_bm, const void* rsz, const void* ssz, const void* lo,
    const void* hi, int n, int words, int tm, int tn, int measure, int p,
    int q, void* mask, void* counts, void* stream) {
  if (n_live <= 0) return 0;
  onehot_join_kernel<true>
      <<<sub_grid(n_live, tm, tn), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int*>(ti), static_cast<const int*>(tj), nullptr,
          0, static_cast<const uint32_t*>(r_bm),
          static_cast<const uint32_t*>(s_bm), static_cast<const int*>(rsz),
          static_cast<const int*>(ssz), static_cast<const int*>(lo),
          static_cast<const int*>(hi), n, words, tm, tn, measure, p, q,
          static_cast<uint8_t*>(mask), static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}
