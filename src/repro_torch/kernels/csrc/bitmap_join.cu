// K2 / K3: the bitmap AND-popcount join over (live) tiles, sm_90a.
//
// Replaces the Pallas TPU kernels of the JAX package's
// src/repro/kernels/bitmap_join.py: `bitmap_join_live_tiled` (K2, body
// `_live_kernel`) and `bitmap_join_tiled` (K3, body `_kernel`). Both
// compute, per (TM, TN) tile of the padded (M, N) cell grid, the
// intersection sizes f = sum_w popc(R[i][w] & S[j][w]) over the W
// membership words, then the measure predicate and the row's [lo, hi)
// column window. K2 runs over a host-compacted list of live tiles and
// writes an (L, TM, TN) mask plus an exact per-tile pair count; K3 runs
// over every tile, writes the dense (M, N) mask, and leaves a tile whose
// skip flag is set all False.
//
// Design. A (256, 256) int32 accumulator is 256 KB, more than a CTA's
// shared memory or registers, so each Pallas tile is split into CTA
// sub-tiles of min(TM, 64) rows x 64 columns: the grid is (tiles,
// sub-tiles). A CTA of 256 threads (16 x 16) keeps its sub-tile's counts
// in registers, 4 x 4 cells a thread (rows ty + 16a, columns 4tx + b),
// and walks the W words in chunks of 32 staged in shared memory
// (word-major, so one 16-byte load gives a thread its 4 S words). A
// sub-tile whose columns miss every row's window, or (K3) whose tile is
// flagged in the skip mask, does no popcounts and writes zeros. The
// predicate is `qualify` of qualify.cuh. K2's CTAs add their qualifying
// cells into the tile's count with one integer atomicAdd each, which is
// exact whatever the order.
//
// Bound on this card. The work is one AND, one POPC and one ADD per
// in-window cell and word; the function must read each bitmap word once
// and write each mask byte once. On the livej-shaped join's 1024-row
// blocks that is ~3e10 cell-words against ~0.55 GB of bytes, so
// operations bound it (chip_smoke.py computes both for each run; the CUDA
// Programming Guide's throughput table gives population count a quarter
// of the int32 add rate on compute capability 9.0). This design re-reads
// each R and S word once per sub-tile it meets (through L2) and does the
// popcounts of a whole sub-tile once its window touches it; making it
// fast (wider register tiles, cp.async pipelining, 64-bit popcounts) is
// later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "qualify.cuh"

namespace {

constexpr int kThreads = 256;    // 16 x 16
constexpr int kSubCols = 64;     // columns of a CTA sub-tile
constexpr int kMaxSubRows = 64;  // rows of a CTA sub-tile (TM if smaller)
constexpr int kChunk = 32;       // words staged per step

template <bool kLive>
__global__ void __launch_bounds__(kThreads)
bitmap_join_kernel(const int* __restrict__ ti, const int* __restrict__ tj,
                   const int* __restrict__ skip, int n_tiles,
                   const uint32_t* __restrict__ r_bm,
                   const uint32_t* __restrict__ s_bm,
                   const int* __restrict__ rsz, const int* __restrict__ ssz,
                   const int* __restrict__ lo, const int* __restrict__ hi,
                   int n_cols, int words, int tm, int tn, int measure, int p,
                   int q, uint8_t* __restrict__ out,
                   int* __restrict__ counts) {
  __shared__ uint32_t s_r[kChunk][kMaxSubRows];
  __shared__ __align__(16) uint32_t s_s[kChunk][kSubCols];
  __shared__ int s_lo, s_hi, s_count;

  const int tile = blockIdx.x;
  const int tile_i = kLive ? ti[tile] : tile / n_tiles;
  const int tile_j = kLive ? tj[tile] : tile % n_tiles;
  const int sub_rows = min(tm, kMaxSubRows);
  const int subs_per_row = tn / kSubCols;
  const int sr = blockIdx.y / subs_per_row;
  const int sc = blockIdx.y % subs_per_row;
  const int row0 = tile_i * tm + sr * sub_rows;  // first global row
  const int col0 = tile_j * tn + sc * kSubCols;  // first global column
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

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
  // CTA-uniform: the tile is not skipped and some row's window reaches
  // the sub-tile's columns
  const bool live = (kLive || skip[tile] == 0) && s_lo < col0 + kSubCols &&
                    s_hi > col0;

  int acc[4][4] = {};
  if (live) {
    for (int k0 = 0; k0 < words; k0 += kChunk) {
      const int kw = min(kChunk, words - k0);
      for (int idx = threadIdx.x; idx < kw * sub_rows; idx += kThreads) {
        const int kk = idx / sub_rows, r = idx - kk * sub_rows;
        s_r[kk][r] = r_bm[static_cast<size_t>(row0 + r) * words + k0 + kk];
      }
      for (int idx = threadIdx.x; idx < kw * kSubCols; idx += kThreads) {
        const int kk = idx / kSubCols, c = idx - kk * kSubCols;
        s_s[kk][c] = s_bm[static_cast<size_t>(col0 + c) * words + k0 + kk];
      }
      __syncthreads();
      for (int kk = 0; kk < kw; ++kk) {
        const uint4 sv = *reinterpret_cast<const uint4*>(&s_s[kk][4 * tx]);
        const uint32_t sw[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          // rows at or past sub_rows read stale words; they are never
          // written out
          const uint32_t rw = s_r[kk][ty + 16 * a];
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] += __popc(rw & sw[b]);
        }
      }
      __syncthreads();
    }
  }

  int my_count = 0;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    if (r >= sub_rows) continue;
    const int grow = row0 + r;
    const int a_lo = lo[grow], a_hi = hi[grow], rs = rsz[grow];
    uint8_t v[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = col0 + 4 * tx + b;
      const bool ok = live && c >= a_lo && c < a_hi &&
                      qualify(acc[a][b], rs, ssz[c], measure, p, q);
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

// Plain C entry points (bound with ctypes). Each launches on `stream`
// without synchronising and returns the launch's cudaError_t (0 on
// success). The wrapper has checked the shapes: M % tm == 0, N % tn == 0,
// tn % 64 == 0, and tm <= 64 or tm % 64 == 0.

// K3: the dense (M, N) mask over every tile, gated by skip (M/tm, N/tn).
extern "C" int bitmap_join_tiled_launch(
    const void* r_bm, const void* s_bm, const void* rsz, const void* ssz,
    const void* lo, const void* hi, const void* skip, int m, int n,
    int words, int tm, int tn, int measure, int p, int q, void* out,
    void* stream) {
  const int n_tiles = n / tn, total = (m / tm) * n_tiles;
  if (total <= 0) return 0;
  bitmap_join_kernel<false>
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

// K2: the live tiles (ti, tj) only -> mask (L, tm, tn) and counts (L, 1),
// which the wrapper zeroes.
extern "C" int bitmap_join_live_tiled_launch(
    const void* ti, const void* tj, int n_live, const void* r_bm,
    const void* s_bm, const void* rsz, const void* ssz, const void* lo,
    const void* hi, int n, int words, int tm, int tn, int measure, int p,
    int q, void* mask, void* counts, void* stream) {
  if (n_live <= 0) return 0;
  bitmap_join_kernel<true>
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
