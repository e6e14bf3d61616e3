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
// Bound on this card. A word that is zero on either side adds nothing to
// any count, and a set's bitmap is sparse: on the livej-shaped join a row
// or a column has a nonzero word in ~1 % of its 1 363. The work the
// function needs is an AND, a POPC and an ADD per in-window cell and word
// nonzero on both sides, against each operand read once (the R block, S's
// nonzero words, sizes, windows) and each mask byte written once; on a
// livej block the mask bytes bound it (chip_smoke.py computes both for
// each run, beside the dense figure of every word of every cell).
//
// Design. S comes compressed (bitmap_join.compress_s, once per join): per
// column its nonzero words as (word index, word) pairs, laid out in slabs
// of 32 columns, slot-major, so a warp's 32 adjacent columns read their
// k-th pair with one coalesced 256-byte load. The wrapper orders each
// tile's rows by window (a stable sort by lo, empty windows last) and the
// kernel takes them 16 at a time, so a group's window span stays close to
// its rows' own windows. Two kernels run on the stream:
//   * bitmap_union_kernel, one CTA per 16-row group of every row tile:
//     the union of the group's nonzero words, compacted in word order into
//     scratch as (word index, the 16 rows' words) with its length.
//   * bitmap_join_kernel<kLive>, one CTA of 256 threads per (tile, group):
//     the span of the group's non-empty windows inside the tile's columns
//     (none when K3's skip flag is set) is what it computes; a thread takes
//     one column at a time. It stages the group's union in shared memory,
//     up to 512 words a slice (16 rows' words, 64 bytes a slot), beside a
//     word -> slot map of W 16-bit entries that is never cleared: a slot
//     counts only if the staged word index at that slot is the word looked
//     up (a sparse set), so staging costs the union's length, not W. Each
//     column walks its pairs; a pair whose word is in the union adds
//     popc(R[r][slot] & word) for the 16 rows into registers. Then the
//     row's window and `qualify` (qualify.cuh), and every mask byte of the
//     group's rows in the tile is written, zeros outside the span (16
//     bytes a store where the span misses the tile), so no output needs a
//     fill first. K2 adds its qualifying cells into the tile's count with
//     one integer atomicAdd per CTA, exact in any order.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "qualify.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 16;       // rows a group takes
constexpr int kSlice = 512;      // union words staged at a time
constexpr int kSlotBytes = kGroup * 4 + 4;  // 16 row words + word index
constexpr int kSmemMax = 232448;            // bytes a CTA may use
constexpr int kStatic = 1024;               // room for static shared memory

int slice_of(int words) { return words < kSlice ? words : kSlice; }

int smem_bytes(int words) {
  return slice_of(words) * kSlotBytes + ((2 * words + 15) & ~15);
}

// The union of a group's nonzero words: u_idx[grp][k] is the k-th word
// index (ascending) with a nonzero word in one of the group's rows,
// u_words[grp][k] those rows' words (zero past the group's last row),
// u_count[grp] how many.
__global__ void __launch_bounds__(kThreads)
bitmap_union_kernel(const uint32_t* __restrict__ r_bm,
                    const int* __restrict__ order, int words, int tm,
                    int groups, int* __restrict__ u_idx,
                    uint4* __restrict__ u_words, int* __restrict__ u_count) {
  __shared__ int s_row[kGroup];
  __shared__ int s_warp[kThreads / 32];
  __shared__ int s_base;
  const int grp = blockIdx.x;
  const int tile_i = grp / groups, r0 = (grp % groups) * kGroup;
  const int gs = min(kGroup, tm - r0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < gs) s_row[tid] = order[tile_i * tm + r0 + tid];
  if (tid == 0) s_base = 0;
  __syncthreads();
  for (int w0 = 0; w0 < words; w0 += kThreads) {
    const int w = w0 + tid;
    uint32_t v[kGroup];
    bool any = false;
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      v[r] = (r < gs && w < words)
                 ? r_bm[static_cast<size_t>(s_row[r]) * words + w]
                 : 0u;
      any |= v[r] != 0;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, any);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int before = s_base, total = 0;
#pragma unroll
    for (int k = 0; k < kThreads / 32; ++k) {
      before += k < warp ? s_warp[k] : 0;
      total += s_warp[k];
    }
    if (any) {
      const size_t at = static_cast<size_t>(grp) * words + before +
                        __popc(ballot & ((1u << lane) - 1));
      u_idx[at] = w;
#pragma unroll
      for (int q = 0; q < kGroup / 4; ++q)
        u_words[at * 4 + q] =
            make_uint4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
    __syncthreads();  // every thread has read s_warp and s_base
    if (tid == 0) s_base += total;
    __syncthreads();
  }
  if (tid == 0) u_count[grp] = s_base;
}

template <bool kLive>
__global__ void __launch_bounds__(kThreads)
bitmap_join_kernel(const int* __restrict__ ti, const int* __restrict__ tj,
                   const int* __restrict__ skip, int n_tiles, int groups,
                   const int* __restrict__ order,
                   const int* __restrict__ u_idx,
                   const uint4* __restrict__ u_words,
                   const int* __restrict__ u_count,
                   const int* __restrict__ s_counts,
                   const long long* __restrict__ s_off,
                   const int2* __restrict__ s_pairs,
                   const int* __restrict__ rsz, const int* __restrict__ ssz,
                   const int* __restrict__ lo, const int* __restrict__ hi,
                   int n_cols, int words, int slice, int tm, int tn,
                   int measure, int p, int q, uint8_t* __restrict__ out,
                   int* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* s_w = reinterpret_cast<uint4*>(smem);  // [slice][4]
  int* s_idx = reinterpret_cast<int*>(smem + slice * kGroup * 4);
  uint16_t* s_map = reinterpret_cast<uint16_t*>(smem + slice * kSlotBytes);
  __shared__ int s_lo[kGroup], s_hi[kGroup], s_rs[kGroup];
  __shared__ uint8_t* s_dst[kGroup];
  __shared__ int s_span_lo, s_span_hi, s_count;

  const int tid = threadIdx.x;
  const int tile = blockIdx.x / groups, g = blockIdx.x % groups;
  const int tile_i = kLive ? ti[tile] : tile / n_tiles;
  const int tile_j = kLive ? tj[tile] : tile % n_tiles;
  const int r0 = g * kGroup, gs = min(kGroup, tm - r0);
  const int grp = tile_i * groups + g;  // the group's union in scratch
  const int col0 = tile_j * tn;

  if (tid == 0) {
    s_span_lo = INT_MAX;
    s_span_hi = INT_MIN;
    s_count = 0;
  }
  __syncthreads();
  if (tid < gs) {
    const int row = order[tile_i * tm + r0 + tid];
    const int a_lo = lo[row], a_hi = hi[row];
    s_lo[tid] = a_lo;
    s_hi[tid] = a_hi;
    s_rs[tid] = rsz[row];
    // each mask row is written at the row's own place
    s_dst[tid] = kLive ? out + (static_cast<size_t>(tile) * tm + row -
                                static_cast<size_t>(tile_i) * tm) * tn
                       : out + static_cast<size_t>(row) * n_cols + col0;
    if (a_lo < a_hi) {  // padded rows' empty [0, 0) widen no span
      atomicMin(&s_span_lo, a_lo);
      atomicMax(&s_span_hi, a_hi);
    }
  }
  __syncthreads();
  // the group's columns in this tile, CTA-uniform; none when K3's skip
  // flag is set
  const bool skipped = !kLive && skip[tile] != 0;
  const int c_lo = max(col0, s_span_lo);
  const int c_hi = skipped ? c_lo : min(col0 + tn, s_span_hi);
  if (c_lo >= c_hi) {  // no column to count: the rows' mask bytes are 0
    const int per_row = tn / 16;
    for (int k = tid; k < gs * per_row; k += kThreads)
      reinterpret_cast<uint4*>(s_dst[k / per_row])[k % per_row] =
          make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  const int n_union = u_count[grp];
  const size_t u0 = static_cast<size_t>(grp) * words;

  auto stage = [&](int s0, int us) {
    for (int k = tid; k < us; k += kThreads) {
      const int w = u_idx[u0 + s0 + k];
      s_idx[k] = w;
      s_map[w] = static_cast<uint16_t>(k);
    }
    const uint4* src = u_words + (u0 + s0) * 4;
    for (int k = tid; k < us * 4; k += kThreads) s_w[k] = src[k];
  };
  const bool one_slice = n_union <= slice;
  if (n_union > 0 && one_slice) {
    stage(0, n_union);
    __syncthreads();
  }

  int my_count = 0;
  for (int cb = 0; cb < tn; cb += kThreads) {
    const int c = col0 + cb + tid;
    const bool mine = cb + tid < tn;
    const bool live = mine && c >= c_lo && c < c_hi;
    int acc[kGroup];
#pragma unroll
    for (int r = 0; r < kGroup; ++r) acc[r] = 0;
    // CTA-uniform: this run of columns meets the span
    if (n_union > 0 && c_lo < col0 + cb + kThreads && c_hi > col0 + cb) {
      const int cnt = live ? s_counts[c] : 0;
      const int2* pp = s_pairs + (live ? s_off[c >> 5] + (c & 31) : 0);
      for (int s0 = 0; s0 < n_union; s0 += slice) {
        const int us = min(slice, n_union - s0);
        if (!one_slice) {
          __syncthreads();  // the previous slice is read
          stage(s0, us);
          __syncthreads();
        }
#pragma unroll 2
        for (int k = 0; k < cnt; ++k) {
          const int2 pr = __ldg(pp + 32 * k);
          const int slot = s_map[pr.x];
          if (slot < us && s_idx[slot] == pr.x) {
            const uint32_t sw = static_cast<uint32_t>(pr.y);
#pragma unroll
            for (int qq = 0; qq < kGroup / 4; ++qq) {
              const uint4 rw = s_w[slot * 4 + qq];
              acc[4 * qq] += __popc(rw.x & sw);
              acc[4 * qq + 1] += __popc(rw.y & sw);
              acc[4 * qq + 2] += __popc(rw.z & sw);
              acc[4 * qq + 3] += __popc(rw.w & sw);
            }
          }
        }
      }
    }
    if (mine) {
      const int s_size = live ? ssz[c] : 0;
#pragma unroll
      for (int r = 0; r < kGroup; ++r) {
        if (r < gs) {
          const bool ok = live && c >= s_lo[r] && c < s_hi[r] &&
                          qualify(acc[r], s_rs[r], s_size, measure, p, q);
          s_dst[r][cb + tid] = ok;
          my_count += ok;
        }
      }
    }
  }
  if (kLive) {
    for (int off = 16; off > 0; off >>= 1)
      my_count += __shfl_down_sync(0xffffffffu, my_count, off);
    if ((tid & 31) == 0 && my_count) atomicAdd(&s_count, my_count);
    __syncthreads();
    if (tid == 0 && s_count) atomicAdd(counts + tile, s_count);
  }
}

template <bool kLive>
int launch(int n_ctas, int groups, int words, cudaStream_t stream,
           const void* ti, const void* tj, const void* skip, int n_tiles,
           const void* r_bm, const void* order, void* u_idx, void* u_words,
           void* u_count, int m_tiles, const void* s_counts,
           const void* s_off, const void* s_pairs, const void* rsz,
           const void* ssz, const void* lo, const void* hi, int n_cols,
           int tm, int tn, int measure, int p, int q, void* out,
           void* counts) {
  const int bytes = smem_bytes(words);
  if (bytes + kStatic > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  bitmap_union_kernel<<<m_tiles * groups, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(r_bm), static_cast<const int*>(order),
      words, tm, groups, static_cast<int*>(u_idx),
      static_cast<uint4*>(u_words), static_cast<int*>(u_count));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(bitmap_join_kernel<kLive>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  bitmap_join_kernel<kLive><<<n_ctas, kThreads, bytes, stream>>>(
      static_cast<const int*>(ti), static_cast<const int*>(tj),
      static_cast<const int*>(skip), n_tiles, groups,
      static_cast<const int*>(order), static_cast<const int*>(u_idx),
      static_cast<const uint4*>(u_words), static_cast<const int*>(u_count),
      static_cast<const int*>(s_counts),
      static_cast<const long long*>(s_off),
      static_cast<const int2*>(s_pairs), static_cast<const int*>(rsz),
      static_cast<const int*>(ssz), static_cast<const int*>(lo),
      static_cast<const int*>(hi), n_cols, words, slice_of(words), tm, tn,
      measure, p, q, static_cast<uint8_t*>(out), static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

int groups_of(int tm) { return (tm + kGroup - 1) / kGroup; }

}  // namespace

// Plain C entry points (bound with ctypes). Each launches its two kernels
// on `stream` without synchronising and returns the launches'
// cudaError_t (0 on success). The wrapper has checked the shapes: M % tm
// == 0, N % tn == 0, tn % 32 == 0, the compressed S covers N columns of
// `words` words, and bitmap_join_smem_bytes(words) fits a CTA. `order` is
// the (M,) row order (a permutation inside each row tile); `u_idx` and
// `u_words` are (M/tm * groups, words) and (M/tm * groups, words, 16)
// int32 scratch, `u_count` (M/tm * groups,), groups = ceil(tm / 16).

// Dynamic shared memory a join CTA asks for at `words` words.
extern "C" int bitmap_join_smem_bytes(int words) { return smem_bytes(words); }

// K3: the dense (M, N) mask over every tile, gated by skip (M/tm, N/tn).
extern "C" int bitmap_join_tiled_launch(
    const void* r_bm, const void* rsz, const void* ssz, const void* lo,
    const void* hi, const void* skip, const void* order,
    const void* s_counts, const void* s_off, const void* s_pairs,
    void* u_idx, void* u_words, void* u_count, int m, int n, int words,
    int tm, int tn, int measure, int p, int q, void* out, void* stream) {
  const int m_tiles = m / tm, n_tiles = n / tn, groups = groups_of(tm);
  if (m_tiles * n_tiles <= 0) return 0;
  return launch<false>(m_tiles * n_tiles * groups, groups, words,
                       static_cast<cudaStream_t>(stream), nullptr, nullptr,
                       skip, n_tiles, r_bm, order, u_idx, u_words, u_count,
                       m_tiles, s_counts, s_off, s_pairs, rsz, ssz, lo, hi,
                       n, tm, tn, measure, p, q, out, nullptr);
}

// K2: the live tiles (ti, tj) only -> mask (L, tm, tn) and counts (L, 1),
// which the wrapper zeroes.
extern "C" int bitmap_join_live_tiled_launch(
    const void* ti, const void* tj, int n_live, const void* r_bm,
    const void* rsz, const void* ssz, const void* lo, const void* hi,
    const void* order, const void* s_counts, const void* s_off,
    const void* s_pairs, void* u_idx, void* u_words, void* u_count, int m,
    int n, int words, int tm, int tn, int measure, int p, int q, void* mask,
    void* counts, void* stream) {
  const int groups = groups_of(tm);
  if (n_live <= 0) return 0;
  return launch<true>(n_live * groups, groups, words,
                      static_cast<cudaStream_t>(stream), ti, tj, nullptr, 0,
                      r_bm, order, u_idx, u_words, u_count, m / tm, s_counts,
                      s_off, s_pairs, rsz, ssz, lo, hi, n, tm, tn, measure,
                      p, q, mask, counts);
}
