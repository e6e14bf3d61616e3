// K1: the flat-LFVT walk over live row tiles (CF-RS-Join/LFVT), sm_90a.
//
// Replaces the Pallas TPU kernel `lfvt_walk_live_tiled` of the JAX
// package (src/repro/kernels/lfvt_walk.py, body `_walk_kernel`). It
// computes the same function: for every live row tile of a size-sorted R
// block, each R element's lane walks the fused `seq_row`/`seq_next` chain
// from its entry position, adds 1 to the count of each S row it emits,
// and dies once the row drops below its window's `lo` (Theorem 3.3, walk
// rows strictly decrease). The tile then applies the measure predicate
// and the [lo, hi) column window and writes its mask, its pair count, its
// `walk_steps` and its `early_stops`.
//
// Design. One CTA per live row tile. The Pallas body steps all lanes in
// lockstep; here every lane walks alone, because no output depends on the
// order of the lanes' steps:
//   * counts and the mask are sums over lanes;
//   * `walk_steps` is the number of steps in which the tile had a live
//     lane; a lane is live on a prefix of steps, so it is the max over
//     lanes of their live-step counts (capped at `max_steps`);
//   * `early_stops` counts lanes that stop at row < lo with rem > 1.
// The CTA's threads stride over the tm x Lr lanes (Lr is the block's
// largest R set, thousands on skewed data). A lane adds to its count only
// for rows inside its [lo, hi): rows outside can never qualify, so the
// mask is unchanged. The (tm, NP) int32 count tile does not fit in shared
// memory once NP exceeds ~3.6k columns (227 KB), so it lives in a global
// scratch of (L, tm, NP) int32 that the wrapper allocates; the CTA zeroes
// only the window columns it will read. After __syncthreads() the same
// CTA evaluates the predicate over every column, writes the mask bytes
// and reduces its count.
//
// Bound on this card. The function must read its inputs once (the
// seq_row/seq_next chains, the lane state, the row columns) and write the
// tm x NP mask bytes per tile, at 3.35 TB/s of HBM, and do a few int32
// operations per lane step and per in-window mask cell; chip_smoke.py
// computes both from each run's data. This design moves far more than
// that: per lane step one `seq_row` and one `seq_next` gather (8 B) and,
// inside the window, one 4 B atomic on the global scratch. The chains fit
// in L2, so that traffic is served by L2, and the walk is latency-bound
// in practice (dependent gathers, a few long lanes per tile on skewed
// data). Making it fast (column-split shared-memory count tiles,
// balancing long lanes across warps) is later work.
//
// Integer algebra. The predicate is `qualify` of qualify.cuh, shared by
// every kernel of the port: the reference's exact int32 algebra.
#include <cuda_runtime.h>
#include <stdint.h>

#include "qualify.cuh"

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
lfvt_walk_kernel(const int* __restrict__ ti,
                 const int* __restrict__ lane_pos,
                 const int* __restrict__ lane_rem, int lr,
                 const int* __restrict__ nxt, const int* __restrict__ seq,
                 const int* __restrict__ ssz, int np,
                 const int* __restrict__ rsz, const int* __restrict__ lo,
                 const int* __restrict__ hi, int tm, int max_steps,
                 int measure, int p, int q, int* __restrict__ scratch,
                 uint8_t* __restrict__ mask, int* __restrict__ counts,
                 int* __restrict__ steps, int* __restrict__ stops) {
  __shared__ int s_steps, s_stops, s_count;
  const int l = blockIdx.x;
  const int row0 = ti[l] * tm;
  int* acc = scratch + static_cast<size_t>(l) * tm * np;
  uint8_t* out = mask + static_cast<size_t>(l) * tm * np;
  if (threadIdx.x == 0) {
    s_steps = 0;
    s_stops = 0;
    s_count = 0;
  }
  // zero the window columns of this tile's count rows
  for (int r = 0; r < tm; ++r) {
    int* acc_r = acc + static_cast<size_t>(r) * np;
    for (int c = lo[row0 + r] + threadIdx.x; c < hi[row0 + r];
         c += blockDim.x)
      acc_r[c] = 0;
  }
  __syncthreads();

  // walk: each lane on its own
  int my_steps = 0, my_stops = 0;
  const int n_lanes = tm * lr;
  for (int lane = threadIdx.x; lane < n_lanes; lane += blockDim.x) {
    const int r = lane / lr;
    const size_t g = static_cast<size_t>(row0 + r) * lr + (lane - r * lr);
    int rem = lane_rem[g];
    if (rem <= 0) continue;
    int pos = lane_pos[g];
    const int lo_r = lo[row0 + r], hi_r = hi[row0 + r];
    int* acc_r = acc + static_cast<size_t>(r) * np;
    int k = 0;
    while (k < max_steps) {
      const int row = seq[pos];
      const int nx = nxt[pos];
      ++k;
      if (row < lo_r) {  // Theorem 3.3: every later row is smaller still
        if (rem > 1) ++my_stops;
        break;
      }
      if (row < hi_r) atomicAdd(acc_r + row, 1);
      if (--rem == 0) break;
      pos = nx > 0 ? nx : 0;
    }
    my_steps = max(my_steps, k);
  }
  if (my_steps) atomicMax(&s_steps, my_steps);
  if (my_stops) atomicAdd(&s_stops, my_stops);
  __syncthreads();

  // qualify every column: predicate inside the window, 0 outside
  int my_count = 0;
  for (int r = 0; r < tm; ++r) {
    const int a = lo[row0 + r], b = hi[row0 + r], rs = rsz[row0 + r];
    const int* acc_r = acc + static_cast<size_t>(r) * np;
    uint8_t* out_r = out + static_cast<size_t>(r) * np;
    for (int c = threadIdx.x; c < np; c += blockDim.x) {
      const bool ok =
          c >= a && c < b && qualify(acc_r[c], rs, ssz[c], measure, p, q);
      out_r[c] = ok;
      my_count += ok;
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    my_count += __shfl_down_sync(0xffffffffu, my_count, off);
  if ((threadIdx.x & 31) == 0 && my_count) atomicAdd(&s_count, my_count);
  __syncthreads();
  if (threadIdx.x == 0) {
    counts[l] = s_count;
    steps[l] = s_steps;
    stops[l] = s_stops;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream` without
// synchronising and returns the launch's cudaError_t (0 on success).
extern "C" int lfvt_walk_live_tiled_launch(
    const void* ti, int n_tiles, const void* lane_pos, const void* lane_rem,
    int lr, const void* nxt, const void* seq, const void* ssz, int np,
    const void* rsz, const void* lo, const void* hi, int tm, int max_steps,
    int measure, int p, int q, void* scratch, void* mask, void* counts,
    void* steps, void* stops, void* stream) {
  if (n_tiles <= 0) return 0;
  lfvt_walk_kernel<<<n_tiles, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ti), static_cast<const int*>(lane_pos),
      static_cast<const int*>(lane_rem), lr, static_cast<const int*>(nxt),
      static_cast<const int*>(seq), static_cast<const int*>(ssz), np,
      static_cast<const int*>(rsz), static_cast<const int*>(lo),
      static_cast<const int*>(hi), tm, max_steps, measure, p, q,
      static_cast<int*>(scratch), static_cast<uint8_t*>(mask),
      static_cast<int*>(counts), static_cast<int*>(steps),
      static_cast<int*>(stops));
  return static_cast<int>(cudaGetLastError());
}
