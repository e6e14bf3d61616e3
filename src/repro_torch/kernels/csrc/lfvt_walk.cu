// K1 and K6: the flat-LFVT walk over row tiles (CF-RS-Join/LFVT), sm_90a.
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
// K6 replaces the Pallas TPU kernel `lfvt_walk_planned` (same file, body
// `_walk_kernel_planned`): K1 over a device-planned schedule. The wrapper
// passes `ti_sorted` (every tile id, the live ones first) and `n_live` (a
// device scalar) from `plan_row_tiles_device`, so the host never learns
// the live count and the grid covers all m_tiles tiles. CTA l reads
// n_live from device memory; if l >= n_live it writes zeros to its tile's
// mask rows and counters and returns, else it runs K1's body
// (`walk_tile`) on tile ti_sorted[l]. Every output lands at the tile's
// own slot, ti_sorted[l] (a permutation), so the outputs come back in
// tile order with no inverse permutation afterwards. The count scratch is
// (m_tiles, tm, NP) int32 since the live count is unknown on the host: at
// the serve phase of chip_smoke.py (256-request batches, tm = 16, the
// 100 000-set livej corpus in a 131 072-row view) that is 16 x 16 x
// 131 072 x 4 B = 128 MiB beside a 32 MiB mask. Dead tiles cost one
// vectorised zero write of tm x NP bytes and nothing else. Window bounds
// are clamped into [0, NP) before any scratch or mask access, which
// leaves the result unchanged (columns outside [0, NP) do not exist).
//
// Integer algebra. The predicate is `qualify` of qualify.cuh, shared by
// every kernel of the port: the reference's exact int32 algebra.
#include <cuda_runtime.h>
#include <stdint.h>

#include "qualify.cuh"

namespace {

constexpr int kThreads = 512;

// The operands both kernels share (K1's, after its tile list).
struct WalkArgs {
  const int* lane_pos;
  const int* lane_rem;
  int lr;
  const int* nxt;
  const int* seq;
  const int* ssz;
  int np;
  const int* rsz;
  const int* lo;
  const int* hi;
  int tm;
  int max_steps;
  int measure;
  int p;
  int q;
};

// One row tile's walk and qualify, run by a whole CTA: tile `tile` of the
// size-sorted block, its count tile `acc` (tm x np), its mask rows `out`
// (tm x np), its three counters. Every thread of the CTA must call it.
__device__ void walk_tile(const WalkArgs& a, int tile, int* acc,
                          uint8_t* out, int* count, int* steps, int* stops) {
  __shared__ int s_steps, s_stops, s_count;
  const int row0 = tile * a.tm;
  if (threadIdx.x == 0) {
    s_steps = 0;
    s_stops = 0;
    s_count = 0;
  }
  // zero the window columns of this tile's count rows
  for (int r = 0; r < a.tm; ++r) {
    int* acc_r = acc + static_cast<size_t>(r) * a.np;
    const int c1 = min(a.hi[row0 + r], a.np);
    for (int c = max(a.lo[row0 + r], 0) + threadIdx.x; c < c1;
         c += blockDim.x)
      acc_r[c] = 0;
  }
  __syncthreads();

  // walk: each lane on its own
  int my_steps = 0, my_stops = 0;
  const int n_lanes = a.tm * a.lr;
  for (int lane = threadIdx.x; lane < n_lanes; lane += blockDim.x) {
    const int r = lane / a.lr;
    const size_t g =
        static_cast<size_t>(row0 + r) * a.lr + (lane - r * a.lr);
    int rem = a.lane_rem[g];
    if (rem <= 0) continue;
    int pos = a.lane_pos[g];
    const int lo_r = max(a.lo[row0 + r], 0);
    const int hi_r = min(a.hi[row0 + r], a.np);
    int* acc_r = acc + static_cast<size_t>(r) * a.np;
    int k = 0;
    while (k < a.max_steps) {
      const int row = a.seq[pos];
      const int nx = a.nxt[pos];
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
  for (int r = 0; r < a.tm; ++r) {
    const int c0 = max(a.lo[row0 + r], 0), c1 = min(a.hi[row0 + r], a.np);
    const int rs = a.rsz[row0 + r];
    const int* acc_r = acc + static_cast<size_t>(r) * a.np;
    uint8_t* out_r = out + static_cast<size_t>(r) * a.np;
    for (int c = threadIdx.x; c < a.np; c += blockDim.x) {
      const bool ok = c >= c0 && c < c1 &&
                      qualify(acc_r[c], rs, a.ssz[c], a.measure, a.p, a.q);
      out_r[c] = ok;
      my_count += ok;
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    my_count += __shfl_down_sync(0xffffffffu, my_count, off);
  if ((threadIdx.x & 31) == 0 && my_count) atomicAdd(&s_count, my_count);
  __syncthreads();
  if (threadIdx.x == 0) {
    *count = s_count;
    *steps = s_steps;
    *stops = s_stops;
  }
}

// K1: CTA l walks live tile ti[l]; outputs at l.
__global__ void __launch_bounds__(kThreads)
lfvt_walk_kernel(const int* __restrict__ ti, WalkArgs a,
                 int* __restrict__ scratch, uint8_t* __restrict__ mask,
                 int* __restrict__ counts, int* __restrict__ steps,
                 int* __restrict__ stops) {
  const int l = blockIdx.x;
  const size_t off = static_cast<size_t>(l) * a.tm * a.np;
  walk_tile(a, ti[l], scratch + off, mask + off, counts + l, steps + l,
            stops + l);
}

// K6: CTA l walks tile ti_sorted[l] while l < *n_live, else zeroes it;
// outputs at the tile's own slot ti_sorted[l].
__global__ void __launch_bounds__(kThreads)
lfvt_walk_planned_kernel(const int* __restrict__ ti_sorted,
                         const int* __restrict__ n_live, WalkArgs a,
                         int* __restrict__ scratch,
                         uint8_t* __restrict__ mask,
                         int* __restrict__ counts, int* __restrict__ steps,
                         int* __restrict__ stops) {
  const int l = blockIdx.x;
  const int tile = ti_sorted[l];
  const size_t off = static_cast<size_t>(tile) * a.tm * a.np;
  if (l >= *n_live) {
    // np is a multiple of 16 (the wrapper pads columns to 128), and
    // every tile's mask starts 16-byte aligned
    uint4* out = reinterpret_cast<uint4*>(mask + off);
    const int n16 = a.tm * a.np / 16;
    for (int i = threadIdx.x; i < n16; i += blockDim.x)
      out[i] = make_uint4(0, 0, 0, 0);
    if (threadIdx.x == 0) {
      counts[tile] = 0;
      steps[tile] = 0;
      stops[tile] = 0;
    }
    return;
  }
  walk_tile(a, tile, scratch + off, mask + off, counts + tile, steps + tile,
            stops + tile);
}

WalkArgs make_args(const void* lane_pos, const void* lane_rem, int lr,
                   const void* nxt, const void* seq, const void* ssz, int np,
                   const void* rsz, const void* lo, const void* hi, int tm,
                   int max_steps, int measure, int p, int q) {
  return WalkArgs{static_cast<const int*>(lane_pos),
                  static_cast<const int*>(lane_rem),
                  lr,
                  static_cast<const int*>(nxt),
                  static_cast<const int*>(seq),
                  static_cast<const int*>(ssz),
                  np,
                  static_cast<const int*>(rsz),
                  static_cast<const int*>(lo),
                  static_cast<const int*>(hi),
                  tm,
                  max_steps,
                  measure,
                  p,
                  q};
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream`
// without synchronising and returns the launch's cudaError_t (0 on
// success).
extern "C" int lfvt_walk_live_tiled_launch(
    const void* ti, int n_tiles, const void* lane_pos, const void* lane_rem,
    int lr, const void* nxt, const void* seq, const void* ssz, int np,
    const void* rsz, const void* lo, const void* hi, int tm, int max_steps,
    int measure, int p, int q, void* scratch, void* mask, void* counts,
    void* steps, void* stops, void* stream) {
  if (n_tiles <= 0) return 0;
  lfvt_walk_kernel<<<n_tiles, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ti),
      make_args(lane_pos, lane_rem, lr, nxt, seq, ssz, np, rsz, lo, hi, tm,
                max_steps, measure, p, q),
      static_cast<int*>(scratch), static_cast<uint8_t*>(mask),
      static_cast<int*>(counts), static_cast<int*>(steps),
      static_cast<int*>(stops));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lfvt_walk_planned_launch(
    const void* ti_sorted, const void* n_live, int m_tiles,
    const void* lane_pos, const void* lane_rem, int lr, const void* nxt,
    const void* seq, const void* ssz, int np, const void* rsz,
    const void* lo, const void* hi, int tm, int max_steps, int measure,
    int p, int q, void* scratch, void* mask, void* counts, void* steps,
    void* stops, void* stream) {
  if (m_tiles <= 0) return 0;
  if ((np % 16) != 0) return static_cast<int>(cudaErrorInvalidValue);
  lfvt_walk_planned_kernel<<<m_tiles, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ti_sorted), static_cast<const int*>(n_live),
      make_args(lane_pos, lane_rem, lr, nxt, seq, ssz, np, rsz, lo, hi, tm,
                max_steps, measure, p, q),
      static_cast<int*>(scratch), static_cast<uint8_t*>(mask),
      static_cast<int*>(counts), static_cast<int*>(steps),
      static_cast<int*>(stops));
  return static_cast<int>(cudaGetLastError());
}
