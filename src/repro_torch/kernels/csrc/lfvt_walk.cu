// K1 and K6: the flat-LFVT walk over row tiles (CF-RS-Join/LFVT), sm_90a.
//
// Replaces the Pallas TPU kernel `lfvt_walk_live_tiled` of the JAX
// package (src/repro/kernels/lfvt_walk.py, body `_walk_kernel`). It
// computes the same function: for every live row tile of a size-sorted R
// block, each R element's lane walks the fused `seq_row`/`seq_next` chain
// from its entry position for at most `rem` steps (and `max_steps`), adds
// 1 to the count of each S row it emits, and dies at the first row below
// its window's `lo` (Theorem 3.3). The tile then applies the measure
// predicate and the [lo, hi) column window and writes its mask, its pair
// count, its `walk_steps` and its `early_stops`.
//
// Design. No output depends on the order of the lanes' steps: the counts
// and the mask are sums over lanes, a tile's `walk_steps` is the max over
// its lanes of each lane's step count (a lane is live on a prefix of the
// tile's steps), and `early_stops` counts the lanes that stop at a row
// below lo with rem > 1. So the walk is cut finer than the tile:
//   * One CTA of 1 024 threads per (tile, row): tm CTAs a tile, L x tm
//     (K1) or m_tiles x tm (K6) a launch, 1 024 and 256 at the repo's
//     livej block and serve batch where one CTA a tile made 64 and 16.
//     The CTAs of one tile add their row's pair count and early stops to
//     the tile's slot and take the max of their step counts there
//     (global atomics into outputs the wrapper zeroes on the stream).
//   * The row's counts over its window live in dynamic shared memory as
//     int32 (`cols` columns, at most kMaxCols = 224 KiB), never in device
//     memory. The wrapper asks for NP columns rounded up to 16, at most
//     kMaxCols (one CTA of 1 024 threads at 64 registers fills an SM's
//     register file, so a smaller request would not fit a second CTA).
//     A window wider than `cols` is covered in column passes of
//     `cols` columns, each walking the row's lanes again; the counters
//     come from the first pass only. Pass boundaries sit on 16-column
//     chunks, so each pass qualifies and stores whole 16-byte chunks of
//     the mask row, and a final loop zeroes the chunks outside the window.
//   * Warps scan runs. Inside an LFVT node the hop is always p - 1, so on
//     the repo's data a lane walks thousands of positions in ~1.1 runs:
//     the walk is a stream of contiguous reads of `seq_row`/`seq_next`.
//     The CTA's warps form teams of kTeamWarps; team m walks the row's
//     lanes m, m + kTeams, ... (entry_state sorts them by rem, longest
//     first). A team step covers kTeamSpan positions p, p - 1, ...: each
//     warp scans kScans x 32 of them, 32 at a time (thread t reads
//     position p' - t, coalesced), and two ballots a scan find the first
//     position whose hop is not the position below (a run break) and the
//     first row below lo; the warps post their first event to shared
//     memory and, after the team's barrier, every thread takes the team's
//     first one. The lane steps every position before it (and that one),
//     under the rem and max_steps caps; its count adds (rows in the
//     window and in this pass's columns, as shared-memory atomics), its
//     step count and its early stop follow exactly. It then goes on at the
//     break's hop, or kTeamSpan positions further down the run, which the
//     team loaded while deciding this step. The events of a step are found
//     in parallel, so a long lane (the longest take ~100 000 steps on the
//     livej data) no longer waits out one dependent round trip per 32
//     positions. No order of rows is assumed: tables grown by
//     IncrementalLFVT walk hops that do not lower the row, so a run is
//     scanned, never searched.
//   * The hop clamps at the root: pos = max(seq_next[pos], 0). So
//     position 0 (seq_next = -1) hops to itself; every position whose hop
//     is not p - 1 counts as a break, and a position that hops to itself
//     is stepped in closed form until rem or max_steps runs out.
//
// Bound on this card. The function must read its inputs once (the
// seq_row/seq_next chains, the lane state, the row columns) and write the
// tm x NP mask bytes per tile, at 3.35 TB/s of HBM, and do a few int32
// operations per lane step and per in-window mask cell; chip_smoke.py
// computes both from each run's data. This design reads each lane step's
// 8 bytes of seq_row/seq_next once, in 128-byte lines from L2 (the chains
// of the repo's largest corpus take ~28 MB), so its floor is the L2 read
// rate over the lane steps, not the bound: every R element's lane walks
// its chain on its own, and a hot element's chain is read once for each
// row that holds the element.
//
// K6 replaces the Pallas TPU kernel `lfvt_walk_planned` (same file, body
// `_walk_kernel_planned`): K1 over a device-planned schedule. The wrapper
// passes `ti_sorted` (every tile id, the live ones first) and `n_live` (a
// device scalar) from `plan_row_tiles_device`, so the host never learns
// the live count and the grid covers all m_tiles x tm rows. A CTA of tile
// slot l reads n_live from device memory; if l >= n_live it writes its
// mask row's zeros and returns (its counters stay 0), else it walks its
// row of tile ti_sorted[l]. Every output lands at the tile's own slot,
// ti_sorted[l] (a permutation), so the outputs come back in tile order.
//
// Window bounds are clamped into [0, NP) before any count or mask access,
// which leaves the result unchanged (columns outside [0, NP) do not
// exist). The mask rows are written in 16-byte stores when NP is a
// multiple of 16 (the dispatch pads columns to 128), bytewise otherwise.
//
// Integer algebra. The predicate is `qualify` of qualify.cuh, shared by
// every kernel of the port: the reference's exact int32 algebra.
#include <cuda_runtime.h>
#include <stdint.h>

#include "qualify.cuh"

namespace {

constexpr int kThreads = 1024;
// A team of kTeamWarps warps walks one lane; a warp scans kScans x 32
// positions of each team step.
constexpr int kTeamWarps = 4;
constexpr int kScans = 8;
constexpr int kTeams = kThreads / 32 / kTeamWarps;
constexpr int kWarpSpan = 32 * kScans;
constexpr int kTeamSpan = kTeamWarps * kWarpSpan;
static_assert(kTeams < 16, "team m syncs on named barrier m + 1 of 16");
constexpr unsigned kFull = 0xffffffffu;
// int32 count columns a CTA may hold: 224 KiB of the 227 KB a block can
// use on sm_90, the rest left to the static counters
constexpr int kMaxCols = 57344;

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
  int cols;
};

// What the count adds of one pass may touch: rows in [cl, ch), at
// acc[row - c0].
struct PassCols {
  int* acc;
  int c0, cl, ch;
};

// The scans of kScans x 32 positions from q downward, thread t taking
// position q - t of each: row and hop column (0 past the front).
__device__ __forceinline__ void load_scans(const int* __restrict__ seq,
                                           const int* __restrict__ nxt,
                                           int q, int (&row)[kScans],
                                           int (&nx)[kScans]) {
#pragma unroll
  for (int i = 0; i < kScans; ++i) {
    const int qi = q - 32 * i;
    row[i] = qi >= 0 ? __ldg(seq + qi) : 0;
    nx[i] = qi >= 0 ? __ldg(nxt + qi) : 0;
  }
}

// Wait for the other warps of team `team` (named barrier team + 1; 0 is
// __syncthreads').
__device__ __forceinline__ void team_sync(int team) {
  asm volatile("bar.sync %0, %1;" ::"r"(team + 1), "n"(kTeamWarps * 32)
               : "memory");
}

// One lane's walk, run by a whole team (every thread of it passes the
// same arguments; `wt` is the warp's place in the team): from position
// `p` for at most `rem` steps and `max_steps`, stopping at the first row
// below `lo`. Adds its rows that fall in the pass's columns to the counts.
// A team step covers kTeamSpan positions p, p - 1, ...: warp wt scans
// kScans x 32 of them from p - wt x kWarpSpan and posts its first event
// (a run break or a row below lo) to `slot`; after the team barrier
// every thread takes the team's first event and adds its positions
// before it. `slot` alternates by `parity`, which persists across lanes,
// so one barrier a step suffices. Returns the step count k and sets
// `stop` when the lane stopped below lo with rem > 1.
__device__ __forceinline__ int walk_lane(const int* __restrict__ seq,
                                         const int* __restrict__ nxt, int p,
                                         int rem, int max_steps, int lo,
                                         const PassCols& pc, int team,
                                         int wt, int2 (*slot)[kTeamWarps],
                                         int& parity, int& stop) {
  const int t = threadIdx.x & 31;
  const int off = wt * kWarpSpan;  // this warp's first place in a step
  int k = 0;
  int row[kScans], nx[kScans];
  load_scans(seq, nxt, p - off - t, row, nx);
  while (true) {
    const int avail = min(rem, max_steps - k);
    if (avail <= 0) return k;
    // the straight continuation, in flight while this step is decided
    int row2[kScans], nx2[kScans];
    load_scans(seq, nxt, p - kTeamSpan - off - t, row2, nx2);
    // this warp's first event, and the hop taken there
    int e = kWarpSpan, e_stop = 0, e_hop = 0;
#pragma unroll
    for (int i = kScans - 1; i >= 0; --i) {
      const int q = p - off - 32 * i - t;
      const int hop = max(nx[i], 0);  // the step loop's clamp at the root
      const unsigned brk = __ballot_sync(kFull, q < 0 || hop != q - 1);
      const unsigned stp = __ballot_sync(kFull, q >= 0 && row[i] < lo);
      if (brk | stp) {
        const int j = __ffs(brk | stp) - 1;
        e = 32 * i + j;
        e_stop = (stp >> j) & 1;
        e_hop = __shfl_sync(kFull, hop, j);
      }
    }
    if (t == 0) slot[parity][wt] = make_int2(2 * e + e_stop, e_hop);
    team_sync(team);
    // the team's first event: E (kTeamSpan when the run goes on)
    int E = kTeamSpan, E_stop = 0, E_hop = 0;
#pragma unroll
    for (int w = kTeamWarps - 1; w >= 0; --w) {
      const int2 v = slot[parity][w];
      if ((v.x >> 1) < kWarpSpan) {
        E = w * kWarpSpan + (v.x >> 1);
        E_stop = v.x & 1;
        E_hop = v.y;
      }
    }
    parity ^= 1;
    if (E == 0 && !E_stop && E_hop == p) {
      // p hops to itself (position 0): the lane steps there until it runs
      // out, adding its row each time
      if (wt == 0 && t == 0 && row[0] >= pc.cl && row[0] < pc.ch)
        atomicAdd(pc.acc + (row[0] - pc.c0), avail);
      return k + avail;
    }
    const int last = min(min(E, kTeamSpan - 1), avail - 1);  // its last step
#pragma unroll
    for (int i = 0; i < kScans; ++i)
      if (off + 32 * i + t <= last && row[i] >= pc.cl && row[i] < pc.ch)
        atomicAdd(pc.acc + (row[i] - pc.c0), 1);
    k += last + 1;
    if (last == E && E_stop) {  // Theorem 3.3's stop, rem - E steps left
      stop = rem - E > 1;
      return k;
    }
    rem -= last + 1;
    if (last == avail - 1) return k;  // rem or max_steps ran out
    if (E < kTeamSpan) {  // the run breaks at p - E: hop there
      p = E_hop;
      load_scans(seq, nxt, p - off - t, row, nx);
    } else {  // kTeamSpan steps down the run
      p -= kTeamSpan;
#pragma unroll
      for (int i = 0; i < kScans; ++i) {
        row[i] = row2[i];
        nx[i] = nx2[i];
      }
    }
  }
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
  for (int off = 16; off > 0; off >>= 1)
    v = max(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// The 16 mask bytes of columns [c, c + 16) of a row: one 16-byte store
// when `vec` (NP % 16 == 0, so every row starts 16-byte aligned), else
// byte stores up to NP.
__device__ __forceinline__ void store16(uint8_t* out, int c, uint4 v, int np,
                                        bool vec) {
  if (vec) {
    *reinterpret_cast<uint4*>(out + c) = v;
    return;
  }
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  for (int i = 0; i < 16 && c + i < np; ++i)
    out[c + i] = static_cast<uint8_t>(w[i >> 2] >> (8 * (i & 3)));
}

// Packed row g's walk and qualify, run by a whole CTA: its mask row
// `out` (np bytes) and its tile's three counters. Every thread of the
// CTA must call it.
__device__ void walk_row(const WalkArgs& a, int g, uint8_t* out, int* count,
                         int* steps, int* stops) {
  extern __shared__ int4 smem[];
  int* acc = reinterpret_cast<int*>(smem);
  __shared__ int s_lanes, s_steps, s_stops, s_count;
  __shared__ int2 s_slot[kTeams][2][kTeamWarps];
  const int t = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int team = warp / kTeamWarps, wt = warp % kTeamWarps;
  const int lo = max(a.lo[g], 0), hi = min(a.hi[g], a.np);
  const int rs = a.rsz[g];
  const int* rem_g = a.lane_rem + static_cast<size_t>(g) * a.lr;
  const int* pos_g = a.lane_pos + static_cast<size_t>(g) * a.lr;
  const bool vec = (a.np & 15) == 0;
  const int nchunks = (a.np + 15) >> 4;
  // the window's 16-column chunks [w0, w1); none when it is empty
  const int w0 = lo < hi ? lo & ~15 : 0;
  const int w1 = lo < hi ? (hi + 15) & ~15 : 0;
  const int passes = lo < hi ? (hi - w0 + a.cols - 1) / a.cols : 1;
  if (threadIdx.x == 0) {
    s_lanes = 0;
    s_steps = 0;
    s_stops = 0;
    s_count = 0;
  }
  __syncthreads();
  // the row's live lanes lie in [0, s_lanes): one past its last rem > 0
  int live_end = 0;
  for (int j = threadIdx.x; j < a.lr; j += blockDim.x)
    if (rem_g[j] > 0) live_end = j + 1;
  live_end = warp_max(live_end);
  if (t == 0 && live_end) atomicMax(&s_lanes, live_end);

  int parity = 0;
  int my_count = 0;
  for (int pass = 0; pass < passes; ++pass) {
    const PassCols pc{acc, w0 + pass * a.cols, max(lo, w0 + pass * a.cols),
                      min(hi, w0 + (pass + 1) * a.cols)};
    for (int c = threadIdx.x; c < pc.ch - pc.c0; c += blockDim.x) acc[c] = 0;
    __syncthreads();
    // team m walks lanes m, m + kTeams, ...: longest first, as they come
    const int n_lanes = s_lanes;
    int my_steps = 0, my_stops = 0;
    for (int j = team; j < n_lanes; j += kTeams) {
      const int rem = rem_g[j];
      if (rem <= 0) continue;
      int stop = 0;
      my_steps = max(my_steps,
                     walk_lane(a.seq, a.nxt, pos_g[j], rem, a.max_steps, lo,
                               pc, team, wt, s_slot[team], parity, stop));
      my_stops += stop;
    }
    if (pass == 0 && t == 0 && wt == 0) {
      if (my_steps) atomicMax(&s_steps, my_steps);
      if (my_stops) atomicAdd(&s_stops, my_stops);
    }
    __syncthreads();
    // qualify this pass's chunks: predicate inside the window, 0 outside
    const int c_end = min(pc.c0 + a.cols, w1);
    for (int c = pc.c0 + 16 * threadIdx.x; c < c_end; c += 16 * blockDim.x) {
      uint32_t w[4] = {0, 0, 0, 0};
      for (int i = 0; i < 16; ++i) {
        const int col = c + i;
        if (col >= lo && col < hi) {
          const bool ok = qualify(acc[col - pc.c0], rs, a.ssz[col],
                                  a.measure, a.p, a.q);
          w[i >> 2] |= static_cast<uint32_t>(ok) << (8 * (i & 3));
          my_count += ok;
        }
      }
      store16(out, c, make_uint4(w[0], w[1], w[2], w[3]), a.np, vec);
    }
    __syncthreads();  // the next pass rewrites acc
  }
  // the chunks outside the window
  for (int i = threadIdx.x; i < nchunks; i += blockDim.x) {
    const int c = i << 4;
    if (c < w0 || c >= w1) store16(out, c, make_uint4(0, 0, 0, 0), a.np, vec);
  }
  my_count = warp_sum(my_count);
  if (t == 0 && my_count) atomicAdd(&s_count, my_count);
  __syncthreads();
  if (threadIdx.x == 0) {
    if (s_count) atomicAdd(count, s_count);
    if (s_steps) atomicMax(steps, s_steps);
    if (s_stops) atomicAdd(stops, s_stops);
  }
}

// K1: CTA b walks row b % tm of live tile ti[b / tm]; outputs at slot
// b / tm.
__global__ void __launch_bounds__(kThreads, 1)
lfvt_walk_kernel(const int* __restrict__ ti, WalkArgs a,
                 uint8_t* __restrict__ mask, int* __restrict__ counts,
                 int* __restrict__ steps, int* __restrict__ stops) {
  const int l = blockIdx.x / a.tm, r = blockIdx.x - l * a.tm;
  walk_row(a, ti[l] * a.tm + r,
           mask + (static_cast<size_t>(l) * a.tm + r) * a.np, counts + l,
           steps + l, stops + l);
}

// K6: CTA b walks row b % tm of tile ti_sorted[b / tm] while b / tm <
// *n_live, else zeroes that row; outputs at the tile's own slot.
__global__ void __launch_bounds__(kThreads, 1)
lfvt_walk_planned_kernel(const int* __restrict__ ti_sorted,
                         const int* __restrict__ n_live, WalkArgs a,
                         uint8_t* __restrict__ mask,
                         int* __restrict__ counts, int* __restrict__ steps,
                         int* __restrict__ stops) {
  const int l = blockIdx.x / a.tm, r = blockIdx.x - l * a.tm;
  const int tile = ti_sorted[l];
  uint8_t* out = mask + (static_cast<size_t>(tile) * a.tm + r) * a.np;
  if (l >= *n_live) {
    // np is a multiple of 16 (the wrapper checks), so the row is aligned
    uint4* out16 = reinterpret_cast<uint4*>(out);
    for (int i = threadIdx.x; i < a.np / 16; i += blockDim.x)
      out16[i] = make_uint4(0, 0, 0, 0);
    return;
  }
  walk_row(a, tile * a.tm + r, out, counts + tile, steps + tile,
           stops + tile);
}

WalkArgs make_args(const void* lane_pos, const void* lane_rem, int lr,
                   const void* nxt, const void* seq, const void* ssz, int np,
                   const void* rsz, const void* lo, const void* hi, int tm,
                   int max_steps, int measure, int p, int q, int cols) {
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
                  q,
                  cols};
}

bool cols_ok(int cols) {
  return cols >= 16 && cols <= kMaxCols && cols % 16 == 0;
}

// Let `kernel` take up to kMaxCols int32 of dynamic shared memory.
cudaError_t allow_smem(const void* kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kMaxCols * static_cast<int>(sizeof(int)));
}

}  // namespace

// The dynamic shared memory one walk CTA asks for when it holds `cols`
// count columns; 0 when the kernels do not take `cols` (not a multiple
// of 16 in [16, 57344]).
extern "C" int lfvt_walk_smem_bytes(int cols) {
  return cols_ok(cols) ? cols * static_cast<int>(sizeof(int)) : 0;
}

// Plain C entry points (bound with ctypes). Each launches on `stream`
// without synchronising and returns the launch's cudaError_t (0 on
// success). `counts`, `steps` and `stops` must be zeroed before the
// launch: the CTAs of a tile add into them.
extern "C" int lfvt_walk_live_tiled_launch(
    const void* ti, int n_tiles, const void* lane_pos, const void* lane_rem,
    int lr, const void* nxt, const void* seq, const void* ssz, int np,
    const void* rsz, const void* lo, const void* hi, int tm, int max_steps,
    int measure, int p, int q, int cols, void* mask, void* counts,
    void* steps, void* stops, void* stream) {
  if (n_tiles <= 0 || tm <= 0) return 0;
  if (!cols_ok(cols)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(
      &lfvt_walk_kernel));
  if (err != cudaSuccess) return static_cast<int>(err);
  lfvt_walk_kernel<<<n_tiles * tm, kThreads, lfvt_walk_smem_bytes(cols),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ti),
      make_args(lane_pos, lane_rem, lr, nxt, seq, ssz, np, rsz, lo, hi, tm,
                max_steps, measure, p, q, cols),
      static_cast<uint8_t*>(mask), static_cast<int*>(counts),
      static_cast<int*>(steps), static_cast<int*>(stops));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lfvt_walk_planned_launch(
    const void* ti_sorted, const void* n_live, int m_tiles,
    const void* lane_pos, const void* lane_rem, int lr, const void* nxt,
    const void* seq, const void* ssz, int np, const void* rsz,
    const void* lo, const void* hi, int tm, int max_steps, int measure,
    int p, int q, int cols, void* mask, void* counts, void* steps,
    void* stops, void* stream) {
  if (m_tiles <= 0 || tm <= 0) return 0;
  if ((np % 16) != 0 || !cols_ok(cols))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(
      &lfvt_walk_planned_kernel));
  if (err != cudaSuccess) return static_cast<int>(err);
  lfvt_walk_planned_kernel<<<m_tiles * tm, kThreads,
                             lfvt_walk_smem_bytes(cols),
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ti_sorted), static_cast<const int*>(n_live),
      make_args(lane_pos, lane_rem, lr, nxt, seq, ssz, np, rsz, lo, hi, tm,
                max_steps, measure, p, q, cols),
      static_cast<uint8_t*>(mask), static_cast<int*>(counts),
      static_cast<int*>(steps), static_cast<int*>(stops));
  return static_cast<int>(cudaGetLastError());
}
