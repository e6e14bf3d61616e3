// K7: causal, optionally sliding-window, flash attention forward, sm_90a.
//
// Replaces the Pallas TPU kernel of the JAX package's
// src/repro/kernels/flash_attention.py: `flash_attention_bhld` (body
// `_kernel`). q, k, v are (B*H, Lpad, D), KV already expanded to H heads;
// per row q < l_real the output is softmax(q k^T * D^-0.5) v over the keys
// k <= q, k < l_real and, with a window, k > q - window. Rows >= l_real are
// not written. The numerics are the reference's: scores in float32,
// masked scores -1e30 (never -inf, so a block with no valid key cannot
// give inf - inf), the running max, sum and accumulator in float32, p
// rounded to v's dtype before P.V, and the output divided by
// max(l, 1e-30).
//
// Design. The TPU's (B*H, L/bq, L/bk) grid with `pl.when` skips is not
// carried over: one CTA per (b*h, 64-row q block), heaviest q blocks
// first, loops inside the CTA over only the 64-key blocks that the causal
// and window masks leave, from the block of max(0, q0 - window + 1)
// through the diagonal. The CTA's 4 warps own 16 query rows each. Per key
// block the CTA copies K and V into shared memory with cp.async (rows >=
// l_real zero-filled), V's copy still in flight while the scores are
// computed; each warp then computes its 16 x 64 scores, its rows' online
// softmax (two columns a lane, warp shuffles for the max and the sum),
// and O = O * alpha + P V with O kept in shared memory as float32. bf16
// runs both products on the tensor cores through nvcuda::wmma (m16n16k16,
// float32 accumulators); float32 runs them as CUDA-core FMAs (no TF32).
// D is a runtime argument in {16, 32, 64, 128}; shared memory is
// 110.75 KB (bf16) or 166.75 KB (float32) at D = 128, above the 48 KB
// default, so the entry point raises the kernel's dynamic limit first.
//
// Bound on this card. 4 * (valid (q, k) pairs) * D flops at the bf16
// tensor-core rate (989 TFLOP/s dense), against Q, K, V and O each moved
// once: at the qwen2-1.5b prefill shape (B*H = 96, L = 2048, D = 128) the
// operations bound it, 0.104 ms against 0.060 ms for the bytes
// (chip_smoke.py computes both for each run). This design uses the
// warp-level mma.sync path (wmma), not Hopper's warpgroup wgmma, waits for
// each block's K before its products (no TMA, no multi-stage ring),
// round-trips the accumulator through shared memory every key block, and
// materializes the GQA expansion of K and V; making it fast is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // 4 warps
constexpr int kBq = 64;        // query rows per CTA (16 per warp)
constexpr int kBk = 64;        // keys per block
constexpr float kNeg = -1e30f;

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) / 128 * 128;
}

// Shared memory of one CTA: byte offsets of each region (all 128-byte
// aligned, as wmma wants 32) and row strides in elements, each row padded
// by 16 bytes against bank conflicts.
struct Layout {
  int ldt, lds, ldp, ldo;
  size_t q, k, v, s, p, o, m, l, a, total;
};

template <typename T>
__host__ __device__ Layout make_layout(int d) {
  Layout L;
  L.ldt = d + 16 / static_cast<int>(sizeof(T));    // Q, K, V tiles (T)
  L.lds = kBk + 4;                                  // scores (float)
  L.ldp = kBk + 16 / static_cast<int>(sizeof(T));  // P (T)
  L.ldo = d + 4;                                    // O (float)
  size_t off = 0;
  L.q = off;
  off = align128(off + sizeof(T) * kBq * L.ldt);
  L.k = off;
  off = align128(off + sizeof(T) * kBk * L.ldt);
  L.v = off;
  off = align128(off + sizeof(T) * kBk * L.ldt);
  L.s = off;
  off = align128(off + sizeof(float) * kBq * L.lds);
  L.p = off;
  off = align128(off + sizeof(T) * kBq * L.ldp);
  L.o = off;
  off = align128(off + sizeof(float) * kBq * L.ldo);
  L.m = off;
  off = align128(off + sizeof(float) * kBq);
  L.l = off;
  off = align128(off + sizeof(float) * kBq);
  L.a = off;
  off = align128(off + sizeof(float) * kBq);
  L.total = off;
  return L;
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype
}

// rows [row0, row0 + 64) of a (rows, d) matrix into a shared tile of row
// stride ld with cp.async, 16 bytes a copy, all in flight at once; rows >=
// lim are zero-filled (source size 0). The caller commits and waits.
template <typename T>
__device__ void load_tile_async(T* dst, int ld, const T* __restrict__ src,
                                int row0, int lim, int d) {
  constexpr int kVec = 16 / sizeof(T);
  const int chunks = d / kVec;
  for (int idx = threadIdx.x; idx < kBk * chunks; idx += kThreads) {
    const int r = idx / chunks, c = idx - r * chunks;
    const bool ok = row0 + r < lim;
    const T* g = ok ? src + static_cast<size_t>(row0 + r) * d + c * kVec : src;
    const unsigned s = static_cast<unsigned>(
        __cvta_generic_to_shared(dst + r * ld + c * kVec));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(g), "r"(ok ? 16 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most `n` committed copy groups of this thread are pending
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// scores S = Q K^T (unscaled) of the warp's 16 rows x 64 keys
template <typename T>
__device__ void warp_scores(const T* sq, const T* sk, float* ss,
                            const Layout& L, int d, int warp, int lane) {
  if constexpr (std::is_same_v<T, bf16>) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kBk / 16];
#pragma unroll
    for (int j = 0; j < kBk / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
    for (int kk = 0; kk < d; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, sq + warp * 16 * L.ldt + kk, L.ldt);
#pragma unroll
      for (int j = 0; j < kBk / 16; ++j) {
        // K^T as a column-major (d, 64) operand: element (kk, n) is K[n][kk]
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, sk + 16 * j * L.ldt + kk, L.ldt);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kBk / 16; ++j)
      wmma::store_matrix_sync(ss + warp * 16 * L.lds + 16 * j, acc[j], L.lds,
                              wmma::mem_row_major);
  } else {
    for (int r = 0; r < 16; ++r) {
      const T* qr = sq + (warp * 16 + r) * L.ldt;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const T* kr = sk + (lane + 32 * h) * L.ldt;
        float s = 0.0f;
        for (int c = 0; c < d; ++c) s = fmaf(qr[c], kr[c], s);
        ss[(warp * 16 + r) * L.lds + lane + 32 * h] = s;
      }
    }
  }
}

// O = O * alpha + P V on the warp's 16 rows
template <typename T>
__device__ void warp_pv(const T* sp, const T* sv, float* so, const float* sa,
                        const Layout& L, int d, int warp, int lane) {
  if constexpr (std::is_same_v<T, bf16>) {
    for (int idx = lane; idx < 16 * d; idx += 32) {
      const int r = warp * 16 + idx / d;
      so[r * L.ldo + idx % d] *= sa[r];
    }
    __syncwarp();
    for (int c0 = 0; c0 < d; c0 += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* o_ptr = so + warp * 16 * L.ldo + c0;
      wmma::load_matrix_sync(acc, o_ptr, L.ldo, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBk; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, sp + warp * 16 * L.ldp + kk, L.ldp);
        wmma::load_matrix_sync(b, sv + kk * L.ldt + c0, L.ldt);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(o_ptr, acc, L.ldo, wmma::mem_row_major);
    }
  } else {
    for (int idx = lane; idx < 16 * d; idx += 32) {
      const int r = warp * 16 + idx / d, c = idx % d;
      float acc = so[r * L.ldo + c] * sa[r];
      const T* pr = sp + r * L.ldp;
      for (int j = 0; j < kBk; ++j) acc = fmaf(pr[j], sv[j * L.ldt + c], acc);
      so[r * L.ldo + c] = acc;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int lpad,
                       int d, int l_real, int window, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout<T>(d);
  T* sq = reinterpret_cast<T*>(smem + L.q);
  T* sk = reinterpret_cast<T*>(smem + L.k);
  T* sv = reinterpret_cast<T*>(smem + L.v);
  float* ss = reinterpret_cast<float*>(smem + L.s);
  T* sp = reinterpret_cast<T*>(smem + L.p);
  float* so = reinterpret_cast<float*>(smem + L.o);
  float* sm = reinterpret_cast<float*>(smem + L.m);
  float* sl = reinterpret_cast<float*>(smem + L.l);
  float* sa = reinterpret_cast<float*>(smem + L.a);

  const size_t base = static_cast<size_t>(blockIdx.x) * lpad * d;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBq;  // heaviest first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_tile_async(sq, L.ldt, q + base, q0, l_real, d);
  for (int i = threadIdx.x; i < kBq * L.ldo; i += kThreads) so[i] = 0.0f;
  if (threadIdx.x < kBq) {
    sm[threadIdx.x] = kNeg;
    sl[threadIdx.x] = 0.0f;
  }
  const int q_last = min(q0 + kBq - 1, l_real - 1);
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int kb = k_first / kBk; kb <= q_last / kBk; ++kb) {
    const int k0 = kb * kBk;
    __syncthreads();  // the last block's K, V are read; the init is seen
    load_tile_async(sk, L.ldt, k + base, k0, l_real, d);
    load_tile_async(sv, L.ldt, v + base, k0, l_real, d);
    cp_async_wait<1>();  // Q and K have landed; V may still be in flight
    __syncthreads();
    warp_scores(sq, sk, ss, L, d, warp, lane);
    __syncwarp();
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r, qpos = q0 + row;
      float s[2], mx = kNeg;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = lane + 32 * h, kpos = k0 + col;
        const bool ok = kpos <= qpos && kpos < l_real &&
                        (window <= 0 || kpos > qpos - window);
        s[h] = ok ? ss[row * L.lds + col] * scale : kNeg;
        mx = fmaxf(mx, s[h]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sm[row];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p = expf(s[h] - m_new);
        sum += p;
        sp[row * L.ldp + lane + 32 * h] = from_float<T>(p);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sl[row] = sl[row] * alpha + sum;
        sm[row] = m_new;
        sa[row] = alpha;
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // V has landed (and every warp's P, alpha are its own)
    warp_pv(sp, sv, so, sa, L, d, warp, lane);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kBq * d; idx += kThreads) {
    const int r = idx / d, c = idx - r * d;
    if (q0 + r < l_real)
      o[base + static_cast<size_t>(q0 + r) * d + c] =
          from_float<T>(so[r * L.ldo + c] / fmaxf(sl[r], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int lpad, int d, int l_real, int window, float scale,
           cudaStream_t stream) {
  const size_t bytes = make_layout<T>(d).total;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (l_real + kBq - 1) / kBq);
  flash_attention_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lpad, d, l_real, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). q, k, v, o: (bh, lpad, d)
// contiguous, 16-byte aligned, bf16 (is_bf16 = 1) or float32; window <= 0
// means none. Launches on `stream` without synchronising and returns the
// launch's cudaError_t (0 on success); a D the kernel does not take
// returns cudaErrorInvalidValue and launches nothing.
extern "C" int flash_attention_bhld_launch(const void* q, const void* k,
                                           const void* v, void* o, int bh,
                                           int lpad, int d, int l_real,
                                           int window, float scale,
                                           int is_bf16, void* stream) {
  if (d != 16 && d != 32 && d != 64 && d != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bh <= 0 || l_real <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<bf16>(q, k, v, o, bh, lpad, d, l_real, window,
                                scale, s)
                 : launch<float>(q, k, v, o, bh, lpad, d, l_real, window,
                                 scale, s);
}
