// q8_0 dequant-matmul for Hopper (sm_90a):
//   out[M, N] = x[M, K] (bf16) @ bf16(f32(int8 W[K, N]) * f32(scale[K/32, N])) (+ bias)
// with f32 accumulation; out is bf16 or f32.
//
// Replaces the Pallas kernel acestep_tpu/ops/pallas/qmm.py:147 `_q8_kernel`
// (reached through qmm_pallas / qmm_pallas_nd and, for layer-stacked weights,
// qmm_pallas_stacked; the stacked form needs no separate kernel here: the
// wrapper passes the base pointers of layer `li`).
//
// Bound on the H100: at the main path's M = 1..320 rows the product is
// bytes-bound (an int8 weight byte feeds 2*M flops; the card needs ~295 flop per
// byte before the tensor cores bind).  The design reads each weight byte from
// device memory once per 64-row block of x, dequantizes it on its way into shared
// memory (never a bf16 copy of W in device memory), and runs the product on the
// tensor cores (WMMA bf16 16x16x16, f32 accumulators).  The loads of the next
// K tile are issued (16-byte vectors, into registers) before the current tile's
// products, so their latency overlaps that work.  Simple, not yet fast: no
// cp.async/TMA ring, no split-K for grids smaller than the card.
//
// Numerics (as qmm.py:18-19): dequant in f32, one rounding to bf16, f32
// accumulation; bias is added in f32 before the single output rounding.
// Ragged M, N and K edges are masked here (loads read 0, stores are skipped);
// K must be a multiple of 32.  N % 16 == 0 with 16-byte aligned operands takes
// the vector path; any other N a scalar one.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64;           // rows of x per block
constexpr int BN = 64;           // output columns per block
constexpr int BK = 64;           // K per step: two q8_0 blocks
constexpr int THREADS = 128;     // 4 warps, 2x2, each a 32x32 sub-tile
constexpr int A_LD = BK + 8;     // padded smem rows (multiples of 8 elements)
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;
constexpr int A_ELEMS = BM * A_LD;
constexpr int AB_BYTES = (BM * A_LD + BK * B_LD) * 2;
constexpr int C_BYTES = BM * C_LD * 4;
constexpr int SMEM_BYTES = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;

// vector path: per thread 4 x-chunks (8 bf16), 2 w-chunks (16 int8) and their
// 2 x 16 f32 scales per K step
struct Prefetch {
  uint4 x[4];
  uint4 w[2];
  float4 s[2][4];
};

__device__ __forceinline__ void load_vec(Prefetch& f, const __nv_bfloat16* __restrict__ x,
                                         const int8_t* __restrict__ w,
                                         const float* __restrict__ scales, int M, int N, int K,
                                         int m0, int n0, int k0) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int id = tid + i * THREADS;
    const int gm = m0 + (id >> 3), gk = k0 + (id & 7) * 8;
    f.x[i] = (gm < M && gk < K)
                 ? *reinterpret_cast<const uint4*>(x + (size_t)gm * K + gk)
                 : make_uint4(0, 0, 0, 0);
  }
  const int gn = n0 + (tid & 3) * 16;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gk = k0 + (tid >> 2) + 32 * i;      // rows of scale row k0/32 + i
    const bool ok = gk < K && gn < N;
    f.w[i] = ok ? *reinterpret_cast<const uint4*>(w + (size_t)gk * N + gn)
                : make_uint4(0, 0, 0, 0);
    const float4* sp = reinterpret_cast<const float4*>(scales + (size_t)(gk >> 5) * N + gn);
#pragma unroll
    for (int q = 0; q < 4; ++q) f.s[i][q] = ok ? sp[q] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ void store_vec(const Prefetch& f, __nv_bfloat16* As,
                                          __nv_bfloat16* Bs) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int id = tid + i * THREADS;
    *reinterpret_cast<uint4*>(As + (id >> 3) * A_LD + (id & 7) * 8) = f.x[i];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int8_t* q = reinterpret_cast<const int8_t*>(&f.w[i]);
    const float* s = reinterpret_cast<const float*>(&f.s[i][0]);
    __align__(16) __nv_bfloat16 v[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) v[e] = __float2bfloat16((float)q[e] * s[e]);
    uint4* dst = reinterpret_cast<uint4*>(Bs + ((tid >> 2) + 32 * i) * B_LD + (tid & 3) * 16);
    dst[0] = reinterpret_cast<const uint4*>(v)[0];
    dst[1] = reinterpret_cast<const uint4*>(v)[1];
  }
}

__device__ __forceinline__ void fill_scalar(__nv_bfloat16* As, __nv_bfloat16* Bs,
                                            const __nv_bfloat16* __restrict__ x,
                                            const int8_t* __restrict__ w,
                                            const float* __restrict__ scales, int M, int N,
                                            int K, int m0, int n0, int k0) {
  for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
    const int r = e / BK, c = e % BK;
    const int gm = m0 + r, gk = k0 + c;
    As[r * A_LD + c] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : __float2bfloat16(0.0f);
  }
  for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
    const int r = e / BN, c = e % BN;
    const int gk = k0 + r, gn = n0 + c;
    float v = 0.0f;
    if (gk < K && gn < N) v = (float)w[(size_t)gk * N + gn] * scales[(size_t)(gk >> 5) * N + gn];
    Bs[r * B_LD + c] = __float2bfloat16(v);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
qmm_q8_0_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scales, const float* __restrict__ bias,
                void* __restrict__ out, int M, int N, int K, int out_bf16) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + A_ELEMS;
  float* Cs = reinterpret_cast<float*>(smem);        // reused after the K loop

  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  Prefetch f;
  if (VEC) load_vec(f, x, w, scales, M, N, K, m0, n0, 0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    if (VEC) {
      store_vec(f, As, Bs);
    } else {
      fill_scalar(As, Bs, x, w, scales, M, N, K, m0, n0, k0);
    }
    __syncthreads();
    if (VEC && k0 + BK < K) load_vec(f, x, w, scales, M, N, K, m0, n0, k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * B_LD + wn * 32 + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * C_LD + wn * 32 + j * 16,
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();

  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    const int r = e / BN, c = e % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < N) {
      float v = Cs[r * C_LD + c];
      if (bias != nullptr) v += bias[gn];
      if (out_bf16)
        static_cast<__nv_bfloat16*>(out)[(size_t)gm * N + gn] = __float2bfloat16(v);
      else
        static_cast<float*>(out)[(size_t)gm * N + gn] = v;
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" int acestep_qmm_q8_0(const void* x, const void* w, const void* scales,
                                const void* bias, void* out, int M, int N, int K,
                                int out_bf16, void* stream) {
  if (K % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wq = static_cast<const int8_t*>(w);
  const auto* sc = static_cast<const float*>(scales);
  const auto* bi = static_cast<const float*>(bias);
  if (N % 16 == 0 && aligned16(x) && aligned16(w) && aligned16(scales))
    qmm_q8_0_kernel<true><<<grid, THREADS, 0, s>>>(xb, wq, sc, bi, out, M, N, K, out_bf16);
  else
    qmm_q8_0_kernel<false><<<grid, THREADS, 0, s>>>(xb, wq, sc, bi, out, M, N, K, out_bf16);
  return static_cast<int>(cudaGetLastError());
}
