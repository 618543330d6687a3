// q4_0 dequant-matmul for Hopper (sm_90a).
//   out[M, N] = x[M, K] (bf16) @ bf16(dequant(W[K, N])) (+ bias)
// with f32 accumulation; out is bf16 or f32; dequant (nib - 8) * f32(scale[k/32]).
// (q4_k and q6_k have their own kernels, in qmm_kquant.cu.)
//
// Replaces the Pallas kernel acestep_tpu/ops/pallas/qmm.py:164 `_q4_0_kernel`
// (reached through qmm_pallas and, for layer-stacked weights,
// qmm_pallas_stacked; the stacked form needs no separate kernel here: the
// wrapper passes the base pointers of layer `li`).
//
// Bound on the H100: at the 60 s decoder's M = 768 patch rows the products are
// bound by operations (a 2048 x 12288 gate-up product: 38.7 GFLOP = 39 us at
// 989 TFLOP/s against 12.6 MB of q4 weights = 3.8 us at 3.35 TB/s); at the
// text encoder's M = 64 they are bound by bytes.  This design is simple, not
// fast: 64 x 64 output tiles, four warps of WMMA bf16 16x16x16 with f32
// accumulators, so at M = 768 each weight tile is read and dequantized by 12
// row blocks (L2 serves the repeats) and the tensor cores run far below their
// wgmma rate.  qmm_kquant.cu's mainloop (wgmma, a cp.async ring, 128-row
// tiles) can take q4_0 with its own dequant step: later work.
//
// Layouts.  Packed nibble row g*128 + r holds K rows g*256 + r (low nibble) and
// g*256 + 128 + r (high nibble).  A K step is half a fold group: step s (0 or
// 1) of group g takes the 128 K rows g*256 + q*64 + s*32 + i (q = 0..3,
// i = 0..31), i.e. packed nibble rows g*128 + {0, 64} + s*32 + i (both nibbles
// used), so every weight byte is read once per row block.  Shared-memory
// column / row c of a step stands for K row g*256 + (c/32)*64 + s*32 + c%32;
// the x tile is gathered in the same order.  The f32 scales are read as
// stored, not pre-expanded.
//
// Numerics (as qmm.py:18-19 and the JAX dequantize): dequant in f32 (the
// multiply as __fmul_rn, so nvcc does not contract it), one rounding to bf16,
// f32 accumulation; the bias is added in f32 before the single output
// rounding.  K must be a multiple of 256; ragged M and N are masked.  N % 16
// == 0 with 16-byte aligned operands takes the vector path, any other N a
// scalar one.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int FOLD = 256;
constexpr int BM = 64;           // rows of x per block
constexpr int BN = 64;           // output columns per block
constexpr int BK = 128;          // K rows per step: half a fold group
constexpr int THREADS = 128;     // 4 warps, 2x2, each a 32x32 sub-tile
constexpr int A_LD = BK + 8;     // padded smem rows (multiples of 8 elements)
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;
constexpr int A_ELEMS = BM * A_LD;
constexpr int AB_BYTES = (BM * A_LD + BK * B_LD) * 2;
constexpr int C_BYTES = BM * C_LD * 4;
constexpr int SMEM_BYTES = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;

struct QArgs {
  const uint8_t* data;          // [K/2, N] fold-256 nibbles
  const float* scales;          // [K/32, N]
};

// K row of shared-memory column (or B row) c in step s of fold group g
__device__ __forceinline__ int step_k(int g, int s, int c) {
  return g * FOLD + (c >> 5) * 64 + s * 32 + (c & 31);
}

// the dequant rule (both paths call it)
__device__ __forceinline__ float deq(int nib, float sc) { return __fmul_rn((float)(nib - 8), sc); }

// one weight in f32, gathered from the stored fields (scalar path)
__device__ __forceinline__ float dequant_at(const QArgs& a, int gk, int gn, int N) {
  const int g = gk / FOLD, j = gk % FOLD;
  const uint8_t byte = a.data[(size_t)(g * 128 + (j & 127)) * N + gn];
  const int nib = j < 128 ? (byte & 15) : (byte >> 4);
  return deq(nib, a.scales[(size_t)(gk >> 5) * N + gn]);
}

// vector path: per thread 8 x-chunks (8 bf16), two packed nibble rows of 16
// columns, and the scales of the four 32-row ranges
struct Prefetch {
  uint4 x[8];
  uint4 w[2];
  float4 sc[4][4];   // scales of range q
};

__device__ __forceinline__ uint4 ld16(const void* p, bool ok) {
  return ok ? *reinterpret_cast<const uint4*>(p) : make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ void ld16f(float4* dst, const float* p, bool ok) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
    dst[c] = ok ? reinterpret_cast<const float4*>(p)[c] : make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void load_vec(Prefetch& f, const __nv_bfloat16* __restrict__ x,
                                         const QArgs& a, int M, int N, int K, int m0, int n0,
                                         int ks) {
  const int tid = threadIdx.x;
  const int g = ks >> 1, s = ks & 1;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int id = tid + j * THREADS;
    const int gm = m0 + (id >> 4);
    f.x[j] = ld16(x + (size_t)gm * K + step_k(g, s, (id & 15) * 8), gm < M);
  }
  const int i = tid >> 2;
  const int gn = n0 + (tid & 3) * 16;
  const bool ok = gn < N;           // N % 16 == 0: a chunk is all in or all out
#pragma unroll
  for (int v = 0; v < 2; ++v)
    f.w[v] = ld16(a.data + (size_t)(g * 128 + v * 64 + s * 32 + i) * N + gn, ok);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    ld16f(f.sc[q], a.scales + (size_t)(g * 8 + 2 * q + s) * N + gn, ok);
}

__device__ __forceinline__ void store_vec(const Prefetch& f, __nv_bfloat16* As,
                                          __nv_bfloat16* Bs) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int id = tid + j * THREADS;
    *reinterpret_cast<uint4*>(As + (id >> 4) * A_LD + (id & 15) * 8) = f.x[j];
  }
  const int i = tid >> 2, c4 = tid & 3;
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    const uint8_t* wb = reinterpret_cast<const uint8_t*>(&f.w[v]);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = v + 2 * half;           // low nibble: range v; high: range v + 2
      const float* sc = reinterpret_cast<const float*>(&f.sc[q][0]);
      __align__(16) __nv_bfloat16 out[16];
#pragma unroll
      for (int e = 0; e < 16; ++e)
        out[e] = __float2bfloat16(deq(half ? (wb[e] >> 4) : (wb[e] & 15), sc[e]));
      uint4* dst = reinterpret_cast<uint4*>(Bs + (q * 32 + i) * B_LD + c4 * 16);
      dst[0] = reinterpret_cast<const uint4*>(out)[0];
      dst[1] = reinterpret_cast<const uint4*>(out)[1];
    }
  }
}

__device__ __forceinline__ void fill_scalar(__nv_bfloat16* As, __nv_bfloat16* Bs,
                                            const __nv_bfloat16* __restrict__ x,
                                            const QArgs& a, int M, int N, int K, int m0,
                                            int n0, int ks) {
  const int g = ks >> 1, s = ks & 1;
  for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
    const int r = e / BK, c = e % BK;
    const int gm = m0 + r;
    As[r * A_LD + c] = gm < M ? x[(size_t)gm * K + step_k(g, s, c)] : __float2bfloat16(0.0f);
  }
  for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
    const int r = e / BN, c = e % BN;
    const int gn = n0 + c;
    Bs[r * B_LD + c] = __float2bfloat16(gn < N ? dequant_at(a, step_k(g, s, r), gn, N)
                                               : 0.0f);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
qmm_q4_kernel(const __nv_bfloat16* __restrict__ x, const QArgs a,
              const float* __restrict__ bias, void* __restrict__ out, int M, int N, int K,
              int out_bf16) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + A_ELEMS;
  float* Cs = reinterpret_cast<float*>(smem);        // reused after the K loop

  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int steps = K / BK;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  Prefetch f;
  if (VEC) load_vec(f, x, a, M, N, K, m0, n0, 0);
  for (int ks = 0; ks < steps; ++ks) {
    if (VEC) {
      store_vec(f, As, Bs);
    } else {
      fill_scalar(As, Bs, x, a, M, N, K, m0, n0, ks);
    }
    __syncthreads();
    if (VEC && ks + 1 < steps) load_vec(f, x, a, M, N, K, m0, n0, ks + 1);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * B_LD + wn * 32 + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
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

int launch(const void* x, const QArgs& a, const void* bias, void* out, int M, int N, int K,
           int out_bf16, void* stream) {
  if (K % FOLD != 0 || M < 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* bi = static_cast<const float*>(bias);
  const bool vec = N % 16 == 0 && aligned16(x) && aligned16(a.data) && aligned16(a.scales);
  if (vec)
    qmm_q4_kernel<true><<<grid, THREADS, 0, s>>>(xb, a, bi, out, M, N, K, out_bf16);
  else
    qmm_q4_kernel<false><<<grid, THREADS, 0, s>>>(xb, a, bi, out, M, N, K, out_bf16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int acestep_qmm_q4_0(const void* x, const void* data, const void* scales,
                                const void* bias, void* out, int M, int N, int K,
                                int out_bf16, void* stream) {
  QArgs a{};
  a.data = static_cast<const uint8_t*>(data);
  a.scales = static_cast<const float*>(scales);
  return launch(x, a, bias, out, M, N, K, out_bf16, stream);
}
