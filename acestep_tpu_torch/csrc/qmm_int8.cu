// int8-activation q8_0 matmul for decode-shaped activations (M <= 16), sm_90a:
//
//   xs[m]     = max_k |x[m, k]| / 127
//   inv[m]    = xs[m] > 0 ? 1 / max(xs[m], 1e-30) : 0
//   xq[m, k]  = clip(rint(x[m, k] * inv[m]), -127, 127)          (int8)
//   acc[m, n] = sum over the K/32 blocks kb, in K order, of
//               f32(int32(sum_{i<32} xq[m, 32 kb + i] * W[32 kb + i, n])) * s[kb, n]
//   out[m, n] = bf16(acc[m, n] * xs[m])
//
// Replaces acestep_tpu/ops/pallas/qmm.py:608 `_int8_core_kernel` (reached
// through qmm_int8_act, :385; the per-row quantizer of :406-411 runs there in
// XLA before the kernel, here as a first kernel of the same entry point).
//
// Bound on the H100: bytes.  At M <= 16 every weight byte feeds at most 32
// integer operations, far below the ~600 a byte the int8 tensor cores need
// before they bind; the work is streaming W (int8) and its f32 scales once.
//
// Design (simple and exact, not yet fast): a block owns 128 output columns
// for all M rows; each lane of a warp owns 4 adjacent columns (4-byte loads,
// a warp reads whole 128-byte rows of W).  The 8 warps of a block take 8
// consecutive 32-row blocks of K at a time; a warp transposes its 32 x 4 bytes
// into 4 columns of packed int8 quads (__byte_perm) and forms each int32
// partial with 8 __dp4a, then the term f32(p) * s.  The terms go to shared
// memory and one thread per (row, column) adds them to its accumulator in K
// order (__fadd_rn(acc, __fmul_rn(p, s))), so the result has the plain
// version's bits whatever the launch.  A grid of N / 128 blocks underfills the
// card on the LM's narrow layer weights (N = 1024: 8 blocks); split-K needs a
// sum order other than K order and is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BN = 128;          // output columns per block (4 per lane)
constexpr int QBLK = 32;         // q8_0 block rows
constexpr int MAXM = 16;

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// One block per row: the row's scale and its int8 values.
template <typename T>
__global__ void __launch_bounds__(THREADS)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ xs,
                     int K) {
  __shared__ float red[WARPS];
  const int m = blockIdx.x, tid = threadIdx.x;
  const T* row = x + (size_t)m * K;
  float amax = 0.f;
  for (int k = tid; k < K; k += THREADS) amax = fmaxf(amax, fabsf(to_f32(row[k])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if ((tid & 31) == 0) red[tid >> 5] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) amax = fmaxf(amax, red[w]);
  const float scale = amax / 127.f;
  const float inv = scale > 0.f ? 1.f / fmaxf(scale, 1e-30f) : 0.f;
  for (int k = tid; k < K; k += THREADS) {
    const float q = rintf(__fmul_rn(to_f32(row[k]), inv));
    xq[(size_t)m * K + k] = (int8_t)fminf(fmaxf(q, -127.f), 127.f);
  }
  if (tid == 0) xs[m] = scale;
}

// terms: dynamic shared memory [WARPS][M][BN] f32.
__global__ void __launch_bounds__(THREADS)
int8_mm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
               const int8_t* __restrict__ w, const float* __restrict__ s,
               __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  extern __shared__ float terms[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BN, col = n0 + 4 * lane;
  const int nkb = K / QBLK;
  const int pairs = M * BN;                       // (row, column) pairs of the block
  float acc[MAXM * BN / THREADS];
#pragma unroll
  for (int i = 0; i < MAXM * BN / THREADS; ++i) acc[i] = 0.f;

  for (int kb0 = 0; kb0 < nkb; kb0 += WARPS) {
    const int kb = kb0 + warp;
    if (kb < nkb) {
      int wv[QBLK];
#pragma unroll
      for (int i = 0; i < QBLK; ++i)
        wv[i] = __ldg(reinterpret_cast<const int*>(w + (size_t)(kb * QBLK + i) * N + col));
      const float4 sc = __ldg(reinterpret_cast<const float4*>(s + (size_t)kb * N + col));
      // 4 rows x 4 columns of bytes -> 4 columns of 4 rows each
      int wc[4][8];
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int a = wv[4 * g], b = wv[4 * g + 1], c = wv[4 * g + 2], d = wv[4 * g + 3];
        const int ab_lo = __byte_perm(a, b, 0x5140), ab_hi = __byte_perm(a, b, 0x7362);
        const int cd_lo = __byte_perm(c, d, 0x5140), cd_hi = __byte_perm(c, d, 0x7362);
        wc[0][g] = __byte_perm(ab_lo, cd_lo, 0x5410);
        wc[1][g] = __byte_perm(ab_lo, cd_lo, 0x7632);
        wc[2][g] = __byte_perm(ab_hi, cd_hi, 0x5410);
        wc[3][g] = __byte_perm(ab_hi, cd_hi, 0x7632);
      }
      const float sj[4] = {sc.x, sc.y, sc.z, sc.w};
      for (int m = 0; m < M; ++m) {
        const int4* xr = reinterpret_cast<const int4*>(xq + (size_t)m * K + kb * QBLK);
        const int4 x0 = __ldg(xr), x1 = __ldg(xr + 1);
        const int xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        float t[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int p = 0;
#pragma unroll
          for (int g = 0; g < 8; ++g) p = __dp4a(xv[g], wc[j][g], p);
          t[j] = __fmul_rn((float)p, sj[j]);
        }
        *reinterpret_cast<float4*>(terms + ((size_t)warp * M + m) * BN + 4 * lane) =
            make_float4(t[0], t[1], t[2], t[3]);
      }
    }
    __syncthreads();
    const int nw = min(WARPS, nkb - kb0);
#pragma unroll
    for (int i = 0; i < MAXM * BN / THREADS; ++i) {
      const int pi = tid + i * THREADS;
      if (pi < pairs)
        for (int ww = 0; ww < nw; ++ww) acc[i] = __fadd_rn(acc[i], terms[(size_t)ww * pairs + pi]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < MAXM * BN / THREADS; ++i) {
    const int pi = tid + i * THREADS;
    if (pi < pairs) {
      const int m = pi / BN, n = n0 + pi % BN;
      out[(size_t)m * N + n] = __float2bfloat16_rn(__fmul_rn(acc[i], xs[m]));
    }
  }
}

}  // namespace

// x [M, K] (bf16, or f32 when x_f32), w int8 [K, N], scales f32 [K/32, N]; xq
// int8 [M, K] and xs f32 [M] are scratch the caller allocates; out bf16 [M, N].
extern "C" int acestep_qmm_int8(const void* x, int x_f32, const void* w, const void* scales,
                                void* xq, void* xs, void* out, int M, int N, int K,
                                void* stream) {
  if (M < 1 || M > MAXM || N % BN || K % QBLK) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_f32)
    quantize_rows_kernel<float><<<M, THREADS, 0, st>>>(static_cast<const float*>(x),
                                                        static_cast<int8_t*>(xq),
                                                        static_cast<float*>(xs), K);
  else
    quantize_rows_kernel<__nv_bfloat16><<<M, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq),
        static_cast<float*>(xs), K);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int smem = WARPS * M * BN * (int)sizeof(float);
  static bool attr_set = false;
  if (!attr_set) {
    e = cudaFuncSetAttribute(int8_mm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             WARPS * MAXM * BN * (int)sizeof(float));
    if (e != cudaSuccess) {
      cudaGetLastError();
      return e;
    }
    attr_set = true;
  }
  int8_mm_kernel<<<N / BN, THREADS, smem, st>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const int8_t*>(w), static_cast<const float*>(scales),
      static_cast<__nv_bfloat16*>(out), M, N, K);
  return cudaGetLastError();
}
