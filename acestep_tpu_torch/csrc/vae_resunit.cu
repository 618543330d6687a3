// Fused Oobleck residual units for Hopper (sm_90a), f32 throughout.
//
//   unit(x) = x + conv1x1(snake2(conv7_dil(snake1(x))))      snake(v) = v + sin(a v)^2 / (b + 1e-9)
//
// acestep_vae_res_unit replaces acestep_tpu/ops/pallas/vae_resunit.py:52 `_kernel`
// (fused_res_unit, the 256-channel decoder block, dilation d = 1, 3, 9);
// acestep_vae_res_trio replaces vae_resunit.py:255 `_trio_kernel` (fused_res_trio,
// the three chained units d = 1, 3, 9 of a 128-channel block).
//
// Layout: activations [N, L, C] channels-last f32; conv weights [k, Cin, Cout]
// (the JAX package's layout); alpha/beta arrive already exponentiated.
//
// Bound on the H100: operations.  Each output row costs 2*8*C*C f32 flops
// (7 taps + the 1x1) against 8*C bytes of activation traffic, ~256 flop per byte
// at C = 128, far above the f32 machine balance (67 TFLOP/s / 3.35 TB/s = 20).
// The design keeps device-memory traffic at one read and one write per unit
// (per trio for the trio): a block loads one time tile plus its halo into
// shared memory, computes snake, the dilated conv, snake, the 1x1 conv and the
// residual there, and writes the tile once.  The trio keeps the intermediate
// units of its tile on chip and re-computes the halo rows (chained reach
// 3 + 9 + 27 = 39) instead of storing them; its tile is 64 rows (32 for a
// unit), as much as 227 KB of shared memory holds.  The convs are register-tiled f32
// FMAs: lane l of a warp owns C/32 adjacent output channels (weights streamed
// from L2 with 16-byte loads), each warp RT rows (inputs broadcast from shared
// memory).  Simple, not yet fast: no tensor cores (f32 accuracy is required, TF32
// keeps ~3 digits), one block of 8 warps per SM.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;          // 8 warps
constexpr int TL = 32;                // output rows per tile (unit)
constexpr int TRIO_TL = 64;           // output rows per tile (trio: halo 39 per side)
constexpr int RT = 4;                 // rows per warp per pass
constexpr int ROWS_PER_PASS = 8 * RT;
constexpr int TRIO_REACH = 39;        // 3*1 + 3*3 + 3*9

__device__ __forceinline__ float snake(float v, float a, float be) {
  const float s = sinf(a * v);
  return v + (1.0f / (be + 1e-9f)) * (s * s);
}

// out[r, c] = sum_j sum_ci src[r + j*dil, ci] * W[j, ci, c] for r in [0, n_out);
// epi(r, c, acc) consumes each sum.  src holds n_out + (taps-1)*dil rows.
template <int C, typename Epi>
__device__ __forceinline__ void conv_rows(const float* src, int n_out, int dil, int taps,
                                          const float* __restrict__ W, Epi epi) {
  constexpr int CT = C / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = lane * CT;
  for (int base = 0; base < n_out; base += ROWS_PER_PASS) {
    const int r0 = base + warp * RT;
    if (r0 >= n_out) continue;                       // warp-uniform
    int roff[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) roff[r] = min(r0 + r, n_out - 1) * C;
    float acc[RT][CT];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int q = 0; q < CT; ++q) acc[r][q] = 0.0f;
    for (int j = 0; j < taps; ++j) {
      const float* sj = src + j * dil * C;
      const float* wj = W + (size_t)j * C * C + c0;
#pragma unroll 4
      for (int ci = 0; ci < C; ++ci) {
        float wv[CT];
#pragma unroll
        for (int q = 0; q < CT; q += 4) {
          const float4 t = __ldg(reinterpret_cast<const float4*>(wj + (size_t)ci * C + q));
          wv[q] = t.x; wv[q + 1] = t.y; wv[q + 2] = t.z; wv[q + 3] = t.w;
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float s = sj[roff[r] + ci];
#pragma unroll
          for (int q = 0; q < CT; ++q) acc[r][q] = fmaf(s, wv[q], acc[r][q]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (r0 + r < n_out) {
#pragma unroll
        for (int q = 0; q < CT; ++q) epi(r0 + r, c0 + q, acc[r][q]);
      }
    }
  }
}

struct UnitParams {
  const float *w1, *b1, *w2, *b2, *a1, *be1, *a2, *be2;
};

// One residual unit on shared-memory rows.  S: rs source rows whose row 0 is
// at sequence position pos0 (zero outside [0, L)).  T (rs rows) and U
// (rs - 6*dil rows) are scratch.  Output row r (position pos0 + 3*dil + r)
// goes to D: into shared memory (zeroed outside [0, L), so the next chained
// unit sees the sequence's zero padding) or, with to_global, straight to
// device memory (rows past L skipped).  D may alias T, never S or U.
template <int C>
__device__ void res_unit_smem(const float* S, float* T, float* U, int rs, int dil,
                              int pos0, int L, const UnitParams& p, float* D,
                              bool to_global) {
  const int n_out = rs - 6 * dil;
  for (int e = threadIdx.x; e < rs * C; e += THREADS) {
    const int c = e % C;
    T[e] = snake(S[e], p.a1[c], p.be1[c]);
  }
  __syncthreads();
  conv_rows<C>(T, n_out, dil, 7, p.w1, [&](int r, int c, float acc) {
    U[r * C + c] = snake(acc + p.b1[c], p.a2[c], p.be2[c]);
  });
  __syncthreads();
  const int halo = 3 * dil;
  conv_rows<C>(U, n_out, 0, 1, p.w2, [&](int r, int c, float acc) {
    const int pos = pos0 + halo + r;
    const bool valid = pos >= 0 && pos < L;
    const float v = S[(r + halo) * C + c] + (acc + p.b2[c]);
    if (to_global) {
      if (valid) D[(size_t)r * C + c] = v;
    } else {
      D[r * C + c] = valid ? v : 0.0f;
    }
  });
  __syncthreads();
}

template <int C>
__device__ void load_rows(const float* __restrict__ xn, float* S, int rows, int pos0, int L) {
  for (int e = threadIdx.x; e < rows * C; e += THREADS) {
    const int r = e / C, c = e % C;
    const int pos = pos0 + r;
    S[e] = (pos >= 0 && pos < L) ? xn[(size_t)pos * C + c] : 0.0f;
  }
  __syncthreads();
}

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
res_unit_kernel(const float* __restrict__ x, UnitParams p, float* __restrict__ out, int L,
                int dil) {
  extern __shared__ float smem[];
  const int rs = TL + 6 * dil;
  float* S = smem;
  float* T = S + rs * C;
  float* U = T + rs * C;
  const int t0 = blockIdx.x * TL;
  const size_t nb = (size_t)blockIdx.y * L * C;
  load_rows<C>(x + nb, S, rs, t0 - 3 * dil, L);
  res_unit_smem<C>(S, T, U, rs, dil, t0 - 3 * dil, L, p, out + nb + (size_t)t0 * C, true);
}

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
res_trio_kernel(const float* __restrict__ x, UnitParams p0, UnitParams p1, UnitParams p2,
                float* __restrict__ out, int L) {
  extern __shared__ float smem[];
  const int rs = TRIO_TL + 2 * TRIO_REACH;           // 142 source rows
  float* B0 = smem;
  float* B1 = B0 + rs * C;
  float* B2 = B1 + rs * C;                           // rs - 6 rows
  const int t0 = blockIdx.x * TRIO_TL;
  const size_t nb = (size_t)blockIdx.y * L * C;
  load_rows<C>(x + nb, B0, rs, t0 - TRIO_REACH, L);
  // d=1: rows [t0-36, t0+TL+36) -> B1;  d=3: [t0-27, t0+TL+27) -> B0;  d=9: [t0, t0+TL)
  // (TL = TRIO_TL)
  res_unit_smem<C>(B0, B1, B2, rs, 1, t0 - 39, L, p0, B1, false);
  res_unit_smem<C>(B1, B0, B2, rs - 6, 3, t0 - 36, L, p1, B0, false);
  res_unit_smem<C>(B0, B1, B2, rs - 24, 9, t0 - 27, L, p2, out + nb + (size_t)t0 * C, true);
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

UnitParams unit_params(const void* w1, const void* b1, const void* w2, const void* b2,
                       const void* a1, const void* be1, const void* a2, const void* be2,
                       size_t i, int C) {
  const size_t cc = (size_t)C * C;
  return UnitParams{static_cast<const float*>(w1) + i * 7 * cc,
                    static_cast<const float*>(b1) + i * C,
                    static_cast<const float*>(w2) + i * cc,
                    static_cast<const float*>(b2) + i * C,
                    static_cast<const float*>(a1) + i * C,
                    static_cast<const float*>(be1) + i * C,
                    static_cast<const float*>(a2) + i * C,
                    static_cast<const float*>(be2) + i * C};
}

}  // namespace

// Shared-memory bytes a launch needs (the wrapper checks them against the card).
extern "C" int acestep_vae_res_unit_smem(int C, int dilation) {
  return (2 * (TL + 6 * dilation) + TL) * C * 4;
}

extern "C" int acestep_vae_res_trio_smem(int C) {
  const int rs = TRIO_TL + 2 * TRIO_REACH;
  return (3 * rs - 6) * C * 4;
}

extern "C" int acestep_vae_res_unit(const void* x, const void* w1, const void* b1,
                                    const void* w2, const void* b2, const void* a1,
                                    const void* be1, const void* a2, const void* be2,
                                    void* out, int N, int L, int C, int dilation,
                                    void* stream) {
  const UnitParams p = unit_params(w1, b1, w2, b2, a1, be1, a2, be2, 0, C);
  const size_t smem = acestep_vae_res_unit_smem(C, dilation);
  const dim3 grid((L + TL - 1) / TL, N);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (C == 128) {
    if ((err = set_smem(res_unit_kernel<128>, smem))) return err;
    res_unit_kernel<128><<<grid, THREADS, smem, s>>>(static_cast<const float*>(x), p,
                                                    static_cast<float*>(out), L, dilation);
  } else if (C == 256) {
    if ((err = set_smem(res_unit_kernel<256>, smem))) return err;
    res_unit_kernel<256><<<grid, THREADS, smem, s>>>(static_cast<const float*>(x), p,
                                                    static_cast<float*>(out), L, dilation);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int acestep_vae_res_trio(const void* x, const void* w1s, const void* b1s,
                                    const void* w2s, const void* b2s, const void* a1s,
                                    const void* be1s, const void* a2s, const void* be2s,
                                    void* out, int N, int L, int C, void* stream) {
  if (C != 128) return static_cast<int>(cudaErrorInvalidValue);
  UnitParams p[3];
  for (int i = 0; i < 3; ++i) p[i] = unit_params(w1s, b1s, w2s, b2s, a1s, be1s, a2s, be2s, i, C);
  const size_t smem = acestep_vae_res_trio_smem(C);
  const dim3 grid((L + TRIO_TL - 1) / TRIO_TL, N);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if ((err = set_smem(res_trio_kernel<128>, smem))) return err;
  res_trio_kernel<128><<<grid, THREADS, smem, s>>>(static_cast<const float*>(x), p[0], p[1],
                                                  p[2], static_cast<float*>(out), L);
  return static_cast<int>(cudaGetLastError());
}
