// Single-token GQA decode attention over layer `li` of the stacked int8 KV
// cache, and the same with the per-layer prologue fused in front of it.
//
// Replaces acestep_tpu/ops/pallas/decode_attn.py:
//   decode_attn_kernel       <- _kernel (:57), via decode_attention_int8_stacked
//   decode_attn_fused_kernel <- _fused_kernel (:145), via decode_attention_fused_stacked
//
// One block of 128 threads per (sequence b, kv head h); it serves the G query
// heads of that kv head.  The cache is walked in blocks of `tb` positions (the
// Pallas kernel's T block, the largest of 1024/512/256/128 dividing T) with an
// online softmax, so the bf16 rounding of p * v_scale happens against the same
// running max as on the TPU.  Only the blocks that hold positions < length[b]
// are read.  The online softmax is seeded with the current token's unquantized
// self term: m = q.k_self / sqrt(D), l = 1, acc = v_self.
//
// Bound: bytes.  A call reads length[b] rows of int8 K and V (2 x 128 bytes)
// and their two f32 scales per (b, h): at B = 1, length 1024 that is 2.1 MB
// per layer, against ~1 MFLOP.  The design reads each K/V row once, 16 bytes a
// thread (K: one row per thread; V: one row per warp), and keeps scores and
// the running state in shared memory.  Grid parallelism is B x Hkv blocks,
// which leaves most SMs idle at B = 1 (split-T with a combine step is a later
// optimisation).
//
// Numerics (the Pallas kernels'): q is bf16; scores are bf16 q . (int8 -> bf16)
// K accumulated in f32, times 1/sqrt(D), times the K scale; softmax state f32;
// the probabilities times the V scale are rounded to bf16 for the PV product,
// accumulated in f32.  The fused prologue rounds to bf16 after the q/k RMSNorm
// and after the NEOX rope, and quantizes the new K/V as kv_cache.quantize_kv.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;           // head dim (the only one the kernels take)
constexpr int THREADS = 128;     // one thread per head-dim lane in the prologue
constexpr int WARPS = THREADS / 32;
constexpr int MAXG = 8;          // query heads per kv head
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum over the block's 128 threads, in a fixed order; every thread gets it.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += red[w];
  return s;
}

__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) m = fmaxf(m, red[w]);
  return m;
}

// kv_cache.quantize_kv on one row of D values held one per thread.
__device__ void quantize_row(float x, float* red, int8_t* q_out, float* s_out) {
  const float amax = block_max(fabsf(x), red);
  const float scale = amax / 127.f;
  const float inv = scale > 0.f ? 1.f / fmaxf(scale, 1e-30f) : 0.f;
  const float r = fminf(fmaxf(rintf(__fmul_rn(x, inv)), -127.f), 127.f);
  q_out[threadIdx.x] = (int8_t)r;
  if (threadIdx.x == 0) *s_out = scale;
}

// RMSNorm (rounded to bf16) then NEOX rope (rounded to bf16) of one row of D
// values held one per thread; `xch` is D floats of scratch for the rotation.
__device__ float norm_rope(float x, float w, float c, float s, float eps, float* red,
                           float* xch) {
  const float var = block_sum(__fmul_rn(x, x), red) / (float)D;
  const float y = bf16r(__fmul_rn(__fmul_rn(x, 1.f / sqrtf(var + eps)), w));
  __syncthreads();
  xch[threadIdx.x] = y;
  __syncthreads();
  const int d = threadIdx.x;
  const float rot = d < D / 2 ? -xch[d + D / 2] : xch[d - D / 2];
  return bf16r(__fadd_rn(__fmul_rn(y, c), __fmul_rn(rot, s)));
}

struct Args {
  const __nv_bfloat16* q;        // [B, Hq, D] (row 9: post-rope; row 10: raw)
  const __nv_bfloat16* k_in;     // [B, Hkv, D] row 9: k_self; row 10: k raw
  const __nv_bfloat16* v_in;     // [B, Hkv, D] row 9: v_self; row 10: v raw
  const float* q_norm;           // [D] (row 10)
  const float* k_norm;           // [D] (row 10)
  const float* cos;              // [B, D] (row 10)
  const float* sin;              // [B, D] (row 10)
  const int8_t* kc;              // [L, B, Hkv, T, D]
  const float* ksc;              // [L, B, Hkv, T]
  const int8_t* vc;
  const float* vsc;
  const int* lengths;            // [B]
  float* out;                    // [B, Hq, D]
  int8_t* k_new;                 // [B, Hkv, D] (row 10)
  float* ks_new;                 // [B, Hkv] (row 10)
  int8_t* v_new;
  float* vs_new;
  int B, Hq, Hkv, T, li, tb;
  float eps;
};

template <bool FUSED>
__global__ void __launch_bounds__(THREADS) decode_attn_kernel(Args a) {
  extern __shared__ float smem[];
  const int G = a.Hq / a.Hkv;
  const int b = blockIdx.x / a.Hkv, h = blockIdx.x % a.Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tb = a.tb;
  float* qs = smem;                      // [G][D] bf16-valued query
  float* kself = qs + MAXG * D;          // [D]
  float* vself = kself + D;              // [D]
  float* red = vself + D;                // [WARPS]
  float* st = red + WARPS;               // [4][MAXG] m, l, alpha, m_new
  float* sc = st + 4 * MAXG;             // [G][tb] scores, then probabilities
  float* m_run = st, *l_run = st + MAXG, *alpha = st + 2 * MAXG;
  const float sm_scale = 1.f / sqrtf((float)D);

  // ---- this token's q, k, v (with the prologue in the fused kernel) ----
  const size_t kv_row = ((size_t)b * a.Hkv + h) * D;
  if (FUSED) {
    const float c = a.cos[(size_t)b * D + tid], s = a.sin[(size_t)b * D + tid];
    for (int g = 0; g < G; ++g) {
      const float x = __bfloat162float(a.q[((size_t)b * a.Hq + h * G + g) * D + tid]);
      qs[g * D + tid] = norm_rope(x, a.q_norm[tid], c, s, a.eps, red, sc);
    }
    const float kx = norm_rope(__bfloat162float(a.k_in[kv_row + tid]), a.k_norm[tid], c, s,
                               a.eps, red, sc);
    const float vx = __bfloat162float(a.v_in[kv_row + tid]);
    kself[tid] = kx;
    vself[tid] = vx;
    quantize_row(kx, red, a.k_new + kv_row, a.ks_new + (size_t)b * a.Hkv + h);
    quantize_row(vx, red, a.v_new + kv_row, a.vs_new + (size_t)b * a.Hkv + h);
  } else {
    for (int i = tid; i < G * D; i += THREADS)
      qs[i] = __bfloat162float(a.q[((size_t)b * a.Hq + h * G) * D + i]);
    kself[tid] = __bfloat162float(a.k_in[kv_row + tid]);
    vself[tid] = __bfloat162float(a.v_in[kv_row + tid]);
  }
  __syncthreads();

  // ---- seed: m = s_self, l = 1, acc = v_self ----
  for (int g = warp; g < G; g += WARPS) {
    float p = 0.f;
    for (int d = lane; d < D; d += 32) p += qs[g * D + d] * kself[d];
    p = warp_sum(p);
    if (lane == 0) {
      m_run[g] = p * sm_scale;
      l_run[g] = 1.f;
    }
  }
  // PV accumulators: lane owns dims 4*lane..4*lane+3, warp w the positions
  // t = w (mod WARPS) of each block; warp 0 carries the self term
  float acc[MAXG][4];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[g][j] = warp == 0 ? vself[4 * lane + j] : 0.f;
  __syncthreads();

  const int length = a.lengths[b];
  const int nblk = max(length - 1, 0) / tb + 1;
  const size_t cache_row0 = (((size_t)a.li * a.B + b) * a.Hkv + h) * (size_t)a.T;
  const int8_t* kc = a.kc + cache_row0 * D;
  const int8_t* vc = a.vc + cache_row0 * D;
  const float* ksc = a.ksc + cache_row0;
  const float* vsc = a.vsc + cache_row0;

  for (int blk = 0; blk < nblk; ++blk) {
    const int t0 = blk * tb;
    // scores: one cache row per thread, 8 x 16-byte loads
    for (int p = tid; p < tb; p += THREADS) {
      const int t = t0 + p;
      float dot[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) dot[g] = 0.f;
      const int4* krow = reinterpret_cast<const int4*>(kc + (size_t)t * D);
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const int4 w = __ldg(krow + c);
        const int8_t* k8 = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const float kv = (float)k8[e];
#pragma unroll
          for (int g = 0; g < MAXG; ++g)
            if (g < G) dot[g] = fmaf(qs[g * D + c * 16 + e], kv, dot[g]);
        }
      }
      const float ks = ksc[t];
      for (int g = 0; g < G; ++g)
        sc[g * tb + p] = t < length ? (dot[g] * sm_scale) * ks : NEG_INF;
    }
    __syncthreads();
    // online softmax update, one warp per head
    for (int g = warp; g < G; g += WARPS) {
      float mx = NEG_INF;
      for (int p = lane; p < tb; p += 32) mx = fmaxf(mx, sc[g * tb + p]);
      mx = warp_max(mx);
      const float m_new = fmaxf(m_run[g], mx);
      float sum = 0.f;
      for (int p = lane; p < tb; p += 32) {
        const float e = expf(sc[g * tb + p] - m_new);
        sc[g * tb + p] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float al = expf(m_run[g] - m_new);
        alpha[g] = al;
        l_run[g] = l_run[g] * al + sum;
        m_run[g] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < G) {
        const float al = alpha[g];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[g][j] *= al;
      }
    for (int p = warp; p < tb; p += WARPS) {
      const int t = t0 + p;
      const char4 v4 = __ldg(reinterpret_cast<const char4*>(vc + (size_t)t * D) + lane);
      const float vs = vsc[t];
      const float v[4] = {(float)v4.x, (float)v4.y, (float)v4.z, (float)v4.w};
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) {
          const float pv = bf16r(sc[g * tb + p] * vs);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[g][j] = fmaf(pv, v[j], acc[g][j]);
        }
    }
    __syncthreads();
  }

  // ---- combine the warps' accumulators and normalise ----
  float* part = sc;                      // [WARPS][G][D]
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
    if (g < G)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[(warp * G + g) * D + 4 * lane + j] = acc[g][j];
  __syncthreads();
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += part[w * G * D + i];
    a.out[((size_t)b * a.Hq + h * G) * D + i] = s / l_run[g];
  }
}

size_t smem_bytes(int G, int tb) {
  const int sc = G * tb > WARPS * G * D ? G * tb : WARPS * G * D;
  return sizeof(float) * (size_t)(MAXG * D + 2 * D + WARPS + 4 * MAXG + sc);
}

template <bool FUSED>
int launch(const Args& a, void* stream) {
  const int G = a.Hq / a.Hkv;
  if (G < 1 || G > MAXG || a.Hq % a.Hkv || a.T % a.tb || a.tb % 128) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(G, a.tb);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attn_kernel<FUSED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  decode_attn_kernel<FUSED><<<a.B * a.Hkv, THREADS, smem, (cudaStream_t)stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int acestep_decode_attn(const void* q, const void* kc, const void* ksc,
                                   const void* vc, const void* vsc, const void* lengths,
                                   const void* k_self, const void* v_self, void* out, int B,
                                   int Hq, int Hkv, int T, int li, int tb, void* stream) {
  Args a{};
  a.q = (const __nv_bfloat16*)q;
  a.k_in = (const __nv_bfloat16*)k_self;
  a.v_in = (const __nv_bfloat16*)v_self;
  a.kc = (const int8_t*)kc;
  a.ksc = (const float*)ksc;
  a.vc = (const int8_t*)vc;
  a.vsc = (const float*)vsc;
  a.lengths = (const int*)lengths;
  a.out = (float*)out;
  a.B = B; a.Hq = Hq; a.Hkv = Hkv; a.T = T; a.li = li; a.tb = tb;
  return launch<false>(a, stream);
}

extern "C" int acestep_decode_attn_fused(
    const void* q_raw, const void* k_raw, const void* v_raw, const void* q_norm,
    const void* k_norm, const void* cos, const void* sin, const void* kc, const void* ksc,
    const void* vc, const void* vsc, const void* lengths, void* out, void* k_new,
    void* ks_new, void* v_new, void* vs_new, int B, int Hq, int Hkv, int T, int li, int tb,
    float eps, void* stream) {
  Args a{};
  a.q = (const __nv_bfloat16*)q_raw;
  a.k_in = (const __nv_bfloat16*)k_raw;
  a.v_in = (const __nv_bfloat16*)v_raw;
  a.q_norm = (const float*)q_norm;
  a.k_norm = (const float*)k_norm;
  a.cos = (const float*)cos;
  a.sin = (const float*)sin;
  a.kc = (const int8_t*)kc;
  a.ksc = (const float*)ksc;
  a.vc = (const int8_t*)vc;
  a.vsc = (const float*)vsc;
  a.lengths = (const int*)lengths;
  a.out = (float*)out;
  a.k_new = (int8_t*)k_new;
  a.ks_new = (float*)ks_new;
  a.v_new = (int8_t*)v_new;
  a.vs_new = (float*)vs_new;
  a.B = B; a.Hq = Hq; a.Hkv = Hkv; a.T = T; a.li = li; a.tb = tb; a.eps = eps;
  return launch<true>(a, stream);
}
