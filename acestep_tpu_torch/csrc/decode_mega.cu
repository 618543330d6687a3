// One LM decode step through every transformer layer in ONE launch.
//
// Replaces acestep_tpu/ops/pallas/decode_mega.py:131 _mega_kernel (via
// decode_layers_mega, :357): q8_0 serving-fused weights (qkv_proj, o_proj,
// gateup_proj, down_proj, stacked [L, K, N]), hidden 1024, head dim 128,
// B <= 8, an int8 KV cache [L, B, Hkv, T, D] read without the current token.
//
// Design: a persistent cooperative kernel (every block resident, grid sized
// from the occupancy query) whose blocks walk the layers together, with a
// hand-written grid barrier between the stages of each layer:
//   S1  RMSNorm(x) -> bf16, qkv GEMV; the last block to finish a 128-column
//       tile (one head) reduces its partials and finishes the head: q/k
//       RMSNorm and NEOX rope, int8 quantization of the new K / V
//   S2  per (b, kv head, 128-position chunk of the cache): scores of the
//       chunk and their max; chunk 0 also the self term
//   S3  per (b, kv head, chunk): the softmax against the max over all chunks
//       and the self term, the chunk's share of the denominator and of P.V
//   S4  o_proj GEMV; its input (one head per 128-row K chunk) is the chunks'
//       shares summed with the self term; the last block to finish a column
//       tile sums its partials and adds the residual
//   S5  post-norm -> bf16, gate-up GEMV, reduced the same way
//   S6  SiLU(gate) * up -> bf16, down_proj GEMV, residual as S4
// Weights are [K, N] with N contiguous: a GEMV work unit is a 128-row x
// 128-column tile, each thread streams 4 adjacent columns of 16 rows as
// 4-byte loads (a warp reads whole 128-byte rows), dequantizes in registers
// and accumulates in f32; the 8 warps' row phases are summed in shared memory.
// Split-K (128-row chunks) gives every GEMV 128-384 units, so the narrow
// o_proj / down_proj (N = 1024) still spread over the whole card, and the
// attention spreads over B x Hkv x (T / 128) units.  No f32 atomics: partials
// go to scratch and are summed in a fixed order, so reruns are bit-identical.
// Everything written inside the launch is read back with ld.global.cg (L2),
// never through the non-coherent L1.
//
// Bound: bytes.  A step streams the 28 layers' q8_0 weights once (~0.44 GB of
// int8 plus their scales at 0.6B) and the valid KV; the GEMVs do 2 x B FLOP
// per weight byte.  What the design costs beyond that: 6 grid barriers a
// layer, and the split-K / split-T partials (a few MB, L2-resident).
//
// Numerics (decode_mega.py:208-354, copied rounding point for rounding point):
//   * the residual x is f32, rounded to bf16 after each residual add;
//   * matmul inputs are bf16 (rms(x) * w, attention out, SiLU(gate) * up);
//     weights are dequantized in f32 and rounded once to bf16; f32 sums;
//   * qkv stays f32; q/k RMSNorm and rope in f32, unrounded;
//   * scores: bf16(q) . (int8 -> bf16) K in f32, times 1/sqrt(D), times the
//     K scale; the self term is the f32 dot of the unrounded q and k;
//   * softmax in f32 against the max over all valid positions and the self
//     term; the probabilities times the V scale are rounded to bf16 for the
//     PV product; the self term adds e_self * v in f32;
//   * act = bf16(bf16(silu(gate)) * bf16(up)).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_sync.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int D = 128;          // head dim
constexpr int TILE = 128;       // GEMV tile: 128 rows (K) x 128 columns (N)
constexpr int TCH = 128;        // cache positions per attention unit
constexpr int MAXB = 8;
constexpr int MAXG = 4;         // query heads per kv head
constexpr int QBLK = 32;        // q8_0 block rows
constexpr int STAGES = 6;
constexpr float NEG = -1e30f;

struct Params {
  // per-layer stacked q8_0 weights: data int8 [L, K, N], scales [L, K/32, N]
  const int8_t* qkv_d; const void* qkv_s;
  const int8_t* o_d;   const void* o_s;
  const int8_t* gu_d;  const void* gu_s;
  const int8_t* dn_d;  const void* dn_s;
  int scales_f16;                        // 1: f16 scales, 0: f32
  const float* in_norm;                  // [L, H]
  const float* post_norm;                // [L, H]
  const float* q_norm;                   // [L, D]
  const float* k_norm;                   // [L, D]
  const int8_t* kc; const float* ksc;    // [L, B, Hkv, T, D], [L, B, Hkv, T]
  const int8_t* vc; const float* vsc;
  const int* lengths;                    // [B]
  const float* x0;                       // [B, H]
  const float* cos; const float* sin;    // [B, D]
  float* x;                              // [B, H] residual stream and output
  int8_t* k_new; float* ks_new;          // [L, B, Hkv, D], [L, B, Hkv]
  int8_t* v_new; float* vs_new;
  // scratch (f32): the current layer's head vectors and attention partials
  float* qf;                             // [B, Hq, D] normed, roped q
  float* kf;                             // [B, Hkv, D] normed, roped k
  float* vf;                             // [B, Hkv, D]
  float* scores;                         // [B, Hq, T]
  float* cmax;                           // [B, Hq, NCH] chunk max of the scores
  float* lpart;                          // [B, Hq, NCH] chunk sum of exp
  float* apart;                          // [B, Hq, NCH, D] chunk P.V
  float* sself;                          // [B, Hq] self score
  float* eself;                          // [B, Hq] exp(self score - max)
  float* gu;                             // [B, 2 * I]
  float* part;                           // split-K partials [chunks, B, N]
  unsigned* sync;                        // [0] arrivals, [1] generation, [2..] tile counters
  unsigned long long* stamps;            // optional [2 + STAGES L] %globaltimer ns (block 0)
  int L, B, H, Hq, Hkv, I, T, NCH;
  float eps;
};

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

// Block-wide sum / max in a fixed order; every thread gets the result.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += red[w];
  return s;
}

__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) m = fmaxf(m, red[w]);
  return m;
}

// Block 0 records the time at which a stage boundary was passed (the stage
// durations of one launch, for profiling; off when stamps is null).
__device__ __forceinline__ void stamp(const Params& p, int i) {
  if (p.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    p.stamps[i] = t;
  }
}

__device__ __forceinline__ float4 load_scales(const void* s, int f16, size_t idx) {
  if (f16) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(static_cast<const __half*>(s) + idx));
    const __half2 a = *reinterpret_cast<const __half2*>(&raw.x);
    const __half2 b = *reinterpret_cast<const __half2*>(&raw.y);
    return make_float4(__low2float(a), __high2float(a), __low2float(b), __high2float(b));
  }
  return __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(s) + idx));
}

__device__ __forceinline__ const void* layer_scales(const Params& p, const void* s, size_t n) {
  return p.scales_f16 ? (const void*)((const __half*)s + n) : (const void*)((const float*)s + n);
}

// partial[(kc * B + b) * N + n0 + c] = sum over the 128 rows of chunk kc of
// xs[b][r] * bf16(W[k][n] * s[k / 32][n]), for the tile's 128 columns.
// xs (smem [B][128]) holds the bf16-valued inputs of the chunk's rows.
__device__ void gemv_tile(const Params& p, const int8_t* W, const void* S, int N, int kc,
                          int n0, const float* xs, float* red) {
  const int tid = threadIdx.x, cg = tid & 31, rp = tid >> 5;
  const int k0 = kc * TILE, col = n0 + 4 * cg;
  char4 w[16];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    w[i] = __ldg(reinterpret_cast<const char4*>(W + (size_t)(k0 + rp + 8 * i) * N + col));
  float4 s[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    s[j] = load_scales(S, p.scales_f16, (size_t)(k0 / QBLK + j) * N + col);
  float acc[MAXB][4];
#pragma unroll
  for (int b = 0; b < MAXB; ++b)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[b][c] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float4 sj = s[i / 4];
    const float w0 = bf16r((float)w[i].x * sj.x), w1 = bf16r((float)w[i].y * sj.y);
    const float w2 = bf16r((float)w[i].z * sj.z), w3 = bf16r((float)w[i].w * sj.w);
    const int r = rp + 8 * i;
#pragma unroll
    for (int b = 0; b < MAXB; ++b)
      if (b < p.B) {
        const float xv = xs[b * TILE + r];
        acc[b][0] = fmaf(xv, w0, acc[b][0]);
        acc[b][1] = fmaf(xv, w1, acc[b][1]);
        acc[b][2] = fmaf(xv, w2, acc[b][2]);
        acc[b][3] = fmaf(xv, w3, acc[b][3]);
      }
  }
#pragma unroll
  for (int b = 0; b < MAXB; ++b)
    if (b < p.B)
      *reinterpret_cast<float4*>(red + (rp * MAXB + b) * TILE + 4 * cg) =
          make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
  __syncthreads();
  for (int i = tid; i < p.B * TILE; i += THREADS) {
    const int b = i / TILE, c = i % TILE;
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < WARPS; ++r) v += red[(r * MAXB + b) * TILE + c];
    __stcg(p.part + ((size_t)kc * p.B + b) * N + n0 + c, v);
  }
  __syncthreads();
}

// After a unit's partials: true in the last block to finish column tile `ct`
// of a GEMV with `nk` K-chunks (that block then owns the reduction).
__device__ bool last_for_tile(unsigned* counter, int nk, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned prev = atomicAdd(counter, 1u);
    *flag = prev == (unsigned)(nk - 1);
    if (*flag) atomicExch(counter, 0u);
  }
  __syncthreads();
  const bool last = *flag;
  if (last) __threadfence();
  return last;
}

// The sum of the nk partials of column n of row b, in chunk order, with the
// loads of 8 chunks in flight at a time.
__device__ __forceinline__ float sum_partials(const Params& p, int nk, int N, int b, int n) {
  const float* src = p.part + (size_t)b * N + n;
  const size_t step = (size_t)p.B * N;
  float v = 0.f;
  int j = 0;
  for (; j + 8 <= nk; j += 8) {
    float t[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) t[u] = __ldcg(src + (size_t)(j + u) * step);
#pragma unroll
    for (int u = 0; u < 8; ++u) v += t[u];
  }
  for (; j < nk; ++j) v += __ldcg(src + (size_t)j * step);
  return v;
}

// Per-row 1/rms of the residual stream x [B, H] into rinv[B].
__device__ void rms_rows(const Params& p, float* rinv, float* red) {
  for (int b = 0; b < p.B; ++b) {
    float ss = 0.f;
    for (int k = threadIdx.x; k < p.H; k += THREADS) {
      const float v = __ldcg(p.x + (size_t)b * p.H + k);
      ss = fmaf(v, v, ss);
    }
    ss = block_sum(ss, red);
    if (threadIdx.x == 0) rinv[b] = 1.f / sqrtf(ss / (float)p.H + p.eps);
  }
  __syncthreads();
}

// S1 epilogue for qkv column tile `ct` (one head): warp b finishes row b.
// q head: RMSNorm + rope -> qf; k head: RMSNorm + rope -> kf, int8 -> cache
// row; v head: -> vf, int8 -> cache row.  Lane l holds dims 4l..4l+3; the
// rope partner of dim d is d +- 64, held by lane l ^ 16.
__device__ void finish_head(const Params& p, int l, int ct) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= p.B) return;
  const int b = warp, nqkv = (p.Hq + 2 * p.Hkv) * D;
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = sum_partials(p, p.H / TILE, nqkv, b, ct * TILE + 4 * lane + j);
  const bool is_q = ct < p.Hq, is_k = !is_q && ct < p.Hq + p.Hkv;
  if (is_q || is_k) {
    const float* w = (is_q ? p.q_norm : p.k_norm) + (size_t)l * D + 4 * lane;
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) ss = fmaf(v[j], v[j], ss);
    const float r = 1.f / sqrtf(warp_sum(ss) / (float)D + p.eps);
    float y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = __fmul_rn(__fmul_rn(v[j], r), w[j]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float other = __shfl_xor_sync(0xffffffffu, y[j], 16);
      const float rot = lane < 16 ? -other : other;
      const int d = 4 * lane + j;
      v[j] = __fadd_rn(__fmul_rn(y[j], p.cos[(size_t)b * D + d]),
                       __fmul_rn(rot, p.sin[(size_t)b * D + d]));
    }
  }
  if (is_q) {
    float* dst = p.qf + ((size_t)b * p.Hq + ct) * D + 4 * lane;
#pragma unroll
    for (int j = 0; j < 4; ++j) __stcg(dst + j, v[j]);
    return;
  }
  const int h = is_k ? ct - p.Hq : ct - p.Hq - p.Hkv;
  float* dst = (is_k ? p.kf : p.vf) + ((size_t)b * p.Hkv + h) * D + 4 * lane;
#pragma unroll
  for (int j = 0; j < 4; ++j) __stcg(dst + j, v[j]);
  // kv_cache.quantize_kv for the cache write
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) amax = fmaxf(amax, fabsf(v[j]));
  amax = warp_max(amax);
  const float scale = amax / 127.f;
  const float inv = scale > 0.f ? 1.f / fmaxf(scale, 1e-30f) : 0.f;
  const size_t row = ((size_t)l * p.B + b) * p.Hkv + h;
  char4 q8;
  q8.x = (signed char)fminf(fmaxf(rintf(__fmul_rn(v[0], inv)), -127.f), 127.f);
  q8.y = (signed char)fminf(fmaxf(rintf(__fmul_rn(v[1], inv)), -127.f), 127.f);
  q8.z = (signed char)fminf(fmaxf(rintf(__fmul_rn(v[2], inv)), -127.f), 127.f);
  q8.w = (signed char)fminf(fmaxf(rintf(__fmul_rn(v[3], inv)), -127.f), 127.f);
  *reinterpret_cast<char4*>((is_k ? p.k_new : p.v_new) + row * D + 4 * lane) = q8;
  if (lane == 0) (is_k ? p.ks_new : p.vs_new)[row] = scale;
}

// Attention units: u -> (b, kv head h, chunk c) over B x Hkv x NCH; a chunk
// past a row's length has nothing to do (chunk 0 always runs).
__device__ __forceinline__ bool attn_unit(const Params& p, int u, int* b, int* h, int* c,
                                          int* length) {
  *c = u % p.NCH;
  *h = (u / p.NCH) % p.Hkv;
  *b = u / (p.NCH * p.Hkv);
  *length = p.lengths[*b];
  return *c == 0 || *c * TCH < *length;
}

// S2 for one unit: scores of the chunk's valid positions -> scores, their
// max -> cmax; chunk 0 also the self term (f32 q . k / sqrt(D)) -> sself.
__device__ void scores_unit(const Params& p, int l, int b, int h, int c, int length, float* sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = p.Hq / p.Hkv, hq0 = h * G;
  const float sm_scale = 1.f / sqrtf((float)D);
  float* qb = sm;                       // [G][D] bf16-valued q
  float* red = qb + MAXG * D;           // [WARPS]
  const float* qsrc = p.qf + ((size_t)b * p.Hq + hq0) * D;
  for (int i = tid; i < G * D; i += THREADS) qb[i] = bf16r(__ldcg(qsrc + i));
  if (c == 0) {
    const float* ksrc = p.kf + ((size_t)b * p.Hkv + h) * D;
    for (int g = warp; g < G; g += WARPS) {
      float v = 0.f;
      for (int d = lane; d < D; d += 32) v = fmaf(__ldcg(qsrc + g * D + d), __ldcg(ksrc + d), v);
      v = warp_sum(v);
      if (lane == 0) __stcg(p.sself + (size_t)b * p.Hq + hq0 + g, v * sm_scale);
    }
  }
  __syncthreads();
  // two threads per position, 64 dims each
  const int i = tid >> 1, half = tid & 1;
  const int t = c * TCH + i;
  const bool valid = i < TCH && t < length;
  float dot[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) dot[g] = 0.f;
  if (valid) {
    const size_t row = (((size_t)l * p.B + b) * p.Hkv + h) * (size_t)p.T + t;
    const int4* krow = reinterpret_cast<const int4*>(p.kc + row * D + half * 64);
    int4 kv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) kv[q] = __ldg(krow + q);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int8_t* k8 = reinterpret_cast<const int8_t*>(&kv[q]);
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const float kx = (float)k8[e];
        const int d = half * 64 + q * 16 + e;
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
          if (g < G) dot[g] = fmaf(qb[g * D + d], kx, dot[g]);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < MAXG; ++g) dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], 1);
  float sv[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) sv[g] = NEG;
  if (valid) {
    const float ks = p.ksc[(((size_t)l * p.B + b) * p.Hkv + h) * (size_t)p.T + t];
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < G) {
        sv[g] = (dot[g] * sm_scale) * ks;
        if (half == 0) __stcg(p.scores + ((size_t)b * p.Hq + hq0 + g) * p.T + t, sv[g]);
      }
  }
  for (int g = 0; g < G; ++g) {
    const float m = block_max(sv[g], red);
    if (tid == 0) __stcg(p.cmax + ((size_t)b * p.Hq + hq0 + g) * p.NCH + c, m);
  }
  __syncthreads();
}

// S3 for one unit: m = max(self, every chunk max); e = exp(s - m) over the
// chunk -> lpart (sum of e), apart (sum of bf16(e * v_scale) * v); chunk 0
// also exp(self - m) -> eself.
__device__ void pv_unit(const Params& p, int l, int b, int h, int c, int length, float* sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = p.Hq / p.Hkv, hq0 = h * G;
  const int nch = max(1, (length + TCH - 1) / TCH);
  float* e = sm;                        // [G][TCH]
  float* mrow = e + MAXG * TCH;         // [G]
  float* red = mrow + MAXG;             // [WARPS]
  float* wred = red + WARPS;            // [WARPS][G][D]
  if (warp < G) {
    const size_t bh = (size_t)b * p.Hq + hq0 + warp;
    float m = NEG;
    for (int j = lane; j < nch; j += 32) m = fmaxf(m, __ldcg(p.cmax + bh * p.NCH + j));
    const float ss = __ldcg(p.sself + bh);
    m = fmaxf(warp_max(m), ss);
    if (lane == 0) {
      mrow[warp] = m;
      if (c == 0) __stcg(p.eself + bh, expf(ss - m));
    }
  }
  __syncthreads();
  const size_t row0 = (((size_t)l * p.B + b) * p.Hkv + h) * (size_t)p.T + (size_t)c * TCH;
  const int n = min(TCH, length - c * TCH);         // valid positions of the chunk (may be <= 0)
  for (int i = tid; i < G * TCH; i += THREADS) {
    const int g = i / TCH, k = i % TCH;
    e[i] = k < n ? expf(__ldcg(p.scores + ((size_t)b * p.Hq + hq0 + g) * p.T + c * TCH + k) -
                        mrow[g])
                 : 0.f;
  }
  __syncthreads();
  for (int g = 0; g < G; ++g) {
    const float s = block_sum(tid < TCH ? e[g * TCH + tid] : 0.f, red);
    if (tid == 0) __stcg(p.lpart + ((size_t)b * p.Hq + hq0 + g) * p.NCH + c, s);
  }
  // P.V: warp w takes positions w, w + 8, ... (16 a warp, loads issued first);
  // lane l the dims 4l..4l+3
  float acc[MAXG][4];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[g][j] = 0.f;
  constexpr int PER_WARP = TCH / WARPS;
  char4 v4[PER_WARP];
  float vs[PER_WARP];
#pragma unroll
  for (int r = 0; r < PER_WARP; ++r) {
    const int k = warp + WARPS * r;
    if (k < n) {
      v4[r] = __ldg(reinterpret_cast<const char4*>(p.vc + (row0 + k) * D) + lane);
      vs[r] = p.vsc[row0 + k];
    }
  }
#pragma unroll
  for (int r = 0; r < PER_WARP; ++r) {
    const int k = warp + WARPS * r;
    if (k < n) {
      const float vv[4] = {(float)v4[r].x, (float)v4[r].y, (float)v4[r].z, (float)v4[r].w};
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) {
          const float pv = bf16r(e[g * TCH + k] * vs[r]);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[g][j] = fmaf(pv, vv[j], acc[g][j]);
        }
    }
  }
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
    if (g < G)
#pragma unroll
      for (int j = 0; j < 4; ++j) wred[(warp * G + g) * D + 4 * lane + j] = acc[g][j];
  __syncthreads();
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) o += wred[w * G * D + i];
    __stcg(p.apart + (((size_t)b * p.Hq + hq0 + g) * p.NCH + c) * D + d, o);
  }
  __syncthreads();
}

// The attention output of query head hq, row b, dim d: the chunks' P.V and
// denominators summed in chunk order, plus the self term.
__device__ __forceinline__ float attn_out(const Params& p, int b, int hq, int d) {
  const int nch = max(1, (p.lengths[b] + TCH - 1) / TCH);
  const size_t bh = (size_t)b * p.Hq + hq;
  float acc = 0.f, den = 0.f;
  int c = 0;
  for (; c + 4 <= nch; c += 4) {          // 4 chunks' loads in flight, summed in order
    float a[4], l4[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      a[u] = __ldcg(p.apart + (bh * p.NCH + c + u) * D + d);
      l4[u] = __ldcg(p.lpart + bh * p.NCH + c + u);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      acc += a[u];
      den += l4[u];
    }
  }
  for (; c < nch; ++c) {
    acc += __ldcg(p.apart + (bh * p.NCH + c) * D + d);
    den += __ldcg(p.lpart + bh * p.NCH + c);
  }
  const float es = __ldcg(p.eself + bh);
  const float v = __ldcg(p.vf + ((size_t)b * p.Hkv + hq / (p.Hq / p.Hkv)) * D + d);
  return (acc + es * v) / (den + es);
}

__global__ void __launch_bounds__(THREADS) decode_mega_kernel(Params p) {
  extern __shared__ float sm[];
  __shared__ int flag;
  const int tid = threadIdx.x;
  const int qdim = p.Hq * D, kvdim = p.Hkv * D, nqkv = qdim + 2 * kvdim;
  const int n_h = p.H / TILE;                 // column tiles of o / down
  const int n_qkv = nqkv / TILE;              // column tiles of qkv (one head each)
  const int n_gu = 2 * p.I / TILE;            // column tiles of gate-up
  const int n_attn = p.B * p.Hkv * p.NCH;     // attention units
  unsigned* ctr_qkv = p.sync + 2;
  unsigned* ctr_o = ctr_qkv + n_qkv;
  unsigned* ctr_gu = ctr_o + n_h;
  unsigned* ctr_dn = ctr_gu + n_gu;
  float* xs = sm;                             // [MAXB][TILE] GEMV inputs
  float* rinv = xs + MAXB * TILE;             // [MAXB]
  float* red = rinv + MAXB;                   // [WARPS]
  float* gred = red + WARPS;                  // [WARPS][MAXB][TILE]

  stamp(p, 0);
  for (int i = blockIdx.x * THREADS + tid; i < p.B * p.H; i += gridDim.x * THREADS)
    __stcg(p.x + i, p.x0[i]);
  grid_barrier(p.sync);
  stamp(p, 1);

  for (int l = 0; l < p.L; ++l) {
    // ---- S1: rms(x) -> bf16, qkv partials; tile owners finish the heads ----
    {
      const int8_t* W = p.qkv_d + (size_t)l * p.H * nqkv;
      const void* S = layer_scales(p, p.qkv_s, (size_t)l * (p.H / QBLK) * nqkv);
      const float* w = p.in_norm + (size_t)l * p.H;
      const int nk = p.H / TILE, units = n_qkv * nk;
      if (blockIdx.x < units) rms_rows(p, rinv, red);
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int ct = u % n_qkv, kc = u / n_qkv;
        for (int i = tid; i < p.B * TILE; i += THREADS) {
          const int b = i / TILE, k = kc * TILE + i % TILE;
          xs[i] = bf16r(__fmul_rn(__fmul_rn(__ldcg(p.x + (size_t)b * p.H + k), rinv[b]), w[k]));
        }
        __syncthreads();
        gemv_tile(p, W, S, nqkv, kc, ct * TILE, xs, gred);
        if (last_for_tile(ctr_qkv + ct, nk, &flag)) finish_head(p, l, ct);
        __syncthreads();
      }
    }
    grid_barrier(p.sync);
    stamp(p, 2 + STAGES * l + 0);
    // ---- S2: scores per (b, kv head, chunk) ----
    for (int u = blockIdx.x; u < n_attn; u += gridDim.x) {
      int b, h, c, length;
      if (attn_unit(p, u, &b, &h, &c, &length)) scores_unit(p, l, b, h, c, length, sm);
    }
    grid_barrier(p.sync);
    stamp(p, 2 + STAGES * l + 1);
    // ---- S3: softmax shares and P.V per (b, kv head, chunk) ----
    for (int u = blockIdx.x; u < n_attn; u += gridDim.x) {
      int b, h, c, length;
      if (attn_unit(p, u, &b, &h, &c, &length)) pv_unit(p, l, b, h, c, length, sm);
    }
    grid_barrier(p.sync);
    stamp(p, 2 + STAGES * l + 2);
    // ---- S4: o_proj partials over the combined heads; residual ----
    {
      const int8_t* W = p.o_d + (size_t)l * qdim * p.H;
      const void* S = layer_scales(p, p.o_s, (size_t)l * (qdim / QBLK) * p.H);
      const int nk = qdim / TILE, units = n_h * nk;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int ct = u % n_h, kc = u / n_h;       // K chunk kc = query head kc
        for (int i = tid; i < p.B * TILE; i += THREADS)
          xs[i] = bf16r(attn_out(p, i / TILE, kc, i % TILE));
        __syncthreads();
        gemv_tile(p, W, S, p.H, kc, ct * TILE, xs, gred);
        if (last_for_tile(ctr_o + ct, nk, &flag))
          for (int i = tid; i < p.B * TILE; i += THREADS) {
            const int b = i / TILE, n = ct * TILE + i % TILE;
            const float y = sum_partials(p, nk, p.H, b, n);
            float* xp = p.x + (size_t)b * p.H + n;
            __stcg(xp, bf16r(__ldcg(xp) + y));
          }
        __syncthreads();
      }
    }
    grid_barrier(p.sync);
    stamp(p, 2 + STAGES * l + 3);
    // ---- S5: post-norm -> bf16, gate-up partials; tile owners store gu ----
    {
      const int8_t* W = p.gu_d + (size_t)l * p.H * (2 * p.I);
      const void* S = layer_scales(p, p.gu_s, (size_t)l * (p.H / QBLK) * (2 * p.I));
      const float* w = p.post_norm + (size_t)l * p.H;
      const int nk = p.H / TILE, units = n_gu * nk;
      if (blockIdx.x < units) rms_rows(p, rinv, red);
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int ct = u % n_gu, kc = u / n_gu;
        for (int i = tid; i < p.B * TILE; i += THREADS) {
          const int b = i / TILE, k = kc * TILE + i % TILE;
          xs[i] = bf16r(__fmul_rn(__fmul_rn(__ldcg(p.x + (size_t)b * p.H + k), rinv[b]), w[k]));
        }
        __syncthreads();
        gemv_tile(p, W, S, 2 * p.I, kc, ct * TILE, xs, gred);
        if (last_for_tile(ctr_gu + ct, nk, &flag))
          for (int i = tid; i < p.B * TILE; i += THREADS) {
            const int b = i / TILE, n = ct * TILE + i % TILE;
            __stcg(p.gu + (size_t)b * 2 * p.I + n, sum_partials(p, nk, 2 * p.I, b, n));
          }
        __syncthreads();
      }
    }
    grid_barrier(p.sync);
    stamp(p, 2 + STAGES * l + 4);
    // ---- S6: SiLU(gate) * up -> bf16, down partials; residual ----
    {
      const int8_t* W = p.dn_d + (size_t)l * p.I * p.H;
      const void* S = layer_scales(p, p.dn_s, (size_t)l * (p.I / QBLK) * p.H);
      const int nk = p.I / TILE, units = n_h * nk;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int ct = u % n_h, kc = u / n_h;
        for (int i = tid; i < p.B * TILE; i += THREADS) {
          const int b = i / TILE, k = kc * TILE + i % TILE;
          const float g = __ldcg(p.gu + (size_t)b * 2 * p.I + k);
          const float up = __ldcg(p.gu + (size_t)b * 2 * p.I + p.I + k);
          const float sg = bf16r(g * (1.f / (1.f + expf(-g))));
          xs[i] = bf16r(sg * bf16r(up));
        }
        __syncthreads();
        gemv_tile(p, W, S, p.H, kc, ct * TILE, xs, gred);
        if (last_for_tile(ctr_dn + ct, nk, &flag))
          for (int i = tid; i < p.B * TILE; i += THREADS) {
            const int b = i / TILE, n = ct * TILE + i % TILE;
            const float y = sum_partials(p, nk, p.H, b, n);
            float* xp = p.x + (size_t)b * p.H + n;
            __stcg(xp, bf16r(__ldcg(xp) + y));
          }
        __syncthreads();
      }
    }
    grid_barrier(p.sync);
    stamp(p, 2 + STAGES * l + 5);
  }
}

constexpr int SMEM_FLOATS = MAXB * TILE + MAXB + WARPS + WARPS * MAXB * TILE;
static_assert(MAXG * D + WARPS <= SMEM_FLOATS, "scores unit scratch");
static_assert(MAXG * TCH + MAXG + WARPS + WARPS * MAXG * D <= SMEM_FLOATS, "P.V unit scratch");

// Offsets (floats) of the scratch regions, in Params order.
struct Scratch {
  size_t qf, kf, vf, scores, cmax, lpart, apart, sself, eself, gu, part, total;
};

Scratch scratch_layout(int B, int H, int Hq, int Hkv, int I, int T) {
  const size_t nch = (size_t)T / TCH, qdim = (size_t)Hq * D, nqkv = qdim + 2 * (size_t)Hkv * D;
  size_t part = (H / TILE) * nqkv;
  const size_t cand[3] = {(qdim / TILE) * H, (size_t)(H / TILE) * 2 * I, (size_t)(I / TILE) * H};
  for (size_t c : cand) part = c > part ? c : part;
  Scratch s{};
  size_t off = 0;
  s.qf = off; off += (size_t)B * qdim;
  s.kf = off; off += (size_t)B * Hkv * D;
  s.vf = off; off += (size_t)B * Hkv * D;
  s.scores = off; off += (size_t)B * Hq * T;
  s.cmax = off; off += (size_t)B * Hq * nch;
  s.lpart = off; off += (size_t)B * Hq * nch;
  s.apart = off; off += (size_t)B * Hq * nch * D;
  s.sself = off; off += (size_t)B * Hq;
  s.eself = off; off += (size_t)B * Hq;
  s.gu = off; off += (size_t)B * 2 * I;
  s.part = off; off += (size_t)B * part;
  s.total = off;
  return s;
}

}  // namespace

// Dynamic shared memory of one block (bytes): the GEMV tiles bound it.
extern "C" int acestep_decode_mega_smem() { return (int)(sizeof(float) * SMEM_FLOATS); }

// Floats of scratch the wrapper allocates.
extern "C" int acestep_decode_mega_scratch(int B, int H, int Hq, int Hkv, int I, int T) {
  return (int)scratch_layout(B, H, Hq, Hkv, I, T).total;
}

// Blocks of the cooperative grid: min(occupancy, 2) per SM.
extern "C" int acestep_decode_mega_grid() {
  const int smem = acestep_decode_mega_smem();
  int dev = 0, sms = 0, occ = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaFuncSetAttribute(decode_mega_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, decode_mega_kernel, THREADS, smem) !=
          cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return sms * (occ < 2 ? occ : 2);
}

extern "C" int acestep_decode_mega(
    const void* qkv_d, const void* qkv_s, const void* o_d, const void* o_s, const void* gu_d,
    const void* gu_s, const void* dn_d, const void* dn_s, int scales_f16, const void* in_norm,
    const void* post_norm, const void* q_norm, const void* k_norm, const void* kc,
    const void* ksc, const void* vc, const void* vsc, const void* lengths, const void* x0,
    const void* cos, const void* sin, void* x, void* k_new, void* ks_new, void* v_new,
    void* vs_new, void* scratch, void* sync, void* stamps, int L, int B, int H, int Hq,
    int Hkv, int I, int T, float eps, int grid, void* stream) {
  if (B < 1 || B > MAXB || Hq % Hkv || Hq / Hkv > MAXG || H % TILE || I % TILE || T % TCH)
    return cudaErrorInvalidValue;
  Params p{};
  p.qkv_d = (const int8_t*)qkv_d; p.qkv_s = qkv_s;
  p.o_d = (const int8_t*)o_d; p.o_s = o_s;
  p.gu_d = (const int8_t*)gu_d; p.gu_s = gu_s;
  p.dn_d = (const int8_t*)dn_d; p.dn_s = dn_s;
  p.scales_f16 = scales_f16;
  p.in_norm = (const float*)in_norm; p.post_norm = (const float*)post_norm;
  p.q_norm = (const float*)q_norm; p.k_norm = (const float*)k_norm;
  p.kc = (const int8_t*)kc; p.ksc = (const float*)ksc;
  p.vc = (const int8_t*)vc; p.vsc = (const float*)vsc;
  p.lengths = (const int*)lengths;
  p.x0 = (const float*)x0; p.cos = (const float*)cos; p.sin = (const float*)sin;
  p.x = (float*)x;
  p.k_new = (int8_t*)k_new; p.ks_new = (float*)ks_new;
  p.v_new = (int8_t*)v_new; p.vs_new = (float*)vs_new;
  const Scratch s = scratch_layout(B, H, Hq, Hkv, I, T);
  float* f = (float*)scratch;
  p.qf = f + s.qf; p.kf = f + s.kf; p.vf = f + s.vf; p.scores = f + s.scores;
  p.cmax = f + s.cmax; p.lpart = f + s.lpart; p.apart = f + s.apart;
  p.sself = f + s.sself; p.eself = f + s.eself; p.gu = f + s.gu; p.part = f + s.part;
  p.sync = (unsigned*)sync;
  p.stamps = (unsigned long long*)stamps;
  p.L = L; p.B = B; p.H = H; p.Hq = Hq; p.Hkv = Hkv; p.I = I; p.T = T; p.NCH = T / TCH;
  p.eps = eps;
  const int smem = acestep_decode_mega_smem();
  if (grid <= 0) grid = acestep_decode_mega_grid();
  if (grid <= 0) return cudaErrorInvalidConfiguration;
  cudaError_t e = cudaFuncSetAttribute(decode_mega_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return e;
  }
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel((const void*)decode_mega_kernel, dim3(grid), dim3(THREADS),
                                  args, (size_t)smem, (cudaStream_t)stream);
  if (e != cudaSuccess) {
    cudaGetLastError();          // a refused launch is not sticky: clear it, report it
    return e;
  }
  return cudaGetLastError();
}
