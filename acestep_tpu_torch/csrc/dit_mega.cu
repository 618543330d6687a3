// Every DiT decoder layer of one Euler step in ONE launch (batch 1).
//
// Replaces acestep_tpu/ops/pallas/dit_mega.py:158 _mega_kernel (via
// dit_layers_mega, :381): q8_0 fused stacked weights (qkv_proj, self o_proj,
// cross q_proj, cross o_proj, gateup_proj, down_proj; int8 [L, K, N] with f32
// scales [L, K/32, N]), the residual stream x [T, H] in f32, cross K/V bf16
// [L, Hkv, Lc, D] computed once per request.
//
// Design: a persistent cooperative kernel (every block resident, grid from the
// occupancy query) whose blocks walk the layers together, with a hand-written
// grid barrier (grid_sync.cuh) between the stages of a layer:
//   init  x = x0; AdaLN of layer 0 -> xa (bf16)
//   per layer l:
//    1 qkv GEMM  xa @ Wqkv -> split-K partials (f32)
//    2 heads     per (token, head): partials summed; q/k RMSNorm and NEOX rope
//                in f32 -> bf16 q / k; v -> bf16
//    3 self-attn per (query head, R query rows): scores in f32 times 1/sqrt(D),
//                the sliding band added as -1e30 on sliding layers, softmax
//                e / sum(e), p rounded to bf16, P.V in f32 -> bf16; K and V
//                pass through shared memory, all their rows at once where
//                they fit
//    4 o GEMM    attn @ Wo -> partials
//    5 rows      x += o * gate_msa; xa = bf16(rms(x) * cross_norm)
//    6 cq GEMM   xa @ Wcq -> partials
//    7 cross     per (query head, R rows): q = bf16(rms(partials) * cq_norm);
//                attention over the cached K/V with the additive encoder mask
//    8 co GEMM   attn @ Wco -> partials
//    9 rows      x += co; xa = bf16(rms(x) * mlp_norm * (1 + mod4) + mod3)
//   10 gu GEMM   xa @ Wgu -> partials
//   11 act       bf16(g * sigmoid(g) * u)
//   12 dn GEMM   act @ Wdn -> partials
//   13 rows      x += dn * mod5; AdaLN of layer l + 1 -> xa
// with mod = scale_shift_table[l] + timestep_proj in f32.  That is 13 grid
// barriers a layer (12 for the last) and one after init: 312 a step at 24
// layers.
//
// GEMMs: a work unit is a 128-row x 128-column output tile over one K range
// (split-K chosen by the wrapper to fill the grid).  K steps of 64: the bf16
// activation tile and the int8 weight tile with its f32 scales arrive by
// cp.async (L2, double-buffered), the weights are dequantized in shared memory
// (f32 multiply, one rounding to bf16, as the q8_0 matmul) and the tile product
// runs on the tensor cores (WMMA bf16 16x16x16, f32 accumulation).  Each
// unit's partial goes to device scratch; the next stage sums the partials of a
// value in split order, so reruns are bit-identical and there are no f32
// atomics.  Everything written inside the launch is read back through L2
// (ld.global.cg / cp.async.cg), never through the non-coherent L1.
//
// Bound: bytes at the main path's T = 128 (the 24 layers' q8_0 weights, about
// 1.5 GB as stored, against 2 x 128 FLOP a weight).  What this simple design
// costs beyond that: every GEMM re-reads its activation panel once per column
// tile from L2, split-K partials go through L2, WMMA runs at a fraction of
// wgmma's rate, and the barriers.
//
// Numerics (dit_mega.py:200-366, copied rounding point for rounding point):
//   * x stays f32 across all layers; xa, the attention outputs and the MLP
//     activation are the bf16 GEMM inputs;
//   * qkv is summed in f32 and never rounded before q/k RMSNorm and rope;
//   * mod = sst[l] + tproj in f32; xa = bf16(rms(x) * w * (1 + mod1) + mod0);
//   * scores f32, scaled by 1/sqrt(D), mask added as -1e30; softmax e / sum e;
//     p bf16, P.V f32, rounded to bf16 before o_proj;
//   * self residual gated by mod2, cross residual ungated, MLP input with
//     mod4 / mod3 and its residual gated by mod5;
//   * act = g * sigmoid(g) * u in f32, then bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "grid_sync.cuh"

using namespace nvcuda;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int QBLK = 32;             // q8_0 block rows
constexpr int BM = 128;              // GEMM tile rows (tokens)
constexpr int BN = 128;              // GEMM tile columns
constexpr int BK = 64;               // K per step: two q8_0 blocks
constexpr int A_LD = BK + 8;         // padded shared-memory rows (bf16 elements)
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;         // f32
constexpr int AS_BYTES = 2 * BM * A_LD * 2;
constexpr int BQ_BYTES = 2 * BK * BN;
constexpr int SS_BYTES = 2 * (BK / QBLK) * BN * 4;
constexpr int BS_BYTES = BK * B_LD * 2;
constexpr int GEMM_SMEM = AS_BYTES + BQ_BYTES + SS_BYTES + BS_BYTES;
static_assert(BM * C_LD * 4 <= GEMM_SMEM, "C staging fits the GEMM buffers");
constexpr int MAXR = 8;              // attention query rows per unit
constexpr int NGEMM = 6;             // qkv, so, cq, co, gu, dn
constexpr int MAX_SPLIT = 8;         // split-K count at most (MAX_SPLIT in dit_mega.py)
constexpr int STAGES = 13;           // stages a layer (the stamps' stride)
constexpr float NEG = -1e30f;

enum { G_QKV = 0, G_SO, G_CQ, G_CO, G_GU, G_DN };
enum { ROW_INIT = 0, ROW_SELF, ROW_CROSS, ROW_MLP };

struct Params {
  const int8_t* w[NGEMM];               // [L, K, N]
  const float* s[NGEMM];                // [L, K/32, N]
  int K[NGEMM], N[NGEMM], S[NGEMM];     // S: split-K count
  const void* sa_norm;                  // [L, H]
  const void* ca_norm;
  const void* mlp_norm;
  const void* sst;                      // [L, 6, H]
  const void* q_norm;                   // [L, D]
  const void* k_norm;
  const void* cq_norm;
  int small_f32;                        // the seven above: 1 f32, 0 bf16
  const __nv_bfloat16* ck;              // [L, Hkv, Lc, D]
  const __nv_bfloat16* cv;
  const float* x0;                      // [T, H]
  const float* tproj;                   // [6, H]
  const float* cos;                     // [T, D]
  const float* sin;
  const float* encm;                    // [Lc] additive (0 / -1e30)
  unsigned long long flags[8];          // sliding bit of each layer
  float* x;                             // [T, H] residual stream and output
  __nv_bfloat16* xa;                    // [T, H] GEMM input stash
  __nv_bfloat16* qb;                    // [Hq, T, D]
  __nv_bfloat16* kb;                    // [Hkv, T, D]
  __nv_bfloat16* vb;
  __nv_bfloat16* attn;                  // [T, Hq * D]
  __nv_bfloat16* act;                   // [T, I]
  float* part;                          // [S, T, N] split-K partials
  unsigned* sync;                       // [0] arrivals, [1] generation
  unsigned long long* stamps;           // optional [2 + 13 L] %globaltimer ns (block 0)
  int L, T, H, Hq, Hkv, D, I, Lc, window, R, KT;   // KT: K / V rows a tile
  float eps, inv_sqrt_d;
};

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float ld_small(const Params& p, const void* a, size_t i) {
  return p.small_f32 ? static_cast<const float*>(a)[i]
                     : __bfloat162float(static_cast<const __nv_bfloat16*>(a)[i]);
}

__device__ __forceinline__ float ld_bf16_cg(const __nv_bfloat16* a) {
  return __bfloat162float(__ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(a))));
}

__device__ __forceinline__ float modv(const Params& p, int l, int j, int c) {
  return __fadd_rn(ld_small(p, p.sst, ((size_t)l * 6 + j) * p.H + c), p.tproj[(size_t)j * p.H + c]);
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

// The split-K partials of value (t, n) of a GEMM with N columns, summed in
// split order (all MAX_SPLIT loads issued before the first add).
__device__ __forceinline__ float sum_part(const Params& p, int g, int t, int n) {
  const size_t step = (size_t)p.T * p.N[g];
  const float* src = p.part + (size_t)t * p.N[g] + n;
  const int S = p.S[g];
  float v[MAX_SPLIT];
#pragma unroll
  for (int s = 0; s < MAX_SPLIT; ++s) v[s] = s < S ? __ldcg(src + s * step) : 0.f;
  float sum = v[0];
#pragma unroll
  for (int s = 1; s < MAX_SPLIT; ++s)
    if (s < S) sum += v[s];
  return sum;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

// ---------------------------------------------------------------------------
// GEMM stage: A [T, K] bf16 (written in this launch) @ dequant(W[l]) -> part
// ---------------------------------------------------------------------------

struct Tile {
  const __nv_bfloat16* A;
  const int8_t* W;
  const float* S;
  int K, N, t0, n0, k0, k1;
};

__device__ __forceinline__ void issue_step(const Params& p, const Tile& tl, int k,
                                           unsigned char* smem, int buf) {
  const int tid = threadIdx.x;
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem) + buf * BM * A_LD;
  int8_t* Bq = reinterpret_cast<int8_t*>(smem + AS_BYTES) + buf * BK * BN;
  float* Ss = reinterpret_cast<float*>(smem + AS_BYTES + BQ_BYTES) + buf * (BK / QBLK) * BN;
  const int kr = min(BK, tl.k1 - k);                 // valid K rows of this step (32 or 64)
#pragma unroll
  for (int i = 0; i < (BM * BK / 8) / THREADS; ++i) {  // A: 8 bf16 a chunk
    const int c = tid + i * THREADS, row = c >> 3, cc = (c & 7) * 8;
    const bool ok = tl.t0 + row < p.T && cc < kr;
    const __nv_bfloat16* src = ok ? tl.A + (size_t)(tl.t0 + row) * tl.K + k + cc : tl.A;
    cp_async16(As + row * A_LD + cc, src, ok);
  }
#pragma unroll
  for (int i = 0; i < (BK * BN / 16) / THREADS; ++i) {  // W: 16 int8 a chunk
    const int c = tid + i * THREADS, row = c >> 3, cc = (c & 7) * 16;
    const bool ok = row < kr && tl.n0 + cc < tl.N;
    const int8_t* src = ok ? tl.W + (size_t)(k + row) * tl.N + tl.n0 + cc : tl.W;
    cp_async16(Bq + row * BN + cc, src, ok);
  }
  if (tid < (BK / QBLK) * BN / 4) {                  // scales: 4 f32 a chunk
    const int r = tid / (BN / 4), cc = (tid % (BN / 4)) * 4;
    const bool ok = r * QBLK < kr && tl.n0 + cc < tl.N;
    const float* src = ok ? tl.S + (size_t)(k / QBLK + r) * tl.N + tl.n0 + cc : tl.S;
    cp_async16(Ss + r * BN + cc, src, ok);
  }
}

// Bs[r][c] = bf16(f32(Bq[r][c]) * Ss[r / 32][c]) for the step in `buf`.
__device__ __forceinline__ void dequant_step(unsigned char* smem, int buf) {
  const int tid = threadIdx.x, r = tid >> 2, c0 = (tid & 3) * 32;
  const int8_t* Bq = reinterpret_cast<const int8_t*>(smem + AS_BYTES) + buf * BK * BN;
  const float* Ss = reinterpret_cast<const float*>(smem + AS_BYTES + BQ_BYTES) +
                    buf * (BK / QBLK) * BN + (r / QBLK) * BN + c0;
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem + AS_BYTES + BQ_BYTES + SS_BYTES);
  const uint4 q0 = *reinterpret_cast<const uint4*>(Bq + r * BN + c0);
  const uint4 q1 = *reinterpret_cast<const uint4*>(Bq + r * BN + c0 + 16);
  const int8_t* q[2] = {reinterpret_cast<const int8_t*>(&q0), reinterpret_cast<const int8_t*>(&q1)};
  __align__(16) __nv_bfloat16 v[32];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 16; ++e)
      v[16 * h + e] = __float2bfloat16_rn(__fmul_rn((float)q[h][e], Ss[16 * h + e]));
  uint4* dst = reinterpret_cast<uint4*>(Bs + r * B_LD + c0);
#pragma unroll
  for (int i = 0; i < 4; ++i) dst[i] = reinterpret_cast<const uint4*>(v)[i];
}

// One output tile over [k0, k1): partial (split `s`) -> p.part.
__device__ void gemm_tile(const Params& p, const Tile& tl, int s, unsigned char* smem) {
  const int warp = threadIdx.x >> 5, wm = warp >> 1, wn = warp & 1;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  const __nv_bfloat16* Bs =
      reinterpret_cast<const __nv_bfloat16*>(smem + AS_BYTES + BQ_BYTES + SS_BYTES);
  const int steps = (tl.k1 - tl.k0 + BK - 1) / BK;
  issue_step(p, tl, tl.k0, smem, 0);
  cp_async_commit();
  for (int st = 0; st < steps; ++st) {
    const int buf = st & 1;
    if (st + 1 < steps) {
      issue_step(p, tl, tl.k0 + (st + 1) * BK, smem, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    dequant_step(smem, buf);
    __syncthreads();
    const __nv_bfloat16* As = reinterpret_cast<const __nv_bfloat16*>(smem) + buf * BM * A_LD;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * A_LD + ks, A_LD);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(b[j], Bs + ks * B_LD + wn * 64 + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * C_LD + wn * 64 + j * 16, acc[i][j], C_LD,
                              wmma::mem_row_major);
  __syncthreads();
  float* dst = p.part + (size_t)s * p.T * tl.N;
  for (int e = threadIdx.x; e < BM * BN / 4; e += THREADS) {
    const int r = e / (BN / 4), c = (e % (BN / 4)) * 4;
    const int t = tl.t0 + r, n = tl.n0 + c;
    if (t < p.T && n < tl.N)
      __stcg(reinterpret_cast<float4*>(dst + (size_t)t * tl.N + n),
             *reinterpret_cast<const float4*>(Cs + r * C_LD + c));
  }
  __syncthreads();
}

__device__ void gemm_stage(const Params& p, int g, int l, const __nv_bfloat16* A,
                           unsigned char* smem) {
  const int K = p.K[g], N = p.N[g], S = p.S[g];
  const int n_rt = (p.T + BM - 1) / BM, n_ct = (N + BN - 1) / BN;
  const int nkb = K / QBLK, per = (nkb + S - 1) / S;
  Tile tl;
  tl.A = A;
  tl.W = p.w[g] + (size_t)l * K * N;
  tl.S = p.s[g] + (size_t)l * (K / QBLK) * N;
  tl.K = K;
  tl.N = N;
  const int units = S * n_ct * n_rt;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int rt = u % n_rt, ct = (u / n_rt) % n_ct, s = u / (n_rt * n_ct);
    tl.t0 = rt * BM;
    tl.n0 = ct * BN;
    tl.k0 = s * per * QBLK;
    tl.k1 = min(nkb, (s + 1) * per) * QBLK;
    gemm_tile(p, tl, s, smem);
  }
}

// ---------------------------------------------------------------------------
// row stages: residual update, RMSNorm, modulation, stash
// ---------------------------------------------------------------------------

__device__ void row_stage(const Params& p, int kind, int l, float* red) {
  const int H = p.H, tid = threadIdx.x;
  // the layer whose norm / modulation builds the next stash
  const int ln = kind == ROW_INIT ? 0 : (kind == ROW_MLP ? l + 1 : l);
  const bool stash = ln < p.L;
  for (int t = blockIdx.x; t < p.T; t += gridDim.x) {
    float* xr = p.x + (size_t)t * H;
    float ss = 0.f;
    for (int c = tid; c < H; c += THREADS) {
      float v;
      if (kind == ROW_INIT) {
        v = p.x0[(size_t)t * H + c];
      } else if (kind == ROW_SELF) {
        v = __fadd_rn(__ldcg(xr + c), __fmul_rn(sum_part(p, G_SO, t, c), modv(p, l, 2, c)));
      } else if (kind == ROW_CROSS) {
        v = __fadd_rn(__ldcg(xr + c), sum_part(p, G_CO, t, c));
      } else {
        v = __fadd_rn(__ldcg(xr + c), __fmul_rn(sum_part(p, G_DN, t, c), modv(p, l, 5, c)));
      }
      __stcg(xr + c, v);
      ss = fmaf(v, v, ss);
    }
    if (!stash) continue;
    const float r = 1.f / sqrtf(block_sum(ss, red) / (float)H + p.eps);
    for (int c = tid; c < H; c += THREADS) {
      const float v = __ldcg(xr + c);
      float y;
      if (kind == ROW_SELF) {
        y = __fmul_rn(__fmul_rn(v, r), ld_small(p, p.ca_norm, (size_t)ln * H + c));
      } else {
        const bool mlp = kind == ROW_CROSS;
        const void* w = mlp ? p.mlp_norm : p.sa_norm;
        const float shift = modv(p, ln, mlp ? 3 : 0, c), scale = modv(p, ln, mlp ? 4 : 1, c);
        const float xn = __fmul_rn(__fmul_rn(v, r), ld_small(p, w, (size_t)ln * H + c));
        y = __fadd_rn(__fmul_rn(xn, __fadd_rn(1.f, scale)), shift);
      }
      p.xa[(size_t)t * H + c] = __float2bfloat16_rn(y);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// heads: q / k RMSNorm + rope, v -> bf16 (a warp per (token, head))
// ---------------------------------------------------------------------------

__device__ void heads_stage(const Params& p, int l, float* wbuf) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, D = p.D, half = D / 2;
  const int nh = p.Hq + 2 * p.Hkv;
  float* buf = wbuf + warp * D;
  const int items = p.T * nh;
  for (int it = blockIdx.x * WARPS + warp; it < items; it += gridDim.x * WARPS) {
    const int t = it / nh, hh = it % nh;
    const bool is_q = hh < p.Hq, is_k = !is_q && hh < p.Hq + p.Hkv;
    float ss = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float v = sum_part(p, G_QKV, t, hh * D + d);
      buf[d] = v;
      ss = fmaf(v, v, ss);
    }
    __syncwarp();
    if (!is_q && !is_k) {
      const int h = hh - p.Hq - p.Hkv;
      for (int d = lane; d < D; d += 32)
        p.vb[((size_t)h * p.T + t) * D + d] = __float2bfloat16_rn(buf[d]);
      __syncwarp();
      continue;
    }
    const float r = 1.f / sqrtf(warp_sum(ss) / (float)D + p.eps);
    const void* w = is_q ? p.q_norm : p.k_norm;
    for (int d = lane; d < D; d += 32)
      buf[d] = __fmul_rn(__fmul_rn(buf[d], r), ld_small(p, w, (size_t)l * D + d));
    __syncwarp();
    __nv_bfloat16* dst = is_q ? p.qb + ((size_t)hh * p.T + t) * D
                              : p.kb + ((size_t)(hh - p.Hq) * p.T + t) * D;
    for (int d = lane; d < D; d += 32) {
      const float rot = d < half ? -buf[d + half] : buf[d - half];
      const float y = __fadd_rn(__fmul_rn(buf[d], p.cos[(size_t)t * D + d]),
                                __fmul_rn(rot, p.sin[(size_t)t * D + d]));
      dst[d] = __float2bfloat16_rn(y);
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// attention: per (query head, R query rows); scores and p in shared memory
// ---------------------------------------------------------------------------

// Copy rows [j0, j0 + n) of a [Lk, D] bf16 K or V into the tile [KT][D + 2]
// (rows padded by one 4-byte word, so a warp reading one column of 32 rows hits
// 32 banks); 16-byte loads, all in flight at once.
template <bool CROSS>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* src, int j0, int n, int D,
                                          __nv_bfloat16* tile) {
  const int per_row = D / 8;
  for (int i = threadIdx.x; i < n * per_row; i += THREADS) {
    const int j = i / per_row, d = (i % per_row) * 8;
    const uint4* g = reinterpret_cast<const uint4*>(src + (size_t)(j0 + j) * D + d);
    const uint4 raw = CROSS ? __ldg(g) : __ldcg(g);
    unsigned* dst = reinterpret_cast<unsigned*>(tile + j * (D + 2) + d);
    dst[0] = raw.x;
    dst[1] = raw.y;
    dst[2] = raw.z;
    dst[3] = raw.w;
  }
}

// qs [MAXR][D] (bf16-valued q rows) is filled; K / V rows [Lk, D] bf16 pass
// through shared memory KT rows at a time (all of them where they fit).  The
// mask is the band (self) or the additive encoder mask (cross).  Shared
// memory after qs: sc [R][Lk] f32 (scores, then p), oacc [R][D] f32, the
// tile [KT][D + 2] bf16.
template <bool CROSS>
__device__ void attend(const Params& p, int l, int h, int r0, const __nv_bfloat16* Kh,
                       const __nv_bfloat16* Vh, int Lk, float* qs, float* sc) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, D = p.D, R = p.R;
  const bool sliding = !CROSS && ((p.flags[l >> 6] >> (l & 63)) & 1ull);
  float* oacc = sc + R * Lk;
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(oacc + R * D);
  const __nv_bfloat162* tile2 = reinterpret_cast<const __nv_bfloat162*>(tile);
  const int half_ld = (D + 2) / 2;
  // scores: a thread per (r, j) of each tile
  for (int j0 = 0; j0 < Lk; j0 += p.KT) {
    const int n = min(p.KT, Lk - j0);
    load_tile<CROSS>(Kh, j0, n, D, tile);
    __syncthreads();
    for (int pair = tid; pair < R * n; pair += THREADS) {
      const int r = pair / n, j = pair % n;
      const float* q = qs + r * D;
      float acc = 0.f;
      for (int d = 0; d < D; d += 2) {
        const float2 k2 = __bfloat1622float2(tile2[j * half_ld + d / 2]);
        acc = fmaf(q[d], k2.x, acc);
        acc = fmaf(q[d + 1], k2.y, acc);
      }
      float s = __fmul_rn(acc, p.inv_sqrt_d);
      if (CROSS) {
        s = __fadd_rn(s, p.encm[j0 + j]);
      } else if (sliding && abs(r0 + r - (j0 + j)) > p.window) {
        s = __fadd_rn(s, NEG);
      }
      sc[r * Lk + j0 + j] = s;
    }
    __syncthreads();
  }
  if (warp < R) {                       // softmax of row `warp`: p = bf16(e / sum e)
    float* row = sc + warp * Lk;
    float m = NEG;
    for (int j = lane; j < Lk; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < Lk; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    __syncwarp();
    for (int j = lane; j < Lk; j += 32) row[j] = bf16r(__fdiv_rn(row[j], sum));
  }
  for (int o = tid; o < R * D; o += THREADS) oacc[o] = 0.f;
  __syncthreads();
  // P.V: thread per (r, d) output, the tile's rows summed, then added
  for (int j0 = 0; j0 < Lk; j0 += p.KT) {
    const int n = min(p.KT, Lk - j0);
    load_tile<CROSS>(Vh, j0, n, D, tile);
    __syncthreads();
    for (int o = tid; o < R * D; o += THREADS) {
      const int r = o / D, d = o % D;
      const float* pr = sc + r * Lk + j0;
      float acc = 0.f;
      for (int j = 0; j < n; ++j) acc = fmaf(pr[j], __bfloat162float(tile[j * (D + 2) + d]), acc);
      oacc[o] += acc;
    }
    __syncthreads();
  }
  const int qdim = p.Hq * D;
  for (int o = tid; o < R * D; o += THREADS)
    p.attn[(size_t)(r0 + o / D) * qdim + h * D + o % D] = __float2bfloat16_rn(oacc[o]);
  __syncthreads();
}

__device__ void self_attn_stage(const Params& p, int l, float* smem) {
  const int D = p.D, R = p.R, groups = p.T / R, grp = p.Hq / p.Hkv;
  float* qs = smem;
  float* sc = smem + MAXR * D;
  for (int u = blockIdx.x; u < p.Hq * groups; u += gridDim.x) {
    const int h = u / groups, r0 = (u % groups) * R, g = h / grp;
    for (int i = threadIdx.x; i < R * D; i += THREADS)
      qs[i] = ld_bf16_cg(p.qb + ((size_t)h * p.T + r0 + i / D) * D + i % D);
    __syncthreads();
    attend<false>(p, l, h, r0, p.kb + (size_t)g * p.T * D, p.vb + (size_t)g * p.T * D, p.T, qs, sc);
  }
}

__device__ void cross_attn_stage(const Params& p, int l, float* smem) {
  const int D = p.D, R = p.R, groups = p.T / R, grp = p.Hq / p.Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qs = smem;
  float* sc = smem + MAXR * D;
  for (int u = blockIdx.x; u < p.Hq * groups; u += gridDim.x) {
    const int h = u / groups, r0 = (u % groups) * R, g = h / grp;
    if (warp < R) {                     // q of row r0 + warp: bf16(rms(q) * cq_norm)
      float* q = qs + warp * D;
      float ss = 0.f;
      for (int d = lane; d < D; d += 32) {
        const float v = sum_part(p, G_CQ, r0 + warp, h * D + d);
        q[d] = v;
        ss = fmaf(v, v, ss);
      }
      const float r = 1.f / sqrtf(warp_sum(ss) / (float)D + p.eps);
      for (int d = lane; d < D; d += 32)
        q[d] = bf16r(__fmul_rn(__fmul_rn(q[d], r), ld_small(p, p.cq_norm, (size_t)l * D + d)));
    }
    __syncthreads();
    const size_t kv = ((size_t)l * p.Hkv + g) * p.Lc * D;
    attend<true>(p, l, h, r0, p.ck + kv, p.cv + kv, p.Lc, qs, sc);
  }
}

__device__ void act_stage(const Params& p) {
  const int I = p.I;
  const size_t n = (size_t)p.T * I;
  const size_t stride = (size_t)gridDim.x * THREADS;
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < n; i += stride) {
    const int t = (int)(i / I), c = (int)(i % I);
    const float g = sum_part(p, G_GU, t, c), u = sum_part(p, G_GU, t, I + c);
    const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-g)));
    p.act[i] = __float2bfloat16_rn(__fmul_rn(__fmul_rn(g, sig), u));
  }
}

__global__ void __launch_bounds__(THREADS) dit_mega_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[WARPS];
  float* fs = reinterpret_cast<float*>(smem);
  stamp(p, 0);
  row_stage(p, ROW_INIT, 0, red);
  grid_barrier(p.sync);
  stamp(p, 1);
  for (int l = 0; l < p.L; ++l) {
    const int s0 = 2 + STAGES * l;
    gemm_stage(p, G_QKV, l, p.xa, smem);
    grid_barrier(p.sync);
    stamp(p, s0 + 0);
    heads_stage(p, l, fs);
    grid_barrier(p.sync);
    stamp(p, s0 + 1);
    self_attn_stage(p, l, fs);
    grid_barrier(p.sync);
    stamp(p, s0 + 2);
    gemm_stage(p, G_SO, l, p.attn, smem);
    grid_barrier(p.sync);
    stamp(p, s0 + 3);
    row_stage(p, ROW_SELF, l, red);
    grid_barrier(p.sync);
    stamp(p, s0 + 4);
    gemm_stage(p, G_CQ, l, p.xa, smem);
    grid_barrier(p.sync);
    stamp(p, s0 + 5);
    cross_attn_stage(p, l, fs);
    grid_barrier(p.sync);
    stamp(p, s0 + 6);
    gemm_stage(p, G_CO, l, p.attn, smem);
    grid_barrier(p.sync);
    stamp(p, s0 + 7);
    row_stage(p, ROW_CROSS, l, red);
    grid_barrier(p.sync);
    stamp(p, s0 + 8);
    gemm_stage(p, G_GU, l, p.xa, smem);
    grid_barrier(p.sync);
    stamp(p, s0 + 9);
    act_stage(p);
    grid_barrier(p.sync);
    stamp(p, s0 + 10);
    gemm_stage(p, G_DN, l, p.act, smem);
    grid_barrier(p.sync);
    stamp(p, s0 + 11);
    row_stage(p, ROW_MLP, l, red);
    if (l + 1 < p.L) grid_barrier(p.sync);
    stamp(p, s0 + 12);
  }
}

int smem_bytes(int D, int Lk, int R, int KT) {
  const int attn = (MAXR * D + R * Lk + R * D) * 4 + KT * (D + 2) * 2;
  const int heads = WARPS * D * 4;
  int s = GEMM_SMEM;
  if (attn > s) s = attn;
  if (heads > s) s = heads;
  return s;
}

}  // namespace

// Dynamic shared memory of one block (bytes) for head dim D, the longer of
// the two attention lengths Lk, R query rows a unit and KT K / V rows a tile.
extern "C" int acestep_dit_mega_smem(int D, int Lk, int R, int KT) {
  return smem_bytes(D, Lk, R, KT);
}

// Blocks of the cooperative grid at `smem` bytes a block: min(occupancy, 2)
// per SM (< 0: the query failed; 0: not one block fits).
extern "C" int acestep_dit_mega_grid(int smem) {
  int dev = 0, sms = 0, occ = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaFuncSetAttribute(dit_mega_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, dit_mega_kernel, THREADS, smem) !=
          cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return sms * (occ < 2 ? occ : 2);
}

// ptrs (36): w / scales of qkv, so, cq, co, gu, dn (12); sa_norm, ca_norm,
// mlp_norm, sst, q_norm, k_norm, cq_norm (7); ck, cv, x0, tproj, cos, sin, encm
// (7); x (1); xa, qb, kb, vb, attn, act, part (7); sync (1); stamps (1, may be
// null).
// dims (18): L, T, H, Hq, Hkv, D, I, Lc, window, R, small_f32, S[6], KT.
// flags: 8 words of sliding bits (layer l: bit l % 64 of word l / 64).
extern "C" int acestep_dit_mega(void* const* ptrs, const int* dims,
                                const unsigned long long* flags, float eps, float inv_sqrt_d,
                                int grid, void* stream) {
  Params p{};
  int i = 0;
  for (int g = 0; g < NGEMM; ++g) {
    p.w[g] = static_cast<const int8_t*>(ptrs[i++]);
    p.s[g] = static_cast<const float*>(ptrs[i++]);
  }
  p.sa_norm = ptrs[i++];
  p.ca_norm = ptrs[i++];
  p.mlp_norm = ptrs[i++];
  p.sst = ptrs[i++];
  p.q_norm = ptrs[i++];
  p.k_norm = ptrs[i++];
  p.cq_norm = ptrs[i++];
  p.ck = static_cast<const __nv_bfloat16*>(ptrs[i++]);
  p.cv = static_cast<const __nv_bfloat16*>(ptrs[i++]);
  p.x0 = static_cast<const float*>(ptrs[i++]);
  p.tproj = static_cast<const float*>(ptrs[i++]);
  p.cos = static_cast<const float*>(ptrs[i++]);
  p.sin = static_cast<const float*>(ptrs[i++]);
  p.encm = static_cast<const float*>(ptrs[i++]);
  p.x = static_cast<float*>(ptrs[i++]);
  p.xa = static_cast<__nv_bfloat16*>(ptrs[i++]);
  p.qb = static_cast<__nv_bfloat16*>(ptrs[i++]);
  p.kb = static_cast<__nv_bfloat16*>(ptrs[i++]);
  p.vb = static_cast<__nv_bfloat16*>(ptrs[i++]);
  p.attn = static_cast<__nv_bfloat16*>(ptrs[i++]);
  p.act = static_cast<__nv_bfloat16*>(ptrs[i++]);
  p.part = static_cast<float*>(ptrs[i++]);
  p.sync = static_cast<unsigned*>(ptrs[i++]);
  p.stamps = static_cast<unsigned long long*>(ptrs[i++]);
  p.L = dims[0]; p.T = dims[1]; p.H = dims[2]; p.Hq = dims[3]; p.Hkv = dims[4]; p.D = dims[5];
  p.I = dims[6]; p.Lc = dims[7]; p.window = dims[8]; p.R = dims[9]; p.small_f32 = dims[10];
  for (int g = 0; g < NGEMM; ++g) p.S[g] = dims[11 + g];
  p.KT = dims[17];
  for (int w = 0; w < 8; ++w) p.flags[w] = flags[w];
  p.eps = eps;
  p.inv_sqrt_d = inv_sqrt_d;
  const int qdim = p.Hq * p.D, nqkv = qdim + 2 * p.Hkv * p.D;
  const int Ks[NGEMM] = {p.H, qdim, p.H, qdim, p.H, p.I};
  const int Ns[NGEMM] = {nqkv, p.H, qdim, p.H, 2 * p.I, p.H};
  for (int g = 0; g < NGEMM; ++g) {
    p.K[g] = Ks[g];
    p.N[g] = Ns[g];
    if (Ks[g] % QBLK || Ns[g] % QBLK || p.S[g] < 1 || p.S[g] > MAX_SPLIT)
      return cudaErrorInvalidValue;
    // no empty split: as many splits as ceil(K / 32 / per) blocks of `per`
    const int nkb = Ks[g] / QBLK, per = (nkb + p.S[g] - 1) / p.S[g];
    p.S[g] = (nkb + per - 1) / per;
  }
  if (p.L < 1 || p.L > 512 || p.T < 1 || p.T % MAXR || p.R < 1 || p.R > MAXR || p.T % p.R ||
      p.D % 32 || p.Hkv < 1 || p.Hq % p.Hkv || p.Lc < 1 || p.KT < 1)
    return cudaErrorInvalidValue;
  const int smem = smem_bytes(p.D, p.T > p.Lc ? p.T : p.Lc, p.R, p.KT);
  if (grid <= 0) grid = acestep_dit_mega_grid(smem);
  if (grid <= 0) return cudaErrorInvalidConfiguration;
  cudaError_t e =
      cudaFuncSetAttribute(dit_mega_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return e;
  }
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel((const void*)dit_mega_kernel, dim3(grid), dim3(THREADS), args,
                                  (size_t)smem, (cudaStream_t)stream);
  if (e != cudaSuccess) {
    cudaGetLastError();            // a refused launch is not sticky: clear it, report it
    return e;
  }
  return cudaGetLastError();
}
