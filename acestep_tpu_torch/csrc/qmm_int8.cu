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
// through qmm_int8_act, :385; the per-row quantizer of :406-411, which runs
// there in XLA before the kernel, is folded in here: one launch a call).
//
// Bound on the H100: bytes.  At M <= 16 every weight byte feeds at most 32
// integer operations, far below the ~600 a byte the int8 tensor cores need
// before they bind; the work is streaming W (int8) and its block scales once:
// the bound counts them as the format stores them (f16, 1.06 bytes a weight),
// the kernel reads the engine's pre-cast f32 copy (1.13 bytes a weight).  At
// the LM's shapes that is 1.2-4.7 MB a call, 0.4-1.4 us at the H100 SXM's
// 3.35 TB/s (700 W), so the card must be full and its loads in flight.
//
// Design.  A column tile of BN (128, 64 or 32) columns is one thread-block
// cluster of S (1-8) blocks that split K in whole 32-row blocks; the plan
// (ops/cuda/qmm_int8.int8_plan) picks the widest tile and the fewest splits
// that give at least one block per SM (132), so N = 1024 runs 256 blocks and
// the codes head (N = 65536) 512 blocks of one split.  Each block
//   1. streams its weight rows and scales by cp.async through a ring of two
//      steps of 8 32-row blocks (rows permuted so that the compute loop reads
//      shared memory without bank conflicts), copied by warps 0-3;
//   2. meanwhile (warps 4-7) takes the row maxima of x over its own K range
//      and trades them through distributed shared memory (a maximum does not
//      depend on order, so every block gets the same xs), then quantizes its
//      K range step by step into a ring of two step buffers, the next step's
//      while the current one is multiplied: xq and xs never reach device
//      memory, and xq's shared memory does not grow with K;
//   3. step by step, forms each 32-block's exact int32 partial with __dp4a (a
//      lane owns 4 columns; the 4 x 4 byte transposes of the N-major weight
//      by __byte_perm; at BN < 128 two or four lanes share a block's rows and
//      add their int32 sums with shuffles, which is exact) and the f32 term
//      __fmul_rn(p, s); with S > 1 the term goes to the shared memory of the
//      cluster block that owns the column (block r owns columns
//      [r BN/S, (r+1) BN/S)), with S = 1 the block adds each step's terms in
//      K order into its accumulators while the next step lands;
//   4. with S > 1, after a cluster barrier, adds its columns' terms in K
//      order with __fadd_rn from zero; then multiplies by xs and rounds once
//      to bf16.
// So the sum is the plain version's, bit for bit, whatever the split or the
// launch.  With S > 1 the owner's terms take nkb * M * BN / S floats, which
// grow with K; the plan narrows the tile where they would not fit (the 4B
// planner's down_proj, K = 9728, at M 10-16), and S = 1 fits at every K.
// mma.sync m16n8k32 s8 was not built: at the LM's M = 1 the dp4a work is 1/16
// of a tensor-core tile's and the kernel is bound by its loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int QBLK = 32;                 // q8_0 block rows
constexpr int MAXM = 16;
constexpr int MAX_SPLITS = 8;            // the portable cluster size
constexpr int SMEM_MAX = 200 * 1024;     // dynamic shared memory a block may ask for

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// every thread of the cluster arrives, then waits for the others; shared-memory
// stores before it are visible to the cluster's loads after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// the two halves of cluster_sync, with and without the release
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// the address of shared-memory word `p` of this block in block `rank` of the cluster
__device__ __forceinline__ uint32_t remote(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ float ld_remote(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void st_remote4(uint32_t addr, float a, float b, float c, float d) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "f"(a), "f"(b),
               "f"(c), "f"(d)
               : "memory");
}

// Shared-memory layout of one block, in bytes (the host mirrors it in
// ops/cuda/qmm_int8.int8_smem).  A block takes its per = ceil(K/32 / S)
// 32-blocks in steps of step = min(STEP, per) (one a warp) through a ring of
// min(2, steps) step buffers.
constexpr int STEP = WARPS;

struct Layout {
  int w, s, xq, terms, amax, xs, total, step, steps, ring;
};

__host__ __device__ inline Layout layout(int M, int K, int BN, int S) {
  const int nkb = K / QBLK, per = (nkb + S - 1) / S;
  Layout l;
  l.step = per < STEP ? per : STEP;
  l.steps = (per + l.step - 1) / l.step;
  l.ring = l.steps < 2 ? l.steps : 2;
  l.w = 0;                                              // [ring][step * 32][BN] int8, rows permuted
  l.s = l.w + l.ring * l.step * QBLK * BN;              // [ring][step][BN] f32 scales
  l.xq = l.s + l.ring * l.step * BN * 4;                // [ring][M][step * 32] int8
  l.terms = l.xq + ((l.ring * M * l.step * QBLK + 15) / 16) * 16;
  // S > 1: [nkb][M][BN / S] f32, the columns this block owns; S = 1: one
  // step's terms [STEP][M][BN]
  l.amax = l.terms + (S > 1 ? nkb * M * (BN / S) : STEP * M * BN) * 4;
  l.xs = l.amax + MAXM * 4;                             // [MAXM] partial row maxima, row scales
  l.total = l.xs + MAXM * 4;
  return l;
}

// One cluster of S blocks per BN-column tile (grid = N / BN * S, cluster along
// x); ONE: S == 1 (the block's own accumulators, no exchange).
template <int BN, typename T, bool ONE>
__global__ void __launch_bounds__(THREADS)
int8_mm_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ s, __nv_bfloat16* __restrict__ out, int M, int N, int K,
               int S) {
  constexpr int LPR = BN / 4;              // lanes across a row (4 columns each)
  constexpr int R = 32 / LPR;              // lanes that share a 32-row block
  constexpr int ROWS = QBLK / R;           // rows of a 32-block a lane reads
  constexpr int GROUPS = ROWS / 4;         // 4 x 4 byte transposes a lane makes
  constexpr int COPIERS = THREADS / 2;     // warps 0-3 copy, warps 4-7 take the row maxima
  constexpr int PAIRS = ONE ? MAXM * BN / THREADS : 1;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = static_cast<int>(cluster_rank());
  const int n0 = (blockIdx.x / S) * BN;
  const int nkb = K / QBLK, per = (nkb + S - 1) / S;
  const int kb0 = rank * per, mine = min(per, nkb - kb0), kn = mine * QBLK, k0 = kb0 * QBLK;
  const int own = BN / S;                  // columns whose sum this block owns
  const Layout lay = layout(M, K, BN, S);
  int8_t* ws = reinterpret_cast<int8_t*>(smem + lay.w);
  float* ss = reinterpret_cast<float*>(smem + lay.s);
  int8_t* xq = reinterpret_cast<int8_t*>(smem + lay.xq);
  float* terms = reinterpret_cast<float*>(smem + lay.terms);
  float* amax = reinterpret_cast<float*>(smem + lay.amax);
  float* xs = reinterpret_cast<float*>(smem + lay.xs);

  // Step t's weight rows and scales into ring buffer t % ring, by the copiers
  // (one cp.async group a step, empty past the last).  Row i of a 32-block
  // (i = part * ROWS + j) goes to shared row j * R + part, so that a warp's
  // load of row j of every part reads R * BN = 128 contiguous bytes.
  const auto issue = [&](int t) {
    if (t < lay.steps) {
      const int kb_t = t * lay.step, nk = min(lay.step, mine - kb_t);
      int8_t* wb = ws + (t % lay.ring) * lay.step * QBLK * BN;
      float* sb = ss + (t % lay.ring) * lay.step * BN;
      constexpr int CPR = BN / 16;         // 16-byte copies a row
      for (int i = tid; i < nk * QBLK * CPR; i += COPIERS) {
        const int r = i / CPR, q = i % CPR;
        const int kbl = r / QBLK, rr = r % QBLK;
        const int srow = kbl * QBLK + (rr % ROWS) * R + rr / ROWS;
        cp_async16(wb + srow * BN + q * 16,
                   w + (size_t)(k0 + kb_t * QBLK + r) * N + n0 + q * 16);
      }
      constexpr int SPR = BN / 4;          // 16-byte copies a scale row
      for (int i = tid; i < nk * SPR; i += COPIERS) {
        const int kbl = i / SPR, q = i % SPR;
        cp_async16(sb + kbl * BN + q * 4, s + (size_t)(kb0 + kb_t + kbl) * N + n0 + q * 4);
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  // 1. the first steps in flight (warps 0-3), the row maxima over this
  // block's K range traded through the cluster (warps 4-7: the release before
  // the cluster barrier would wait for a thread's copies in flight)
  if (tid < COPIERS) {
    for (int t = 0; t < lay.ring; ++t) issue(t);
    cluster_arrive_relaxed();
  } else {
    for (int m = warp - WARPS / 2; m < M; m += WARPS / 2) {
      const T* row = x + (size_t)m * K + k0;
      float a = 0.f;
      for (int k = lane; k < kn; k += 32) a = fmaxf(a, fabsf(to_f32(row[k])));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
      if (lane == 0) amax[m] = a;
    }
    cluster_arrive_release();
  }
  cluster_wait();
  // 2. xs, then this block's K range quantized into shared memory
  if (tid < M) {
    float a = 0.f;
    for (int r = 0; r < S; ++r) a = fmaxf(a, ld_remote(remote(amax + tid, r)));
    xs[tid] = a / 127.f;                   // a true division (div.rn), as the plain version
  }
  __syncthreads();
  // step t's rows of x quantized into xq buffer t % ring, [M][step * 32]
  const int xw = lay.step * QBLK;
  const auto quantize = [&](int t) {
    int8_t* xb = xq + (t % lay.ring) * M * xw;
    const int kt = k0 + t * xw, nk = min(lay.step, mine - t * lay.step) * QBLK;
    for (int i = tid; i < M * nk; i += THREADS) {
      const int m = i / nk, k = i % nk;
      const float sc = xs[m];
      const float inv = sc > 0.f ? 1.f / fmaxf(sc, 1e-30f) : 0.f;
      const float q = rintf(__fmul_rn(to_f32(x[(size_t)m * K + kt + k]), inv));
      xb[m * xw + k] = static_cast<int8_t>(fminf(fmaxf(q, -127.f), 127.f));
    }
  };
  quantize(0);

  // 3. step by step: each warp one 32-block's exact int32 partials and f32
  // terms, pushed to the owner block (S > 1) or added in K order into this
  // block's accumulators after the step (S = 1)
  const int c = lane % LPR, part = lane / LPR;
  const int owner = (4 * c) / own, oc = (4 * c) % own;
  const uint32_t dst0 = remote(terms, owner);
  float acc[PAIRS];
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) acc[i] = 0.f;
  for (int t = 0; t < lay.steps; ++t) {
    if (tid < COPIERS) {
      if (lay.ring == 2) asm volatile("cp.async.wait_group 1;" ::: "memory");
      else asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();
    const int kbl = t * lay.step + warp;
    const int8_t* xb = xq + (t % lay.ring) * M * xw;
    if (warp < lay.step && kbl < mine) {
      const int8_t* wb = ws + ((t % lay.ring) * lay.step + warp) * QBLK * BN;
      int wv[ROWS];
#pragma unroll
      for (int j = 0; j < ROWS; ++j)
        wv[j] = *reinterpret_cast<const int*>(wb + (j * R + part) * BN + 4 * c);
      // rows 4g..4g+3 x 4 columns -> 4 columns of 4 rows each
      int wc[4][GROUPS];
#pragma unroll
      for (int g = 0; g < GROUPS; ++g) {
        const int a = wv[4 * g], b = wv[4 * g + 1], cc = wv[4 * g + 2], d = wv[4 * g + 3];
        const int ab_lo = __byte_perm(a, b, 0x5140), ab_hi = __byte_perm(a, b, 0x7362);
        const int cd_lo = __byte_perm(cc, d, 0x5140), cd_hi = __byte_perm(cc, d, 0x7362);
        wc[0][g] = __byte_perm(ab_lo, cd_lo, 0x5410);
        wc[1][g] = __byte_perm(ab_lo, cd_lo, 0x7632);
        wc[2][g] = __byte_perm(ab_hi, cd_hi, 0x5410);
        wc[3][g] = __byte_perm(ab_hi, cd_hi, 0x7632);
      }
      const float4 sc =
          *reinterpret_cast<const float4*>(ss + ((t % lay.ring) * lay.step + warp) * BN + 4 * c);
      const int kb = kb0 + kbl;
      for (int m = 0; m < M; ++m) {
        const int* xr = reinterpret_cast<const int*>(xb + m * xw + warp * QBLK + part * ROWS);
        int pp[4] = {0, 0, 0, 0};
#pragma unroll
        for (int g = 0; g < GROUPS; ++g) {
          const int xv = xr[g];
#pragma unroll
          for (int j = 0; j < 4; ++j) pp[j] = __dp4a(xv, wc[j][g], pp[j]);
        }
#pragma unroll
        for (int o = LPR; o < 32; o <<= 1)
#pragma unroll
          for (int j = 0; j < 4; ++j) pp[j] += __shfl_xor_sync(0xffffffffu, pp[j], o);
        if (m % R == part) {
          const float t0 = __fmul_rn((float)pp[0], sc.x), t1 = __fmul_rn((float)pp[1], sc.y);
          const float t2 = __fmul_rn((float)pp[2], sc.z), t3 = __fmul_rn((float)pp[3], sc.w);
          if (ONE)
            *reinterpret_cast<float4*>(terms + (warp * M + m) * BN + 4 * c) =
                make_float4(t0, t1, t2, t3);
          else
            st_remote4(dst0 + ((kb * M + m) * own + oc) * 4, t0, t1, t2, t3);
        }
      }
    }
    // the next step's xq into the other buffer (read last in step t - 1)
    if (t + 1 < lay.steps) quantize(t + 1);
    __syncthreads();
    if (ONE) {
      const int nk = min(lay.step, mine - t * lay.step);
#pragma unroll
      for (int i = 0; i < PAIRS; ++i) {
        const int pi = tid + i * THREADS;
        if (pi < M * BN)
          for (int k = 0; k < nk; ++k) acc[i] = __fadd_rn(acc[i], terms[k * M * BN + pi]);
      }
    }
    if (tid < COPIERS) issue(t + lay.ring);   // the buffer just read
  }

  // 4. this block's columns: the terms in K order (S > 1), or the accumulators
  if (ONE) {
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int pi = tid + i * THREADS;
      if (pi < M * BN) {
        const int m = pi / BN;
        out[(size_t)m * N + n0 + pi % BN] = __float2bfloat16_rn(__fmul_rn(acc[i], xs[m]));
      }
    }
    return;
  }
  cluster_sync();
  for (int i = tid; i < M * own; i += THREADS) {
    const int m = i / own, col = i % own;
    const float* tp = terms + m * own + col;
    float a = 0.f;
    for (int kb = 0; kb < nkb; ++kb) a = __fadd_rn(a, tp[(size_t)kb * M * own]);
    out[(size_t)m * N + n0 + rank * own + col] = __float2bfloat16_rn(__fmul_rn(a, xs[m]));
  }
}

template <int BN, typename T>
cudaError_t launch(const void* x, const void* w, const void* s, void* out, int M, int N, int K,
                   int S, int smem, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(int8_mm_kernel<BN, T, true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(int8_mm_kernel<BN, T, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N / BN * S);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const auto kernel = S == 1 ? int8_mm_kernel<BN, T, true> : int8_mm_kernel<BN, T, false>;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x),
                            static_cast<const int8_t*>(w), static_cast<const float*>(s),
                            static_cast<__nv_bfloat16*>(out), M, N, K, S);
}

template <int BN>
cudaError_t launch_bn(int x_f32, const void* x, const void* w, const void* s, void* out, int M,
                      int N, int K, int S, int smem, cudaStream_t stream) {
  return x_f32 ? launch<BN, float>(x, w, s, out, M, N, K, S, smem, stream)
               : launch<BN, __nv_bfloat16>(x, w, s, out, M, N, K, S, smem, stream);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// One call: an array of 8-byte slots (ops/cuda/qmm_int8.py packs them): x
// ([M, K], bf16, or f32 when x_f32), x_f32, w (int8 [K, N]), scales (f32
// [K/32, N]), out (bf16 [M, N]), M, N, K, bn, splits, stream.  The plan's
// (bn, splits) are checked here: N % bn == 0, every split a whole, non-empty
// run of 32-blocks, bn / splits >= 4 columns, the shared memory within bounds.
extern "C" int acestep_qmm_int8(const int64_t* slots) {
  const auto ptr = [&](int i) { return reinterpret_cast<const void*>(slots[i]); };
  const void* x = ptr(0);
  const int x_f32 = static_cast<int>(slots[1]);
  const void* w = ptr(2);
  const void* s = ptr(3);
  void* out = reinterpret_cast<void*>(slots[4]);
  const int M = static_cast<int>(slots[5]), N = static_cast<int>(slots[6]);
  const int K = static_cast<int>(slots[7]), bn = static_cast<int>(slots[8]);
  const int S = static_cast<int>(slots[9]);
  const cudaStream_t stream = reinterpret_cast<cudaStream_t>(slots[10]);
  if (M < 1 || M > MAXM || K < QBLK || K % QBLK || (bn != 32 && bn != 64 && bn != 128) ||
      N < bn || N % bn || S < 1 || S > MAX_SPLITS || (S & (S - 1)) || bn / S < 4 ||
      !aligned16(w) || !aligned16(s))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nkb = K / QBLK, per = (nkb + S - 1) / S;
  if ((nkb + per - 1) / per != S) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = layout(M, K, bn, S).total;
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const auto run = bn == 128 ? launch_bn<128> : bn == 64 ? launch_bn<64> : launch_bn<32>;
  const cudaError_t err = run(x_f32, x, w, s, out, M, N, K, S, smem, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();        // a refused launch is not sticky: clear it, report it
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of one block of the plan (bytes; the host's check).
extern "C" int acestep_qmm_int8_smem(int M, int K, int bn, int splits) {
  if (M < 1 || M > MAXM || K < QBLK || K % QBLK || splits < 1 || bn < 4 * splits) return -1;
  return layout(M, K, bn, splits).total;
}
