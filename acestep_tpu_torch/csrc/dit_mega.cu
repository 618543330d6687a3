// Every DiT decoder layer of one Euler step in ONE launch (batch 1).
//
// Replaces acestep_tpu/ops/pallas/dit_mega.py:158 _mega_kernel (via
// dit_layers_mega, :381): q8_0 fused stacked weights (qkv_proj, self o_proj,
// cross q_proj, cross o_proj, gateup_proj, down_proj; int8 [L, K, N] with f32
// scales [L, K/32, N]), the residual stream x [T, H] in f32, cross K/V bf16
// [L, Hkv, Lc, D] computed once per request.
//
// Bound: bytes at the main path's T = 128.  A step streams the 24 layers'
// q8_0 weights once (about 1.5 GB as stored: 0.46 ms at the H100 SXM's 3.35
// TB/s at 700 W) against 2 x 128 FLOP a weight (0.38 ms of bf16 tensor-core
// work): the step sits near the card's ridge, so the tensor-core rate counts
// as much as the bytes.  What costs more is latency: a layer is a chain of
// eleven dependent stages.
//
// Design: a persistent kernel of 3-block thread-block clusters, every block
// resident (the grid is the number of clusters the card holds at once, from
// the occupancy query; clusters of 4 fit too few times on the H100 SXM's GPCs
// and left every 32-job stage two rounds; the C entry refuses a larger
// grid), 256 threads (two warpgroups) a block.  Its blocks walk one fixed
// queue of work units, layer after layer (ops/cuda/dit_mega.py holds the same
// plan: block_queue, unit_waits, unit_signal, unit_accesses;
// tests/test_torch_dit_mega_plan.py simulates it):
//   norm sa     per NT tokens: x (x0 at layer 0) -> AdaLN -> bf16 xa_sa
//   qkv         GEMM job per head (128 columns): xa_sa @ Wqkv; epilogue q / k
//               RMSNorm and NEOX rope in f32 -> bf16 q, k; v -> bf16
//   self-attn   per (kv head, query-head pair, QB rows): softmax(q k^T) v
//   o_proj      GEMM job per 64 columns; epilogue x += out * gate_msa
//   norm cross  x -> bf16 rms(x) * cross_norm
//   cross q     GEMM job per 64 columns -> f32 q (the attention normalizes it)
//   cross-attn  as self-attn over the cached K/V with the additive encoder mask
//   cross o     GEMM job per 64 columns; epilogue x += out
//   norm mlp    x -> bf16 rms(x) * mlp_norm * (1 + mod4) + mod3
//   gate-up     GEMM job per 64 gate and the matching 64 up columns; epilogue
//               bf16(g * sigmoid(g) * u)
//   down        GEMM job per 64 columns; epilogue x += out * mod5
// with mod = scale_shift_table[l] + timestep_proj in f32.
//   * No grid barrier.  A unit waits (wait_item) only on ready counters of
//     what it reads, which the producers raise with one release add after
//     their stores; counters grow through the launch (targets are multiples
//     of the layer index + 1) and the last block to leave zeroes them.  Every
//     wait is on an earlier stage and each block walks its queue in stage
//     order, so the co-resident grid cannot deadlock.
//   * GEMMs on wgmma, out^T = W^T x^T (as csrc/qmm_wgmma.cu): the dequantized
//     weight is the register A operand (f32 multiply, one rounding to bf16),
//     the activation panel x^T the shared-memory B operand (m64n128k16, 128
//     tokens a pass).  A job is one output tile over all of K, run by the
//     three blocks of one cluster, each a contiguous third of K (rank order);
//     in the 64-column jobs the block's two warpgroups take alternate 128-row
//     K steps.  Each block parks its f32 partial tile in shared memory; after
//     a cluster barrier each block sums its third of the tile's rows over the
//     cluster's blocks in rank order through distributed shared memory and
//     runs the epilogue on them.  No split-K partial goes through device
//     memory, and reruns are bit-identical (no f32 atomics).
//   * The weights stream ahead.  The q8_0 tiles (128 K rows x two 64-column
//     halves and their scales, by TMA) depend on no activation, so each block
//     keeps the next WR tiles of its GEMM jobs in flight in a ring across
//     stage and layer boundaries, while it waits on a counter or runs
//     attention or a norm; a slot is refilled as soon as both warpgroups are
//     done with it.  The activation panel comes by TMA into a ring of XR K
//     steps after the job's wait.  A TMA instruction takes its warp long to
//     issue, and a warpgroup's wgmmas wait for its slowest warp, so the
//     copies are issued by single lanes of five different warps (T_WD0 ..
//     T_X1), while the warpgroups' previous wgmma group runs.  The two
//     warpgroups dequantize one half of the next K step while the other
//     half's wgmmas run.
//   * Attention on tensor cores (mma.sync m16n8k16 bf16, f32 sums): a unit is
//     one kv head's query-head pair x QB rows; warp w takes head w & 1 and
//     every fourth 16-key slice of each 64-key chunk.  q, K and V come to
//     shared memory by cp.async (ldmatrix from rows padded to 272 bytes): up
//     to Lk = 320 every K chunk is copied once and stays while V streams
//     through two slots; longer rows stream every chunk through a 6-chunk
//     ring.  The softmax is taken against the whole row: one pass for the max,
//     one for the sum of e = exp(s - max), one for p = bf16(e / sum) and P.V;
//     the four slices' maxima, sums and outputs are combined in slice order.
//   * The attention and norm units are not inlined (their own register
//     allocation), and the shared memory leaves 60 KB of L1 for what the
//     compiler spills.
// Everything written inside the launch is read back through L2 (TMA,
// cp.async.cg, ld.global.cg), never through the non-coherent L1; writes read
// by TMA are ordered with fence.proxy.async.
//
// Numerics (dit_mega.py:200-366, rounding point for rounding point):
//   * x stays f32 across all layers; xa, the attention outputs and the MLP
//     activation are the bf16 GEMM inputs;
//   * qkv is summed in f32 and never rounded before q/k RMSNorm and rope;
//   * mod = sst[l] + tproj in f32; xa = bf16(rms(x) * w * (1 + mod1) + mod0);
//   * scores f32, scaled by 1/sqrt(D), mask added as -1e30; softmax e / sum e
//     against the row's max; p bf16, P.V f32, rounded to bf16 before o_proj;
//   * self residual gated by mod2, cross residual ungated, MLP input with
//     mod4 / mod3 and its residual gated by mod5;
//   * act = g * sigmoid(g) * u in f32, then bf16.
// Only the order of the f32 sums differs from the plain version: bf16 x bf16
// products are exact in f32.

#include <cuda.h>            // CUtensorMap (the driver is reached through the runtime)
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int D = 128;               // head dim
constexpr int CS = 3;                // blocks of a cluster: the K splits of a GEMM job
constexpr int TT = 128;              // tokens of a GEMM pass (the wgmma width)
constexpr int KSTEP = 128;           // K rows of a weight tile
constexpr int NT = 8;                // tokens of a norm unit
constexpr int QB = 16;               // query rows of an attention unit
constexpr int KC = 64;               // keys of an attention chunk
constexpr int WR = 3, XR = 4;        // weight ring and activation ring slots
// the threads that issue the copies, one lane in each of five warps (a
// warpgroup's wgmmas wait for its slowest warp, and a TMA instruction takes
// its warp long to issue): the two halves of a weight tile's int8 rows, their
// scales, and the two 64-wide K atoms of the activation tiles
constexpr int T_WD0 = 0, T_WD1 = 32, T_WS = 64, T_X0 = 128, T_X1 = 160;
constexpr int QBLK = 32;             // q8_0 block rows
constexpr int X_SLOT = 2 * TT * 128;                 // two 64-wide K atoms of TT tokens
constexpr int W_HALF = KSTEP * 64;                   // 128 rows x 64 int8 columns
constexpr int W_SC = (KSTEP / QBLK) * 64 * 4;        // their f32 scales [4][64]
constexpr int W_SLOT = 2 * W_HALF + 2 * W_SC;
constexpr int PS = 128 + 4;                          // parked tile row stride (floats)
constexpr int PARK = TT * PS * 4;
constexpr int KROW = 2 * D + 16;                     // padded K / V row (bytes)
constexpr int CHUNK = KC * KROW;
constexpr int NCHUNK = 6;
constexpr int ATTN = NCHUNK * CHUNK;
constexpr int OPS = D + 8;                           // attention output partial row stride
constexpr int QS_AT = 7 * CHUNK;                     // the attention unit's q rows (bytes into the region)
constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int XREG = cmax(cmax(XR * X_SLOT, PARK), ATTN);
constexpr int MISC = 2048;
constexpr int SMEM = 1024 + XREG + WR * W_SLOT + MISC;
static_assert(WARPS * 16 * OPS * 4 <= QS_AT, "attention output partials fit below the q rows");
static_assert(QS_AT + 2 * QB * KROW <= XREG, "the q rows fit after seven chunk slots");
static_assert(SMEM <= 232448, "one block's shared memory");
constexpr int NSTAGE = 11;
constexpr float NEG = -1e30f;

enum Stage { NORM_SA, QKV, SELF, SO, NORM_CA, CQ, CROSS, CO, NORM_MLP, GU, DN };
enum Gemm { G_QKV, G_SO, G_CQ, G_CO, G_GU, G_DN, NGEMM };
__device__ __constant__ int GSTAGE[NGEMM] = {QKV, SO, CQ, CO, GU, DN};
// scratch regions (bytes) and sync-word groups, in the order of
// ops/cuda/dit_mega.py's REGIONS / GROUPS
enum Region { XA_SA, XA_CA, XA_MLP, R_QB, R_KB, R_VB, ATTN_S, ATTN_C, R_QC, R_ACT, REGIONS };
enum Group { C_NORM, C_QKV, C_SELF, C_CQ, C_CROSS, C_RESID, C_GU, C_DONE, GROUPS };

struct Plan {
  long long region[REGIONS + 1];   // byte offsets; [REGIONS]: the total
  long long group[GROUPS + 1];     // 32-bit word offsets; [GROUPS]: the total
};

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

Plan make_plan(long long T, long long H, long long Hq, long long Hkv, long long I) {
  const long long qdim = Hq * D;
  const long long size[REGIONS] = {T * H * 2, T * H * 2, T * H * 2, qdim * T * 2,
                                   Hkv * D * T * 2, Hkv * D * T * 2, T * qdim * 2,
                                   T * qdim * 2, T * qdim * 4, T * I * 2};
  const long long words[GROUPS] = {3, (Hq + 2 * Hkv), Hkv, qdim / 64, Hkv, 3, 1, 1};
  Plan p{};
  for (int r = 0; r < REGIONS; ++r) p.region[r + 1] = p.region[r] + cdiv(size[r], 256) * 256;
  for (int g = 0; g < GROUPS; ++g) p.group[g + 1] = p.group[g] + words[g];
  return p;
}

struct Params {
  CUtensorMap wmap[NGEMM];         // int8 [L][K][N]: boxes of 64 columns x 128 rows, 64-byte swizzle
  CUtensorMap smap[NGEMM];         // f32 scales [L][K/32][N]: boxes of 64 x 4
  CUtensorMap xmap[NGEMM];         // bf16 panels [T][K]: boxes of 64 K x 128 tokens, 128-byte swizzle
  const void* small[7];            // sa_norm, ca_norm, mlp_norm [L, H]; sst [L, 6, H];
                                   // q_norm, k_norm, cq_norm [L, D]
  const __nv_bfloat16* ck;         // [L, Hkv, Lc, D]
  const __nv_bfloat16* cv;
  const float* x0;                 // [T, H]
  const float* tproj;              // [6, H]
  const float* cos;                // [T, D]
  const float* sin;
  const float* encm;               // [Lc] additive (0 / -1e30)
  float* x;                        // [T, H] residual stream and output
  __nv_bfloat16* xa[3];            // [T, H] norm outputs: sa, cross, mlp
  __nv_bfloat16* qb;               // [Hq, T, D]
  __nv_bfloat16* kb;               // [Hkv, T, D]
  __nv_bfloat16* vb;
  __nv_bfloat16* attn[2];          // [T, Hq * D] self, cross
  float* qc;                       // [T, Hq * D] cross q before its norm
  __nv_bfloat16* act;              // [T, I]
  unsigned* g[GROUPS];
  unsigned* sync;
  unsigned long long* stamps;      // optional [2 + 11 L] %globaltimer ns (block 0)
  unsigned long long flags[8];     // sliding bit of each layer
  int small_f32;                   // the seven small tensors: 1 f32, 0 bf16
  int sync_words;
  int L, T, H, Hq, Hkv, I, Lc, window, ncl;
  int G, pairs, nqb, n_norm, passes;
  int units[NSTAGE];
  int kbeg[NGEMM][CS], kend[NGEMM][CS];   // each rank's K steps [begin, end)
  float eps, inv_sqrt_d;
};

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.  A wait
// that does not end within ~10 s is a fault of the kernel: trap, so that the
// launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  uint64_t t0 = 0;
  for (int tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    const uint64_t now = globaltimer();
    if (tries == 0) t0 = now;
    else if (now - t0 > 10000000000ull) asm volatile("trap;");
  }
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// generic-proxy accesses before it, ordered with async-proxy (TMA, wgmma)
// accesses after it: shared memory / global memory
__device__ __forceinline__ void fence_proxy_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The cluster barrier in two halves: every thread of the cluster arrives, and
// later waits for the others (work may run in between); the release / acquire
// order makes shared-memory stores before the arrive visible to the cluster's
// loads after the wait
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// 16 bytes at `addr` in the shared memory of block `rank` of the cluster
__device__ __forceinline__ float4 ld_cluster(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(addr), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* a) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(a) : "memory");
  return v;
}

// Spin until *a >= target, then read it once more with acquire semantics (the
// caller's __syncthreads passes that on to the block).  A wait that does not
// end within ~10 s is a fault of the kernel (a broken plan): trap.
__device__ void spin_ge(const unsigned* a, unsigned target) {
  if (ld_relaxed(a) < target) {
    const unsigned long long t0 = globaltimer();
    for (unsigned tries = 1; ld_relaxed(a) < target; ++tries) {
      __nanosleep(64);
      if (tries % 1024 == 0 && globaltimer() - t0 > 10000000000ull) asm volatile("trap;");
    }
  }
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(a) : "memory");
  (void)v;
}

// The block's writes before it are published on counter c: __syncthreads
// passes them on to thread 0, whose release add publishes them; where the
// consumers read them by TMA (`tma`), each thread first orders its stores
// with the async proxy.
__device__ __forceinline__ void publish(unsigned* c, bool tma) {
  if (tma) fence_proxy_global();
  __syncthreads();
  if (threadIdx.x == 0) asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(c) : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving register reads or writes across a wgmma
// boundary (wgmma reads and writes them asynchronously)
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t (&r)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// wgmma shared-memory descriptor of a K-major operand under the 128-byte
// swizzle: rows of 128 bytes (64 bf16 of K), 8-row groups 1024 bytes apart;
// `addr` is the atom's 1024-aligned base plus 32 bytes per 16-wide K slice
__device__ __forceinline__ uint64_t kmajor_sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d += A (64 x 16 bf16, four registers a thread) * B (by descriptor), D 64 x 128 f32
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d += a (16 x 16 bf16) b (16 x 8 bf16), f32
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // cvt.rn.bf16x2.f32
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 0x4B000000 (the float 2^23) in a register the compiler cannot see through,
// so that the byte permutes below keep their selector as the immediate
__device__ __forceinline__ uint32_t magic_reg() {
  uint32_t m;
  asm volatile("mov.b32 %0, 0x4B000000;" : "=r"(m));
  return m;
}

// byte C (0..1) of `w` as the float 2^23 + byte, exactly; `m` holds 0x4B000000
template <int C>
__device__ __forceinline__ float magic(uint32_t w, uint32_t m) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(w), "r"(m), "n"(0x7540 + C));
  return __int_as_float(static_cast<int>(d));
}

__device__ __forceinline__ uint32_t lds16(const uint8_t* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the launch's read-only inputs, through the read-only data path
__device__ __forceinline__ float ld_small(const Params& p, const void* a, size_t i) {
  return p.small_f32 ? __ldg(static_cast<const float*>(a) + i)
                     : __bfloat162float(__ushort_as_bfloat16(
                           __ldg(static_cast<const unsigned short*>(a) + i)));
}

__device__ __forceinline__ float modv(const Params& p, int l, int j, int c) {
  return __fadd_rn(ld_small(p, p.small[3], ((size_t)l * 6 + j) * p.H + c),
                   __ldg(p.tproj + (size_t)j * p.H + c));
}

__device__ __forceinline__ void stamp(const Params& p, int i) {
  if (p.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) p.stamps[i] = globaltimer();
}

// ---------------------------------------------------------------------------
// the block's shared memory and rings
// ---------------------------------------------------------------------------

struct Smem {
  uint8_t* xreg;        // activation ring / parked tile / attention chunks
  uint8_t* wring;       // WR weight slots
  uint64_t* wfull;      // [WR]
  uint64_t* xfull;      // [XR]
  float* red;           // [WARPS][16] attention maxima / sums
  int wuse, xuse;       // tiles consumed (every thread)
  int wfill, xfill;     // tiles issued (thread 0)
  bool parked;          // the cluster may still read this block's parked tile
};

// Before the block writes its activation region again: the cluster's blocks
// have all passed the arrive that followed their reads of the parked tiles.
__device__ __forceinline__ void unpark(Smem& s) {
  if (s.parked) {
    cluster_wait();
    s.parked = false;
  }
}

// The weight stream's cursor: tile i of pass p of GEMM job j of GEMM gi in
// layer l, over the cluster's jobs in queue order (the weight copy threads
// only), with GEMM gi's bounds for this rank kept at hand: its jobs, tiles a
// pass and K steps [sb, se).
struct WCur {
  int l, gi, j, p, i;
  bool more;
  int units, ns, sb, se;
};

__device__ __forceinline__ bool mode_a(int gi) { return gi == G_QKV || gi == G_GU; }

// super-steps (weight tiles) of rank r in one pass of a job of GEMM gi
__device__ __forceinline__ int nsup(const Params& p, int gi, int r) {
  const int n = p.kend[gi][r] - p.kbeg[gi][r];
  return mode_a(gi) ? n : (n + 1) / 2;
}

// Move the cursor to the first tile at or after its (possibly past-the-end)
// position.
__device__ __forceinline__ void wseek(const Params& p, WCur& w, int c, int r) {
  for (;;) {
    if (w.l >= p.L) {
      w.more = false;
      return;
    }
    if (w.j < w.units) {
      if (w.p < p.passes) {
        if (w.i < w.ns) return;
        w.i = 0;
        ++w.p;
        continue;
      }
      w.p = 0;
      w.j += p.ncl;
      continue;
    }
    w.j = c;
    w.p = 0;
    w.i = 0;
    if (++w.gi == NGEMM) {
      w.gi = 0;
      ++w.l;
    }
    w.units = p.units[GSTAGE[w.gi]];
    w.ns = nsup(p, w.gi, r);
    w.sb = p.kbeg[w.gi][r];
    w.se = p.kend[w.gi][r];
  }
}

// Advance the cursor by one tile.
__device__ __forceinline__ void wnext(const Params& p, WCur& w, int c, int r) {
  if (++w.i < w.ns) return;            // the next tile of the same job pass
  wseek(p, w, c, r);
}

// Issue part `part` of the weight tile at the cursor into the next weight
// slot: half 0 of its int8 rows and the slot's transaction count (T_WD0),
// half 1 (T_WD1), or both halves' scales (T_WS); each of the three threads
// keeps its own cursor.  Mode A: both halves
// one K step (qkv: the head's two 64-column halves; gate-up: 64 gate columns
// and the matching up columns); otherwise half h is K step begin + 2 i + h of
// the job's 64 columns.
__device__ __forceinline__ void issue_w(const Params& p, Smem& s, WCur& w, int c, int r,
                                        int part) {
  if (!w.more) return;
  const int slot = s.wfill % WR;
  uint8_t* dst = s.wring + slot * W_SLOT;
  uint64_t* bar = s.wfull + slot;
  const int gi = w.gi, sb = w.sb, se = w.se;
  int step[2], col[2];
  bool ok[2] = {true, true};
  if (mode_a(gi)) {
    step[0] = step[1] = sb + w.i;
    if (gi == G_QKV) {
      col[0] = 128 * w.j;
      col[1] = 128 * w.j + 64;
    } else {
      col[0] = 64 * w.j;
      col[1] = p.I + 64 * w.j;
    }
  } else {
    step[0] = sb + 2 * w.i;
    step[1] = step[0] + 1;
    ok[1] = step[1] < se;
    col[0] = col[1] = 64 * w.j;
  }
  if (part == 0) mbar_expect_tx(bar, (ok[1] ? 2 : 1) * (W_HALF + W_SC));
  if (part < 2) {
    if (ok[part])
      tma_load_3d(dst + part * W_HALF, &p.wmap[gi], col[part], KSTEP * step[part], w.l, bar);
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (ok[h])
        tma_load_3d(dst + 2 * W_HALF + h * W_SC, &p.smap[gi], col[h], (KSTEP / QBLK) * step[h],
                    w.l, bar);
  }
  ++s.wfill;
  wnext(p, w, c, r);
}

// Issue K atom `atom` of K step `step` of pass `pass` of GEMM gi's activation
// panel into the next activation slot (atom 0 with the slot's transaction
// count; T_X0 / T_X1, each with its own count of slots filled)
__device__ __forceinline__ void issue_x(const Params& p, Smem& s, int gi, int pass, int step,
                                        int atom) {
  const int slot = s.xfill % XR;
  uint64_t* bar = s.xfull + slot;
  if (atom == 0) mbar_expect_tx(bar, X_SLOT);
  tma_load_2d(s.xreg + slot * X_SLOT + atom * (X_SLOT / 2), &p.xmap[gi], KSTEP * step + 64 * atom,
              TT * pass, bar);
  ++s.xfill;
}

// ---------------------------------------------------------------------------
// GEMM jobs
// ---------------------------------------------------------------------------

// byte offset of (row, column byte colb) in a weight half: rows of 64 bytes
// under TMA's 64-byte swizzle (16-byte chunk ^= (row >> 1) & 3); the four
// lanes of a quad read rows 2q + {0, 1, 8, 9} of a slice, which it spreads
// over the banks
__device__ __forceinline__ int w64(int row, int colb) {
  return row * 64 + ((((colb >> 4) ^ (row >> 1)) & 3) << 4) + (colb & 15);
}

// The A fragments of slice pair jj of a weight half (int8 rows `hb`, f32
// scales `sc` [4][64]): a[0..3] K rows 16 jj + [0, 16) (x atom 0), a[4..7]
// K rows 64 + 16 jj + [0, 16) (atom 1).  Registers 0-3 of a slice hold
// (column 0, K 2q and 2q + 1), (column 1, same), (column 0, K 2q + 8, 2q + 9),
// (column 1, same) of the thread's 2 columns colb, colb + 1.
__device__ __forceinline__ void dequant_pair(const uint8_t* hb, const float* sc, int jj, int q,
                                             int colb, uint32_t m, uint32_t (&a)[8]) {
  constexpr float OFF = 8388736.f;   // 2^23 + 128: the int8 byte with its sign bit flipped
  const float2 dlo = *reinterpret_cast<const float2*>(sc + (jj >> 1) * 64 + colb);
  const float2 dhi = *reinterpret_cast<const float2*>(sc + (2 + (jj >> 1)) * 64 + colb);
  const int r0 = 16 * jj + 2 * q;
  uint32_t nl[4], nh[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = r0 + (e & 1) + 8 * (e >> 1);
    nl[e] = lds16(hb + w64(row, colb)) ^ 0x8080u;
    nh[e] = lds16(hb + w64(64 + row, colb)) ^ 0x8080u;
  }
  float lo[4][2], hi[4][2];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    lo[e][0] = __fmul_rn(__fsub_rn(magic<0>(nl[e], m), OFF), dlo.x);
    lo[e][1] = __fmul_rn(__fsub_rn(magic<1>(nl[e], m), OFF), dlo.y);
    hi[e][0] = __fmul_rn(__fsub_rn(magic<0>(nh[e], m), OFF), dhi.x);
    hi[e][1] = __fmul_rn(__fsub_rn(magic<1>(nh[e], m), OFF), dhi.y);
  }
  a[0] = pack_bf16(lo[0][0], lo[1][0]);
  a[1] = pack_bf16(lo[0][1], lo[1][1]);
  a[2] = pack_bf16(lo[2][0], lo[3][0]);
  a[3] = pack_bf16(lo[2][1], lo[3][1]);
  a[4] = pack_bf16(hi[0][0], hi[1][0]);
  a[5] = pack_bf16(hi[0][1], hi[1][1]);
  a[6] = pack_bf16(hi[2][0], hi[3][0]);
  a[7] = pack_bf16(hi[2][1], hi[3][1]);
}

// After super-step i of a job-pass is done with its slots, the copy threads
// refill the weight slot with the stream's next tile and the activation
// slots with the job's K steps XR further on.
__device__ __forceinline__ void release_step(const Params& p, Smem& s, WCur& w, int c, int r,
                                             int gi, int pass, int i, int nx) {
  const int tid = threadIdx.x;
  if (tid == T_WD0 || tid == T_WD1 || tid == T_WS) {
    issue_w(p, s, w, c, r, tid == T_WD0 ? 0 : tid == T_WD1 ? 1 : 2);
  } else if (tid == T_X0 || tid == T_X1) {
    const int sb = p.kbeg[gi][r];
    const int k0 = mode_a(gi) ? i : 2 * i, k1 = mode_a(gi) ? i + 1 : min(2 * i + 2, nx);
    for (int k = k0; k < k1; ++k)
      if (k + XR < nx) issue_x(p, s, gi, pass, sb + k + XR, tid == T_X0 ? 0 : 1);
  }
}

// The epilogue of one output row (token t, valid or not: warp-wide
// reductions need every lane) of GEMM gi, job j: lane holds columns 4 lane ..
// 4 lane + 3 of the 128-column sum v (64-column jobs: lanes 0-15 warpgroup
// 0's partial, lanes 16-31 warpgroup 1's of the same columns).  a0 / a1: the
// row's inputs loaded ahead (qkv: cos and sin; residual stages: x); cw the
// lane's per-column factors (qkv: the q / k norm weight; o_proj and down:
// the gate).
__device__ __forceinline__ void epilogue(const Params& p, int gi, int l, int j, int t, bool valid,
                                         float4 v, float4 a0, float4 a1, const float (&cw)[4]) {
  const int lane = threadIdx.x & 31;
  float y[4] = {v.x, v.y, v.z, v.w};
  if (gi == G_QKV) {
    const int hq = p.Hq, hkv = p.Hkv;
    if (j < hq + hkv) {           // q or k: RMSNorm and NEOX rope
      float ss = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) ss = fmaf(y[e], y[e], ss);
      const float rr = 1.f / sqrtf(warp_sum(ss) / (float)D + p.eps);
      const float cs[4] = {a0.x, a0.y, a0.z, a0.w}, sn[4] = {a1.x, a1.y, a1.z, a1.w};
      float z[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) z[e] = __fmul_rn(__fmul_rn(y[e], rr), cw[e]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float other = __shfl_xor_sync(0xffffffffu, z[e], 16);
        const float rot = lane < 16 ? -other : other;
        y[e] = __fadd_rn(__fmul_rn(z[e], cs[e]), __fmul_rn(rot, sn[e]));
      }
    }
    if (!valid) return;
    __nv_bfloat16* dst = j < hq ? p.qb + ((size_t)j * p.T + t) * D
                         : j < hq + hkv ? p.kb + ((size_t)(j - hq) * p.T + t) * D
                                        : p.vb + ((size_t)(j - hq - hkv) * p.T + t) * D;
    *reinterpret_cast<uint2*>(dst + 4 * lane) = make_uint2(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]));
    return;
  }
  // the other jobs: lanes 0-15 hold the output (64-column jobs: both
  // warpgroups' partials added; gate-up: lanes 16-31 hold up)
  float o[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) o[e] = __shfl_xor_sync(0xffffffffu, y[e], 16);
  if (!valid || lane >= 16) return;
  const int c = 64 * j + 4 * lane;
  if (gi == G_GU) {
    if (c >= p.I) return;
    float a[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float g = y[e], u = o[e];
      const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-g)));
      a[e] = __fmul_rn(__fmul_rn(g, sig), u);
    }
    *reinterpret_cast<uint2*>(p.act + (size_t)t * p.I + c) =
        make_uint2(pack_bf16(a[0], a[1]), pack_bf16(a[2], a[3]));
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) y[e] = y[e] + o[e];
  if (gi == G_CQ) {
    if (c < p.Hq * D)
      __stcg(reinterpret_cast<float4*>(p.qc + (size_t)t * p.Hq * D + c), make_float4(y[0], y[1], y[2], y[3]));
    return;
  }
  if (c >= p.H) return;
  const float xv[4] = {a0.x, a0.y, a0.z, a0.w};
  float r[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) r[e] = __fadd_rn(xv[e], gi == G_CO ? y[e] : __fmul_rn(y[e], cw[e]));
  __stcg(reinterpret_cast<float4*>(p.x + (size_t)t * p.H + c), make_float4(r[0], r[1], r[2], r[3]));
}

// One pass of GEMM job j of GEMM gi in layer l, this block's rank r of the
// cluster: its K steps into the accumulators, the partial tile parked, the
// tile's rows of this rank summed over the cluster and the epilogue.
__device__ __forceinline__ void gemm_pass(const Params& p, Smem& s, WCur& w, int l, int gi,
                                          int j, int pass, int c, int r) {
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127, wq = t >> 5, lane = tid & 31;
  const int q = lane & 3, colb = 2 * (8 * wq + (lane >> 2));
  const int sb = p.kbeg[gi][r], nx = p.kend[gi][r] - sb;
  const bool ma = mode_a(gi);
  const int ns = ma ? nx : (nx + 1) / 2;
  unpark(s);
  if (tid == T_X0 || tid == T_X1) {
    fence_proxy_shared();          // earlier generic use of the region, then TMA writes
    fence_proxy_global();          // the panel's producers' writes, then TMA reads
    for (int k = 0; k < min(XR, nx); ++k) issue_x(p, s, gi, pass, sb + k, tid == T_X0 ? 0 : 1);
  }
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  if (ns > 0) {
    uint32_t a[4][8];
    const uint32_t m = magic_reg();
    // this warpgroup's activation tile of super-step i, and whether it has one
    auto mine = [&](int i) { return ma ? i : 2 * i + wg; };
    auto half = [&](int i, int h, uint32_t (&x0)[8], uint32_t (&x1)[8]) {
      const uint8_t* slot = s.wring + ((s.wuse + i) % WR) * W_SLOT;
      const uint8_t* hb = slot + wg * W_HALF;
      const float* sc = reinterpret_cast<const float*>(slot + 2 * W_HALF + wg * W_SC);
      dequant_pair(hb, sc, 2 * h, q, colb, m, x0);
      dequant_pair(hb, sc, 2 * h + 1, q, colb, m, x1);
    };
    mbar_wait(s.wfull + s.wuse % WR, (s.wuse / WR) & 1);
    if (mine(0) < nx) half(0, 0, a[0], a[1]);
    reg_fence(acc);
    for (int i = 0; i < ns; ++i) {
      const bool on = mine(i) < nx;
      const int xs = s.xuse + mine(i);
      if (on) mbar_wait(s.xfull + xs % XR, (xs / XR) & 1);
      const uint32_t xaddr = smem_u32(s.xreg + (xs % XR) * X_SLOT);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        wgmma_fence();
        if (on) {
#pragma unroll
          for (int jj = 2 * h; jj < 2 * h + 2; ++jj) {    // x atom 0: low slices, atom 1: high
            wgmma_rs(acc, a[jj], kmajor_sw128_desc(xaddr + 32 * jj));
            wgmma_rs(acc, a[jj] + 4, kmajor_sw128_desc(xaddr + X_SLOT / 2 + 32 * jj));
          }
        }
        wgmma_commit();
        // super-step i - 1's slots, free since the barrier at h = 0, are
        // refilled while this group runs
        if (h == 1 && i > 0) release_step(p, s, w, c, r, gi, pass, i - 1, nx);
        wgmma_wait<1>();                   // the group before this one is done
        if (h == 0 && i > 0) __syncthreads();   // so is super-step i - 1, in both warpgroups
        if (h == 0) {
          reg_fence(a[2]);
          reg_fence(a[3]);
          if (on) half(i, 1, a[2], a[3]);
        } else if (i + 1 < ns) {
          mbar_wait(s.wfull + (s.wuse + i + 1) % WR, ((s.wuse + i + 1) / WR) & 1);
          reg_fence(a[0]);
          reg_fence(a[1]);
          if (mine(i + 1) < nx) half(i + 1, 0, a[0], a[1]);
        }
      }
    }
    wgmma_wait<0>();
    reg_fence(acc);
    __syncthreads();
    release_step(p, s, w, c, r, gi, pass, ns - 1, nx);
    s.wuse += ns;
    s.xuse += nx;
  }
  __syncthreads();
  // park the partial tile [token][128 columns] (warpgroup wg: columns 64 wg ..)
  float* park = reinterpret_cast<float*>(s.xreg);
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if ((i >> 1) & 1) continue;
    const int row = (i >> 2) * 8 + 2 * q + (i & 1);
    *reinterpret_cast<float2*>(park + row * PS + wg * 64 + colb) = make_float2(acc[i], acc[i + 2]);
  }
  cluster_arrive();                    // the parked tile, released to the cluster
  // the epilogue's inputs that do not depend on the sums, loaded while the
  // cluster gathers: per row cos / sin (qkv) or the residual (o_proj, cross
  // o_proj, down); per column the q / k norm weight (qkv) or the gate
  const int warp = tid >> 5;
  constexpr int ROWS = (TT / CS + 1 + WARPS - 1) / WARPS;
  const int lo = r * TT / CS, hi = (r + 1) * TT / CS;
  const bool resid = gi == G_SO || gi == G_CO || gi == G_DN;
  const bool qk = gi == G_QKV && j < p.Hq + p.Hkv;
  const int c4 = 64 * j + 4 * lane;
  const bool xlane = resid && lane < 16 && c4 < p.H;
  float cw[4] = {0.f, 0.f, 0.f, 0.f};
  if (qk) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      cw[e] = ld_small(p, j < p.Hq ? p.small[4] : p.small[5], (size_t)l * D + 4 * lane + e);
  } else if (xlane && gi != G_CO) {
#pragma unroll
    for (int e = 0; e < 4; ++e) cw[e] = modv(p, l, gi == G_SO ? 2 : 5, c4 + e);
  }
  float4 pre0[ROWS], pre1[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int row = lo + warp + WARPS * k, tok = TT * pass + row;
    pre0[k] = pre1[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row >= hi || tok >= p.T) continue;
    if (qk) {
      pre0[k] = __ldg(reinterpret_cast<const float4*>(p.cos + (size_t)tok * D + 4 * lane));
      pre1[k] = __ldg(reinterpret_cast<const float4*>(p.sin + (size_t)tok * D + 4 * lane));
    } else if (xlane) {
      const float* xr = (gi == G_SO && l == 0 ? p.x0 : p.x) + (size_t)tok * p.H + c4;
      pre0[k] = gi == G_SO && l == 0 ? __ldg(reinterpret_cast<const float4*>(xr))
                                     : __ldcg(reinterpret_cast<const float4*>(xr));
    }
  }
  cluster_wait();
  // this rank's rows of the tile, summed over the cluster in rank order
  float4 v[ROWS][CS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int row = lo + warp + WARPS * k;
    const uint32_t addr = smem_u32(park + min(row, TT - 1) * PS + 4 * lane);
#pragma unroll
    for (int z = 0; z < CS; ++z)
      v[k][z] = row < hi ? ld_cluster(addr, z) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int row = lo + warp + WARPS * k;
    if (row >= hi) continue;                     // warp-uniform
    float4 sum = v[k][0];
#pragma unroll
    for (int z = 1; z < CS; ++z) {
      sum.x += v[k][z].x;
      sum.y += v[k][z].y;
      sum.z += v[k][z].z;
      sum.w += v[k][z].w;
    }
    const int tok = TT * pass + row;
    epilogue(p, gi, l, j, tok, tok < p.T, sum, pre0[k], pre1[k], cw);
  }
  unsigned* ctr = gi == G_QKV ? p.g[C_QKV] + j : gi == G_CQ ? p.g[C_CQ] + j
                  : gi == G_GU ? p.g[C_GU] : p.g[C_RESID] + (gi == G_SO ? 0 : gi == G_CO ? 1 : 2);
  publish(ctr, gi == G_GU);
  cluster_arrive();                    // done reading the cluster's parked tiles
  s.parked = true;
}

// ---------------------------------------------------------------------------
// norm units: NT tokens, a warp a token
// ---------------------------------------------------------------------------

// (not inlined: its own register allocation; the caller has unparked the region)
__device__ __noinline__ void norm_unit(const Params& p, uint8_t* xreg, int kind, int l, int u) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, H = p.H;
  const int t = u * NT + warp;
  const bool ok = t < p.T, first = kind == 0 && l == 0;
  const float* src = (first ? p.x0 : p.x) + (size_t)(ok ? t : 0) * H;
  // the row's loads first, all in flight (H <= 128 NV: a lane holds its
  // columns 4 lane + 128 i in registers; longer rows are read twice)
  constexpr int NV = 16;
  const int nv = H / 128;
  const bool held = nv <= NV;
  float4 v[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ok && held && i < nv) {
      const float4* a = reinterpret_cast<const float4*>(src + 128 * i + 4 * lane);
      v[i] = first ? __ldg(a) : __ldcg(a);
    }
  }
  // the per-column factors into shared memory: the norm weight, 1 + scale
  // and shift of the modulation (sa: rows 1 / 0, mlp: rows 4 / 3)
  float* fw = reinterpret_cast<float*>(xreg);
  float* fs = fw + H;
  float* fh = fs + H;
  const int js = kind == 0 ? 0 : 3;
  for (int c0 = tid; c0 < H; c0 += 8 * THREADS) {       // all loads of 8 columns in flight
    float w[8], sc[8], sh[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = c0 + k * THREADS;
      w[k] = sc[k] = sh[k] = 0.f;
      if (c < H) {
        w[k] = ld_small(p, p.small[kind], (size_t)l * H + c);
        if (kind != 1) {
          sc[k] = modv(p, l, js + 1, c);
          sh[k] = modv(p, l, js, c);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = c0 + k * THREADS;
      if (c < H) {
        fw[c] = w[k];
        fs[c] = __fadd_rn(1.f, sc[k]);
        fh[c] = sh[k];
      }
    }
  }
  __syncthreads();
  if (ok) {
    // (the held row indexed at compile time only: a runtime index would put
    // it in local memory)
    float ss = 0.f;
    if (held) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        ss = fmaf(v[i].x, v[i].x, ss);
        ss = fmaf(v[i].y, v[i].y, ss);
        ss = fmaf(v[i].z, v[i].z, ss);
        ss = fmaf(v[i].w, v[i].w, ss);
      }
    } else {
      for (int c = 4 * lane; c < H; c += 128) {
        const float4 x4 = first ? __ldg(reinterpret_cast<const float4*>(src + c))
                                : __ldcg(reinterpret_cast<const float4*>(src + c));
        ss = fmaf(x4.x, x4.x, ss);
        ss = fmaf(x4.y, x4.y, ss);
        ss = fmaf(x4.z, x4.z, ss);
        ss = fmaf(x4.w, x4.w, ss);
      }
    }
    const float rr = 1.f / sqrtf(warp_sum(ss) / (float)H + p.eps);
    __nv_bfloat16* dst = p.xa[kind] + (size_t)t * H;
    auto out = [&](int c, float4 x4) {
      const float4 w4 = *reinterpret_cast<const float4*>(fw + c);
      const float4 s4 = *reinterpret_cast<const float4*>(fs + c);
      const float4 h4 = *reinterpret_cast<const float4*>(fh + c);
      const float xv[4] = {x4.x, x4.y, x4.z, x4.w}, wv[4] = {w4.x, w4.y, w4.z, w4.w};
      const float sv[4] = {s4.x, s4.y, s4.z, s4.w}, hv[4] = {h4.x, h4.y, h4.z, h4.w};
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float xn = __fmul_rn(__fmul_rn(xv[e], rr), wv[e]);
        y[e] = kind == 1 ? xn : __fadd_rn(__fmul_rn(xn, sv[e]), hv[e]);
      }
      *reinterpret_cast<uint2*>(dst + c) = make_uint2(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]));
    };
    if (held) {
#pragma unroll
      for (int i = 0; i < NV; ++i)
        if (i < nv) out(128 * i + 4 * lane, v[i]);
    } else {
      for (int c = 4 * lane; c < H; c += 128)
        out(c, first ? __ldg(reinterpret_cast<const float4*>(src + c))
                     : __ldcg(reinterpret_cast<const float4*>(src + c)));
    }
  }
  publish(p.g[C_NORM] + kind, true);
}

// ---------------------------------------------------------------------------
// attention units: (kv head, query-head pair, QB rows) on mma.sync
// ---------------------------------------------------------------------------

// (not inlined: its own register allocation; the caller has unparked the
// region; `red` holds [WARPS][16] floats)
template <bool CROSS>
__device__ __noinline__ void attn_unit(const Params& p, uint8_t* xreg, float* red, int l, int u) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tq = lane & 3;
  const int hs = warp & 1, sp = warp >> 1;          // head slot, key slice
  const int kv = u / (p.pairs * p.nqb), pair = (u / p.nqb) % p.pairs, qblk = u % p.nqb;
  const int q0 = qblk * QB;
  const int Lk = CROSS ? p.Lc : p.T;
  const int nc = (Lk + KC - 1) / KC;
  const bool sliding = !CROSS && ((p.flags[l >> 6] >> (l & 63)) & 1ull);
  const __nv_bfloat16* Ks = CROSS ? p.ck + ((size_t)l * p.Hkv + kv) * p.Lc * D : p.kb + (size_t)kv * p.T * D;
  const __nv_bfloat16* Vs = CROSS ? p.cv + ((size_t)l * p.Hkv + kv) * p.Lc * D : p.vb + (size_t)kv * p.T * D;
  uint8_t* ring = xreg;

  // K / V chunk c (KC rows, zeros past Lk) into a ring slot
  auto load = [&](bool isv, int c, uint8_t* dst) {
    const __nv_bfloat16* src = (isv ? Vs : Ks) + (size_t)c * KC * D;
#pragma unroll
    for (int k = 0; k < KC * (D / 8) / THREADS; ++k) {
      const int idx = tid + k * THREADS, row = idx >> 4, piece = idx & 15;
      const bool ok = c * KC + row < Lk;
      cp_async16(dst + row * KROW + piece * 16, ok ? src + row * D + piece * 8 : src, ok);
    }
  };
  // Items: K chunks (max pass), K chunks (sum pass), then K and V of each
  // chunk (P.V pass).  Where the K chunks and two V chunks fit (`resident`:
  // Lk <= 320), every K chunk is copied once, at the start, and stays; the V
  // chunks stream through the two slots after them.  Otherwise every item is
  // streamed through the NCHUNK-slot ring, item i into slot i % NCHUNK.
  const int items = 4 * nc;
  const bool resident = nc + 2 <= QS_AT / CHUNK;
  auto stream = [&](int i) {
    const bool isv = i >= 2 * nc && ((i - 2 * nc) & 1);
    load(isv, i < 2 * nc ? i % nc : (i - 2 * nc) >> 1, ring + (i % NCHUNK) * CHUNK);
  };
  // the unit's q rows (head slot, QB rows, D dims: bf16, rows padded like K)
  // in shared memory after the chunk slots; each warp reads its head's A
  // fragments from there with ldmatrix (registers are the scarce resource)
  uint8_t* qs = ring + QS_AT;
  if (!CROSS) {
    for (int i = tid; i < 2 * QB * (D / 8); i += THREADS) {
      const int hsl = i / (QB * (D / 8)), row = (i / (D / 8)) % QB, piece = i % (D / 8);
      const int hh = kv * p.G + 2 * pair + hsl, t = q0 + row;
      const bool ok = 2 * pair + hsl < p.G && t < p.T;
      cp_async16(qs + (hsl * QB + row) * KROW + piece * 16,
                 ok ? p.qb + ((size_t)hh * p.T + t) * D + piece * 8 : p.qb, ok);
    }
    cp_async_commit();
  } else {
    // the cross q: bf16(rms(q) * cq_norm); warp w takes rows w, w + 8, ... of
    // the 2 x QB (head slot, row) pairs, lane the dims 4 lane .. 4 lane + 3
    const size_t qd = (size_t)p.Hq * D;
    float wq[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) wq[e] = ld_small(p, p.small[6], (size_t)l * D + 4 * lane + e);
#pragma unroll
    for (int k = 0; k < 2 * QB / WARPS; ++k) {
      const int pr = warp + WARPS * k, hsl = pr / QB, row = pr % QB;
      const int hh = kv * p.G + 2 * pair + hsl, t = q0 + row;
      const bool ok = 2 * pair + hsl < p.G && t < p.T;
      const float4 v = ok ? __ldcg(reinterpret_cast<const float4*>(p.qc + t * qd + hh * D + 4 * lane))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      const float ss = warp_sum(fmaf(v.x, v.x, fmaf(v.y, v.y, fmaf(v.z, v.z, v.w * v.w))));
      const float rr = 1.f / sqrtf(ss / (float)D + p.eps);
      *reinterpret_cast<uint2*>(qs + (hsl * QB + row) * KROW + 8 * lane) =
          make_uint2(pack_bf16(__fmul_rn(__fmul_rn(v.x, rr), wq[0]), __fmul_rn(__fmul_rn(v.y, rr), wq[1])),
                     pack_bf16(__fmul_rn(__fmul_rn(v.z, rr), wq[2]), __fmul_rn(__fmul_rn(v.w, rr), wq[3])));
    }
  }

  if (resident) {
    for (int c = 0; c < nc; ++c) load(false, c, ring + c * CHUNK);
    cp_async_commit();
    for (int c = 0; c < 2; ++c) {
      if (c < nc) load(true, c, ring + (nc + c) * CHUNK);
      cp_async_commit();
    }
  } else {
#pragma unroll
    for (int k = 0; k < NCHUNK - 1; ++k) {
      if (k < items) stream(k);
      cp_async_commit();
    }
  }

  // lane addresses: K (ldmatrix) rows 16 sp + (lane & 7) + 8 (lane >> 4),
  // column half (lane >> 3) & 1; V (ldmatrix.trans) rows 16 sp + (lane & 7) +
  // 8 ((lane >> 3) & 1), column half lane >> 4
  const uint32_t ring0 = smem_u32(ring);
  const uint32_t koff = (16 * sp + (lane & 7) + 8 * (lane >> 4)) * KROW + ((lane >> 3) & 1) * 16;
  const uint32_t voff = (16 * sp + (lane & 7) + 8 * ((lane >> 3) & 1)) * KROW + (lane >> 4) * 16;
  // q (ldmatrix, A operand): rows hs QB + (lane & 7) + 8 ((lane >> 3) & 1), column half lane >> 4
  const uint32_t qaddr = smem_u32(qs) + (hs * QB + (lane & 7) + 8 * ((lane >> 3) & 1)) * KROW +
                         (lane >> 4) * 16;
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
  float o[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  uint32_t pa[4] = {0u, 0u, 0u, 0u};

  for (int i = 0; i < items; ++i) {
    const int pass = i < nc ? 1 : i < 2 * nc ? 2 : 3;
    const int c = pass < 3 ? i % nc : (i - 2 * nc) >> 1;
    const bool isv = pass == 3 && ((i - 2 * nc) & 1);
    // wait for the item's chunk: resident, the K chunks once, then each V
    // chunk (the next may be in flight); streamed, all but the NCHUNK - 2
    // items after it
    if (resident) {
      if (i == 0) {
        cp_async_wait<2>();
        __syncthreads();
      } else if (isv) {
        cp_async_wait<1>();
        __syncthreads();
      }
    } else {
      cp_async_wait<NCHUNK - 2>();
      __syncthreads();
    }
    const uint32_t slot = ring0 + (resident ? (isv ? nc + (c & 1) : c) : i % NCHUNK) * CHUNK;
    if (!isv) {
      float sc[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        uint32_t qa[4], b[4];
        ldsm_x4(qa, qaddr + kk * 32);
        ldsm_x4(b, slot + koff + kk * 32);
        mma16816(sc[0], qa, b[0], b[1]);
        mma16816(sc[1], qa, b[2], b[3]);
      }
      // scale and mask; keys past Lk are -inf (no weight)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = c * KC + 16 * sp + 8 * n + 2 * tq + (e & 1);
          const int qi = q0 + gid + 8 * (e >> 1);
          float v = __fmul_rn(sc[n][e], p.inv_sqrt_d);
          if (kj >= Lk) v = -INFINITY;
          else if (CROSS) v = __fadd_rn(v, __ldg(p.encm + kj));
          else if (sliding && abs(qi - kj) > p.window) v = __fadd_rn(v, NEG);
          sc[n][e] = v;
        }
      if (pass == 1) {
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
      } else {
        float ev[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float m = mx[e >> 1];
            ev[n][e] = sc[n][e] == -INFINITY ? 0.f : expf(sc[n][e] - m);
          }
        if (pass == 2) {
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) sum[e >> 1] += ev[n][e];
        } else {
          float pv[2][4];
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) pv[n][e] = __fdiv_rn(ev[n][e], sum[e >> 1]);
          pa[0] = pack_bf16(pv[0][0], pv[0][1]);
          pa[1] = pack_bf16(pv[0][2], pv[0][3]);
          pa[2] = pack_bf16(pv[1][0], pv[1][1]);
          pa[3] = pack_bf16(pv[1][2], pv[1][3]);
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t b[4];
        ldsm_x4_t(b, slot + voff + n * 32);
        mma16816(o[2 * n], pa, b[0], b[1]);
        mma16816(o[2 * n + 1], pa, b[2], b[3]);
      }
    }
    // after the last chunk of the max / sum pass: the row's value over the
    // quad, then over the four key slices of the head in slice order
    if ((pass == 1 || pass == 2) && c == nc - 1) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        float v = pass == 1 ? mx[k] : sum[k];
        if (pass == 1) {
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
        } else {
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
        }
        if (tq == 0) red[warp * 16 + gid + 8 * k] = v;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        float v = red[hs * 16 + gid + 8 * k];
#pragma unroll
        for (int z = 1; z < 4; ++z) {
          const float w = red[(hs + 2 * z) * 16 + gid + 8 * k];
          v = pass == 1 ? fmaxf(v, w) : v + w;
        }
        if (pass == 1) mx[k] = v;
        else sum[k] = v;
      }
      __syncthreads();
    }
    // refill: resident, the V slot just read with V chunk c + 2; streamed,
    // the slot item i - 1 read with item i + NCHUNK - 1
    if (resident) {
      if (isv) {
        __syncthreads();
        if (c + 2 < nc) load(true, c + 2, ring + (nc + (c & 1)) * CHUNK);
        cp_async_commit();
      }
    } else {
      if (i + NCHUNK - 1 < items) stream(i + NCHUNK - 1);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  // the four key slices' outputs of each head, added in slice order
  float* opart = reinterpret_cast<float*>(xreg);
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    float* row0 = opart + (warp * 16 + gid) * OPS + 8 * n + 2 * tq;
    *reinterpret_cast<float2*>(row0) = make_float2(o[n][0], o[n][1]);
    *reinterpret_cast<float2*>(row0 + 8 * OPS) = make_float2(o[n][2], o[n][3]);
  }
  __syncthreads();
  __nv_bfloat16* out = p.attn[CROSS ? 1 : 0];
  const size_t qd = (size_t)p.Hq * D;
  for (int e = tid; e < 2 * 16 * (D / 8); e += THREADS) {   // 8 dims a thread
    const int slot_h = e / (16 * (D / 8)), row = (e / (D / 8)) % 16, d0 = (e % (D / 8)) * 8;
    if (2 * pair + slot_h >= p.G || q0 + row >= p.T) continue;
    float acc8[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc8[k] = opart[(slot_h * 16 + row) * OPS + d0 + k];
#pragma unroll
    for (int z = 1; z < 4; ++z)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc8[k] += opart[((slot_h + 2 * z) * 16 + row) * OPS + d0 + k];
    const int hh = kv * p.G + 2 * pair + slot_h;
    uint4 pk;
    pk.x = pack_bf16(acc8[0], acc8[1]);
    pk.y = pack_bf16(acc8[2], acc8[3]);
    pk.z = pack_bf16(acc8[4], acc8[5]);
    pk.w = pack_bf16(acc8[6], acc8[7]);
    *reinterpret_cast<uint4*>(out + (q0 + row) * qd + hh * D + d0) = pk;
  }
  publish(p.g[CROSS ? C_CROSS : C_SELF] + kv, true);
  __syncthreads();                     // the region is free for the next unit
}

// ---------------------------------------------------------------------------
// waits and the queue
// ---------------------------------------------------------------------------

// Wait until what an accumulation (GEMM stages) or a unit reads is published
// (the kernel's side of ops/cuda/dit_mega.unit_waits): one thread a counter.
__device__ void wait_item(const Params& p, int l, int st, int u, int r) {
  const int tid = threadIdx.x;
  const unsigned per_gemm = (unsigned)(CS * p.passes) * (l + 1);
  switch (st) {
    case NORM_SA:
      if (l > 0 && tid == 0)
        spin_ge(p.g[C_RESID] + 2, (unsigned)(p.units[DN] * CS * p.passes) * l);
      break;
    case NORM_CA:
    case NORM_MLP:
      if (tid == 0)
        spin_ge(p.g[C_RESID] + (st == NORM_CA ? 0 : 1), (unsigned)p.units[st == NORM_CA ? SO : CO] * per_gemm);
      break;
    case QKV:
    case CQ:
    case GU:
      if (tid == 0) spin_ge(p.g[C_NORM] + (st == QKV ? 0 : st == CQ ? 1 : 2), (unsigned)p.n_norm * (l + 1));
      break;
    case SO:
    case CO: {
      const int gi = st == SO ? G_SO : G_CO, sb = p.kbeg[gi][r], se = p.kend[gi][r];
      if (se > sb) {
        const int g0 = sb / p.G, g1 = (se - 1) / p.G;
        if (tid <= g1 - g0)
          spin_ge(p.g[st == SO ? C_SELF : C_CROSS] + g0 + tid, (unsigned)(p.pairs * p.nqb) * (l + 1));
      }
      break;
    }
    case DN:
      if (tid == 0) spin_ge(p.g[C_GU], (unsigned)p.units[GU] * per_gemm);
      break;
    default: {
      const int kv = u / (p.pairs * p.nqb), pair = (u / p.nqb) % p.pairs;
      const int nh = min(2, p.G - 2 * pair);
      if (st == SELF) {
        if (tid < nh) spin_ge(p.g[C_QKV] + kv * p.G + 2 * pair + tid, per_gemm);
        else if (tid == 2) spin_ge(p.g[C_QKV] + p.Hq + kv, per_gemm);
        else if (tid == 3) spin_ge(p.g[C_QKV] + p.Hq + p.Hkv + kv, per_gemm);
      } else if (tid < 2 * nh) {
        spin_ge(p.g[C_CQ] + 2 * (kv * p.G + 2 * pair) + tid, per_gemm);
      }
      break;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 1) dit_mega_kernel(const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ int flag;
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);   // 1024-aligned
  Smem s;
  s.xreg = base;
  s.wring = base + XREG;
  s.wfull = reinterpret_cast<uint64_t*>(base + XREG + WR * W_SLOT);
  s.xfull = s.wfull + WR;
  s.red = reinterpret_cast<float*>(s.xfull + XR);
  s.wuse = s.xuse = s.wfill = s.xfill = 0;
  s.parked = false;
  stamp(p, 0);
  const int c = blockIdx.x / CS, r = blockIdx.x % CS;
  const int pos = r * p.ncl + c;
  WCur w{0, 0, c, 0, 0, true, p.units[GSTAGE[0]], nsup(p, 0, r), p.kbeg[0][r], p.kend[0][r]};
  if (threadIdx.x == 0) {
    for (int i = 0; i < WR; ++i) mbar_init(s.wfull + i, 1);
    for (int i = 0; i < XR; ++i) mbar_init(s.xfull + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int gi = 0; gi < NGEMM; ++gi) {   // the tensor maps into the descriptor cache
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&p.wmap[gi])) : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&p.smap[gi])) : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&p.xmap[gi])) : "memory");
    }
  }
  __syncthreads();
  const int tid = threadIdx.x;
  if (tid == T_WD0 || tid == T_WD1 || tid == T_WS) {
    wseek(p, w, c, r);
    for (int i = 0; i < WR; ++i) issue_w(p, s, w, c, r, tid == T_WD0 ? 0 : tid == T_WD1 ? 1 : 2);
  }
  stamp(p, 1);
  for (int l = 0; l < p.L; ++l) {
    for (int st = 0; st < NSTAGE; ++st) {
      const int gi = st == QKV ? G_QKV : st == SO ? G_SO : st == CQ ? G_CQ : st == CO ? G_CO
                     : st == GU ? G_GU : st == DN ? G_DN : -1;
      if (gi >= 0) {
        for (int j = c; j < p.units[st]; j += p.ncl)
          for (int pass = 0; pass < p.passes; ++pass) {
            wait_item(p, l, st, j, r);
            gemm_pass(p, s, w, l, gi, j, pass, c, r);
          }
      } else {
        for (int u = pos; u < p.units[st]; u += gridDim.x) {
          wait_item(p, l, st, u, r);
          unpark(s);
          if (st == SELF) attn_unit<false>(p, s.xreg, s.red, l, u);
          else if (st == CROSS) attn_unit<true>(p, s.xreg, s.red, l, u);
          else norm_unit(p, s.xreg, st == NORM_SA ? 0 : st == NORM_CA ? 1 : 2, l, u);
        }
      }
      stamp(p, 2 + NSTAGE * l + st);
    }
  }
  unpark(s);                           // no block leaves while its tile is read
  // the last block to leave returns every sync word to 0 for the next launch
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
    flag = atomicAdd(p.g[C_DONE], 1u) == gridDim.x - 1;
    if (flag) asm volatile("fence.acq_rel.gpu;" ::: "memory");
  }
  __syncthreads();
  if (flag) {
    for (int i = threadIdx.x; i < p.sync_words; i += THREADS) __stcg(p.sync + i, 0u);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda at link time)
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }
  return fn;
}

bool encode(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base,
            const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
            CUtensorMapSwizzle swizzle) {
  const PFN_cuTensorMapEncodeTiled_v12000 fn = tensor_map_encoder();
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn != nullptr &&
         fn(map, type, rank, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t prepare() {
  static bool done = false;
  if (!done) {
    const cudaError_t e =
        cudaFuncSetAttribute(dit_mega_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return e;
    done = true;
  }
  return cudaSuccess;
}

cudaLaunchConfig_t launch_config(int grid, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// clusters the card holds at once (<= 0: the query failed)
int max_clusters() {
  if (prepare() != cudaSuccess) return -1;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(CS, nullptr, attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, dit_mega_kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return n;
}

// C slots (ops/cuda/dit_mega.py _SLOTS packs them in this order)
enum Slot {
  S_W = 0, S_S = 6, S_SMALL = 12, S_SMALL_F32 = 19, S_CK, S_CV, S_X0, S_TPROJ, S_COS, S_SIN,
  S_ENCM, S_X, S_SCRATCH, S_SYNC, S_STAMPS, S_L, S_T, S_H, S_HQ, S_HKV, S_I, S_LC, S_WINDOW,
  S_GRID, S_EPS, S_INV_SQRT_D, S_STREAM, S_FLAGS, S_REGION = S_FLAGS + 8,
  S_GROUP = S_REGION + REGIONS + 1, S_COUNT = S_GROUP + GROUPS + 1
};

}  // namespace

// Dynamic shared memory of one block (bytes; ops/cuda/dit_mega.py SMEM).
extern "C" int acestep_dit_mega_smem() { return SMEM; }

// Blocks of the launch: CS x the clusters the card holds at once (< 0: the
// occupancy query failed; 0: not one cluster fits).
extern "C" int acestep_dit_mega_grid() {
  const int n = max_clusters();
  return n < 0 ? -1 : n * CS;
}

// One call: an array of 8-byte slots (enum Slot; ops/cuda/dit_mega.py packs
// them), the plan's region and sync-word offsets among them: they must be
// this source's own (make_plan), or the call is refused before any launch.
// A grid that is not a whole number of clusters, or more clusters than the
// card holds at once, is refused too (every block must be resident).
extern "C" int acestep_dit_mega(const int64_t* slots) {
  const auto ptr = [&](int i) { return reinterpret_cast<void*>(slots[i]); };
  const auto num = [&](int i) { return static_cast<int>(slots[i]); };
  const int L = num(S_L), T = num(S_T), H = num(S_H), Hq = num(S_HQ), Hkv = num(S_HKV);
  const int I = num(S_I), Lc = num(S_LC), grid = num(S_GRID);
  if (L < 1 || L > 512 || T < 8 || T % 8 || H < 128 || H % 128 || Hkv < 1 || Hq % Hkv ||
      I < 64 || I % 64 || Lc < 1)
    return cudaErrorInvalidValue;
  const Plan plan = make_plan(T, H, Hq, Hkv, I);
  for (int r = 0; r <= REGIONS; ++r)
    if (slots[S_REGION + r] != plan.region[r]) return cudaErrorInvalidValue;
  for (int g = 0; g <= GROUPS; ++g)
    if (slots[S_GROUP + g] != plan.group[g]) return cudaErrorInvalidValue;
  cudaError_t e = prepare();
  if (e != cudaSuccess) {
    cudaGetLastError();
    return e;
  }
  if (grid < CS || grid % CS) return cudaErrorInvalidConfiguration;
  const int ncl_max = max_clusters();
  if (ncl_max <= 0) return cudaErrorInvalidConfiguration;
  if (grid / CS > ncl_max) return cudaErrorCooperativeLaunchTooLarge;

  Params p;
  memset(&p, 0, sizeof(p));
  const int qdim = Hq * D;
  const long long Ks[NGEMM] = {H, qdim, H, qdim, H, I};
  const long long Ns[NGEMM] = {qdim + 2 * Hkv * D, H, qdim, H, 2LL * I, H};
  uint8_t* scratch = static_cast<uint8_t*>(ptr(S_SCRATCH));
  __nv_bfloat16* panel[NGEMM] = {
      reinterpret_cast<__nv_bfloat16*>(scratch + plan.region[XA_SA]),
      reinterpret_cast<__nv_bfloat16*>(scratch + plan.region[ATTN_S]),
      reinterpret_cast<__nv_bfloat16*>(scratch + plan.region[XA_CA]),
      reinterpret_cast<__nv_bfloat16*>(scratch + plan.region[ATTN_C]),
      reinterpret_cast<__nv_bfloat16*>(scratch + plan.region[XA_MLP]),
      reinterpret_cast<__nv_bfloat16*>(scratch + plan.region[R_ACT])};
  for (int gi = 0; gi < NGEMM; ++gi) {
    const long long K = Ks[gi], N = Ns[gi];
    const cuuint64_t wd[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)L};
    const cuuint64_t ws[2] = {(cuuint64_t)N, (cuuint64_t)(K * N)};
    const cuuint32_t wb[3] = {64, KSTEP, 1};
    const cuuint64_t sd[3] = {(cuuint64_t)N, (cuuint64_t)(K / QBLK), (cuuint64_t)L};
    const cuuint64_t ss[2] = {(cuuint64_t)(N * 4), (cuuint64_t)(K / QBLK * N * 4)};
    const cuuint32_t sbx[3] = {64, KSTEP / QBLK, 1};
    const cuuint64_t xd[2] = {(cuuint64_t)K, (cuuint64_t)T};
    const cuuint64_t xs[1] = {(cuuint64_t)(K * 2)};
    const cuuint32_t xb[2] = {64, TT};
    if (!encode(&p.wmap[gi], CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, ptr(S_W + gi), wd, ws, wb,
                CU_TENSOR_MAP_SWIZZLE_64B) ||
        !encode(&p.smap[gi], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, ptr(S_S + gi), sd, ss, sbx,
                CU_TENSOR_MAP_SWIZZLE_NONE) ||
        !encode(&p.xmap[gi], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, panel[gi], xd, xs, xb,
                CU_TENSOR_MAP_SWIZZLE_128B))
      return cudaErrorInvalidValue;
    const long long steps = cdiv(K, KSTEP);
    long long per = cdiv(steps, CS);
    if (!(gi == G_QKV || gi == G_GU)) per = cdiv(per, 2) * 2;
    for (int r = 0; r < CS; ++r) {
      p.kbeg[gi][r] = (int)(r * per < steps ? r * per : steps);
      p.kend[gi][r] = (int)((r + 1) * per < steps ? (r + 1) * per : steps);
    }
  }
  for (int i = 0; i < 7; ++i) p.small[i] = ptr(S_SMALL + i);
  p.small_f32 = num(S_SMALL_F32);
  p.ck = static_cast<const __nv_bfloat16*>(ptr(S_CK));
  p.cv = static_cast<const __nv_bfloat16*>(ptr(S_CV));
  p.x0 = static_cast<const float*>(ptr(S_X0));
  p.tproj = static_cast<const float*>(ptr(S_TPROJ));
  p.cos = static_cast<const float*>(ptr(S_COS));
  p.sin = static_cast<const float*>(ptr(S_SIN));
  p.encm = static_cast<const float*>(ptr(S_ENCM));
  p.x = static_cast<float*>(ptr(S_X));
  for (int k = 0; k < 3; ++k) p.xa[k] = panel[2 * k];
  p.qb = reinterpret_cast<__nv_bfloat16*>(scratch + plan.region[R_QB]);
  p.kb = reinterpret_cast<__nv_bfloat16*>(scratch + plan.region[R_KB]);
  p.vb = reinterpret_cast<__nv_bfloat16*>(scratch + plan.region[R_VB]);
  p.attn[0] = panel[G_SO];
  p.attn[1] = panel[G_CO];
  p.qc = reinterpret_cast<float*>(scratch + plan.region[R_QC]);
  p.act = panel[G_DN];
  p.sync = static_cast<unsigned*>(ptr(S_SYNC));
  p.sync_words = static_cast<int>(plan.group[GROUPS]);
  for (int g = 0; g < GROUPS; ++g) p.g[g] = p.sync + plan.group[g];
  p.stamps = static_cast<unsigned long long*>(ptr(S_STAMPS));
  for (int k = 0; k < 8; ++k) p.flags[k] = static_cast<unsigned long long>(slots[S_FLAGS + k]);
  p.L = L; p.T = T; p.H = H; p.Hq = Hq; p.Hkv = Hkv; p.I = I; p.Lc = Lc;
  p.window = num(S_WINDOW);
  p.ncl = grid / CS;
  p.G = Hq / Hkv;
  p.pairs = (p.G + 1) / 2;
  p.nqb = (T + QB - 1) / QB;
  p.n_norm = (T + NT - 1) / NT;
  p.passes = (T + TT - 1) / TT;
  const int attn_units = Hkv * p.pairs * p.nqb;
  const int units[NSTAGE] = {p.n_norm, (int)(Ns[G_QKV] / D), attn_units, (int)cdiv(H, 64),
                             p.n_norm, (int)cdiv(qdim, 64), attn_units, (int)cdiv(H, 64),
                             p.n_norm, (int)cdiv(I, 64), (int)cdiv(H, 64)};
  for (int st = 0; st < NSTAGE; ++st) p.units[st] = units[st];
  const int eps_bits = num(S_EPS), isd_bits = num(S_INV_SQRT_D);
  memcpy(&p.eps, &eps_bits, sizeof(float));
  memcpy(&p.inv_sqrt_d, &isd_bits, sizeof(float));
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(grid, static_cast<cudaStream_t>(ptr(S_STREAM)), attr);
  e = cudaLaunchKernelEx(&cfg, dit_mega_kernel, p);
  if (e != cudaSuccess) {
    cudaGetLastError();            // a refused launch is not sticky: clear it, report it
    return e;
  }
  return cudaGetLastError();
}
