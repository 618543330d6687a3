// Dequant-matmuls for Hopper (sm_90a), every quant format on one mainloop:
//   out[M, N] = x[M, K] (bf16) @ bf16(dequant(W[K, N])) (+ bias)
// with f32 accumulation; out is bf16 or f32.
//   q8_0: q * d,         q int8,  d = f32 scale[k/32]
//   q4_0: (nib - 8) * d, d = f32 scale[k/32]
//   q4_k: nib * d - m,   d = f32(super[k/256]) * f32(u8 ls[k/32]),
//                        m = f32(super_min[k/256]) * f32(u8 lm[k/32])
//   q6_k: ((lo | hi << 4) - 32) * d,  d = f32(super[k/256]) * f32(i8 ls[k/16])
//
// Replaces the Pallas kernels acestep_tpu/ops/pallas/qmm.py:147 `_q8_kernel`,
// :164 `_q4_0_kernel`, :187 `_q4_k_kernel` and :208 `_q6_k_kernel` (reached
// through qmm_pallas and, for layer-stacked weights, qmm_pallas_stacked: here
// layer `li` is read through its base pointers, with no copy).
//
// Bound on the H100: at the 60 s decoder's M = 768 patch rows the 4-bit
// products are bound by operations (the 2048 x 12288 gate-up product: 38.7
// GFLOP = 39 us at 989 TFLOP/s against 12.6 MB of q4_k weights = 3.8 us at
// 3.35 TB/s); at the 10 s decoder's M = 128 the q8_0 products by bytes (an
// int8 byte feeds 256 flops, under the card's ~295), and at M <= 64 every
// format by bytes.
//
// Design.  The product is computed transposed, out^T = W^T x^T, so that the
// dequantized weight is wgmma's A operand and lives in registers only:
//  - wgmma.mma_async m64nBMk16 (bf16 in, f32 accumulators): A (64 weight
//    columns x 16 K) from registers, B (x^T: BM x rows, K-major) from shared
//    memory under the 128-byte swizzle.  A block owns 128 weight columns and
//    BM = 128 x rows (16 or 64 at small M): two consumer warpgroups, each one
//    m64 tile (64 of the columns) over every K step, so each weight value is
//    dequantized once per 128 x rows.
//  - A ring of 4 shared-memory stages, filled by a producer warpgroup and
//    handed over through mbarriers (full: the copies of a stage landed;
//    empty: both consumer warpgroups are done with it).  The x tile comes by
//    TMA (two cp.async.bulk.tensor copies a stage from one thread, swizzled by
//    the copy engine; the tensor map is encoded on the host per launch), the
//    weight fields by cp.async, 16 bytes a thread.  A stage holds one K step
//    of 128 rows: the x tile and the format's fields for those rows (below).
//  - The dequant runs on the CUDA cores while the tensor cores work: a step's
//    four slice pairs (16 K rows of x atom 0 and 16 of atom 1) go out as two
//    wgmma groups of four wgmmas, and one half of the step is dequantized
//    while the other half's group is in flight (four A register buffers, one
//    per pair; wgmma.wait_group 1).  Each thread owns 2 adjacent weight
//    columns (16 bits of a stage row); the scale factors are read once per
//    32-row block (16 for q6_k) and column; codes become floats exactly
//    through 0x4B000000 | code (2^23 + code), pairs are packed with
//    cvt.rn.bf16x2.f32.
//  - Small M: BM = 16 (M <= 16) or 64 (M <= 64), and a split over K in whole
//    steps when the tiles alone would leave the card half empty.  The splits
//    of one tile are one thread-block cluster along grid z: each block parks
//    its f32 partial tile in its own drained ring, and after a cluster
//    barrier each block adds its share of the tile's valid rows over the
//    cluster's blocks, in split order, through distributed shared memory (no
//    atomics, no scratch in device memory, no second launch: reruns are
//    bit-identical).  A split is at most 8 blocks (the portable cluster), and
//    the card holds fewer clusters than its SMs would suggest (a cluster takes
//    SMs of one GPC: 15 of 8 blocks at one block an SM), so the plan (BM,
//    splits: ops/cuda/qmm.py wgmma_plan, checked here) asks the card how many
//    fit (acestep_qmm_clusters) and keeps a launch within one wave of them.
//    Partials through device memory summed by a second kernel ran 0-3 us
//    faster on the card at some split shapes, but cost a second launch's host
//    time at each (PERF.md).
// Times, rates and what bounds the loop (tools/ablate_qmm_kquant.py builds it
// without the dequant, and without the x copies too): PERF.md.

// K order of a step (128 K rows; x atom a holds 64 of them, slice jj (0..3)
// of an atom is its 32-byte piece jj: 16 K rows).
//  - 4-bit formats: step s (0 or 1) of fold group g takes packed nibble rows
//    g*128 + s*64 + i (i < 64): their low nibbles are K rows g*256 + s*64 + i
//    (x atom 0), their high nibbles K rows g*256 + 128 + s*64 + i (x atom 1),
//    so every packed byte is read once per block and each x atom row is 128
//    contiguous bytes.  q6_k's crumb row g*64 + i holds the two bits of K
//    rows g*256 + {0, 64, 128, 192} + i: both steps of a fold group load its
//    64 crumb rows and use two of the four.  Slice pair jj: packed rows
//    s*64 + 16*jj + [0, 16).
//  - q8_0: step t takes int8 rows 128t + i (i < 128): K rows 128t + [0, 64)
//    are x atom 0 (stage rows 0-63), 128t + [64, 128) atom 1 (stage rows
//    64-127).  Slice pair jj: stage rows 16*jj + [0, 16) and 64 + 16*jj +
//    [0, 16).  K need only be a multiple of 32: the last step may be partial,
//    and its rows past K read as zeros (x by the tensor map's out-of-range
//    fill, the int8 rows and scales by zero-size cp.async copies).
//  - q8_0 / q4_0 block scales: stage row 2a + e is the f32 scale row of the
//    32-row block e of x atom a (slice pair jj uses e = jj / 2), as q4_k's
//    sub-scales and sub-mins.
//
// Numerics (as qmm.py:18-19 and the JAX dequantize): dequant in f32 with each
// multiply and subtract rounded on its own (__fmul_rn / __fsub_rn, so nvcc
// does not contract them into an FMA), one rounding to bf16, f32
// accumulation; the bias is added in f32 before the single output rounding.
// K must be a multiple of 256 (4-bit) or 32 (q8_0); ragged M and N are masked.
// N % 16 == 0 with 16-byte aligned weight fields takes the cp.async path; any
// other N loads the weight fields with plain loads into the same layout.  x
// must be 16-byte aligned (the wrapper guarantees it).

#include <cuda.h>            // CUtensorMap (the driver is reached through the runtime)
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int Q8_0 = 0, Q4_0 = 1, Q4_K = 2, Q6_K = 3;
constexpr int FOLD = 256;
constexpr int STEP = 128;                // K rows per ring stage
constexpr int TN = 128;                  // weight columns per block
constexpr int MAX_SPLITS = 8;            // blocks of a cluster (the portable limit)
constexpr int CONSUMERS = 256;                  // two warpgroups
constexpr int PRODUCERS = 128;                  // and one producer warpgroup
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int PS = TN + 4;               // row stride (floats) of a parked partial tile

struct QArgs {
  const uint8_t* data;          // q8_0: int8 [K, N]; else [K/2, N] fold-256 nibbles
  const uint8_t* data_hi;       // q6_k: [K/4, N] fold-64 crumbs
  const uint8_t* sub_scales;    // q4_k: uint8 [K/32, N]; q6_k: int8 [K/16, N]
  const uint8_t* sub_mins;      // q4_k: uint8 [K/32, N]
  const float* super_scales;    // q4_k / q6_k: [K/256, N]
  const float* super_mins;      // q4_k: [K/256, N]
  const float* scales;          // q8_0 / q4_0: [K/32, N]
};

// shared-memory layout of one ring stage (byte offsets) for blocks of BM x
// rows (the wgmma width)
template <int FMT, int BM>
struct Stage {
  static constexpr bool BLOCK32 = FMT == Q8_0 || FMT == Q4_0;   // one f32 scale per 32 rows
  static constexpr int X = 0;                                  // 2 atoms x BM rows x 128 B
  static constexpr int W = X + 2 * BM * 128;                   // 128 int8 or 64 packed rows x 128 B
  static constexpr int HI = W + (FMT == Q8_0 ? 128 : 64) * TN; // q6_k: 64 crumb rows
  static constexpr int LS = HI + (FMT == Q6_K ? 64 * TN : 0);  // q4_k 4, q6_k 8 rows x 128 B
  static constexpr int LM = LS + (FMT == Q6_K ? 8 : FMT == Q4_K ? 4 : 0) * TN;   // q4_k: 4 rows
  // f32 x 128: the super scales (k-quants), or the step's 4 block-scale rows
  static constexpr int SUP = LM + (FMT == Q4_K ? 4 * TN : 0);
  static constexpr int SMIN = SUP + (BLOCK32 ? 16 : 4) * TN;   // q4_k: f32 x 128
  static constexpr int END = SMIN + (FMT == Q4_K ? 4 * TN : 0);
  static constexpr int BYTES = (END + 1023) / 1024 * 1024;    // atoms stay 1024-aligned
  static constexpr int STAGES = 4;
  static constexpr int SMEM = STAGES * BYTES + 1024;
  static_assert(BM * PS * 4 <= STAGES * BYTES, "a partial tile fits the drained ring");
};

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (tries == 0) t0 = now;
    else if (now - t0 > 10000000000ull) asm volatile("trap;");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// arrives on `bar` once every cp.async this thread issued before has landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// 16 bytes global -> shared; zeros where !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

// one 2-D tile of the tensor map into shared memory, counted on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// every thread of the cluster (that has not exited) arrives, then waits for the
// others; the release / acquire order makes shared-memory stores before it
// visible to the cluster's loads after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
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

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving register reads or writes across a wgmma
// boundary (the registers are read and written asynchronously)
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
// swizzle: rows of 128 bytes (64 bf16 of K), 8-row groups 1024 bytes apart
// (stride byte offset), the leading byte offset unused; `addr` is the atom's
// 1024-aligned base plus 32 bytes per 16-wide K slice.
__device__ __forceinline__ uint64_t kmajor_sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// byte offset of 16-byte chunk `c` of row `row` in a 128-byte-swizzled atom
__device__ __forceinline__ int sw128(int row, int c) {
  return row * 128 + ((c ^ (row & 7)) << 4);
}

// wgmma, A (64 x 16 bf16) from four registers per thread, B by descriptor,
// D (64 x N f32) accumulated in registers: d += A * B
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

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

// byte C (0..3) of `w` as the float 2^23 + byte, exactly; `m` holds 0x4B000000
template <int C>
__device__ __forceinline__ float magic(uint32_t w, uint32_t m) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(w), "r"(m), "n"(0x7540 + C));
  return __int_as_float(static_cast<int>(d));
}

__device__ __forceinline__ uint32_t lds16(const uint8_t* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// swizzle of a weight (packed, int8 or crumb) stage row: the four lanes of a
// quad read rows 2q + {0, 1, 8, 9} of a slice, which this spreads over the banks
__device__ __forceinline__ int wrow(int row, int colb) {
  return row * 128 + ((((colb >> 4) ^ (((row >> 1) & 3) << 1))) << 4) + (colb & 15);
}

// ---------------------------------------------------------------------------
// the plain bf16 wgmma tile: out[64, 128] (f32) = a[64, 64] @ b[128, 64]^T,
// through the same descriptor, swizzle, A fragment and accumulator layouts as
// the dequant-matmuls (checked against torch.matmul on the card)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(128) wgmma_tile_kernel(const __nv_bfloat16* __restrict__ a,
                                                          const __nv_bfloat16* __restrict__ b,
                                                          float* __restrict__ out) {
  __shared__ __align__(1024) uint8_t sb[128 * 128];
  const int t = threadIdx.x, w = t >> 5, lane = t & 31, r = lane >> 2, q = lane & 3;
  for (int e = t; e < 128 * 8; e += 128) {      // row e / 8, chunk e % 8 of b
    const int row = e >> 3, c = e & 7;
    *reinterpret_cast<uint4*>(sb + sw128(row, c)) =
        *reinterpret_cast<const uint4*>(b + row * 64 + c * 8);
  }
  fence_proxy_async();                 // the stores above, visible to wgmma
  __syncthreads();
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const uint32_t* a32 = reinterpret_cast<const uint32_t*>(a);
  reg_fence(acc);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t f[4];
    const int row = 16 * w + r, col = j * 16 + 2 * q;     // (row, col), (row, col + 1)
    f[0] = a32[(row * 64 + col) / 2];
    f[1] = a32[((row + 8) * 64 + col) / 2];
    f[2] = a32[(row * 64 + col + 8) / 2];
    f[3] = a32[((row + 8) * 64 + col + 8) / 2];
    wgmma_fence();
    wgmma_rs(acc, f, kmajor_sw128_desc(smem_u32(sb) + 32 * j));
    wgmma_commit();
    wgmma_wait<0>();
  }
  reg_fence(acc);
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int row = 16 * w + r + 8 * ((i >> 1) & 1), col = (i >> 2) * 8 + 2 * q + (i & 1);
    out[row * 128 + col] = acc[i];
  }
}

// ---------------------------------------------------------------------------
// the dequant-matmul
// ---------------------------------------------------------------------------

// the dequant's per-column factors of the thread's 2 columns, for the low and
// the high halves (x atoms 0 and 1) of one slice pair
struct Scales {
  float d_lo[2], d_hi[2];
  float m_lo[2], m_hi[2];   // q4_k mins
};

// slice pair jj: 32-row blocks (q8_0, q4_0 scales; q4_k sub-scales) change
// every two pairs (stage rows jj/2 and 2 + jj/2), q6_k's 16-row ones every
// pair (stage rows jj and 4 + jj)
template <int FMT, int BM>
__device__ __forceinline__ void load_scales(const uint8_t* sb, int jj, int colb, Scales& s) {
  using L = Stage<FMT, BM>;
  if constexpr (L::BLOCK32) {
    const float2 lo = *reinterpret_cast<const float2*>(sb + L::SUP + 4 * ((jj >> 1) * TN + colb));
    const float2 hi =
        *reinterpret_cast<const float2*>(sb + L::SUP + 4 * ((2 + (jj >> 1)) * TN + colb));
    s.d_lo[0] = lo.x;
    s.d_lo[1] = lo.y;
    s.d_hi[0] = hi.x;
    s.d_hi[1] = hi.y;
    return;
  }
  const float2 su = *reinterpret_cast<const float2*>(sb + L::SUP + 4 * colb);
  const int row = FMT == Q4_K ? (jj >> 1) : jj;
  const uint32_t ls_lo = lds16(sb + L::LS + row * TN + colb);
  const uint32_t ls_hi = lds16(sb + L::LS + (row + (FMT == Q4_K ? 2 : 4)) * TN + colb);
  if (FMT == Q4_K) {
    const float2 sm = *reinterpret_cast<const float2*>(sb + L::SMIN + 4 * colb);
    const uint32_t lm_lo = lds16(sb + L::LM + row * TN + colb);
    const uint32_t lm_hi = lds16(sb + L::LM + (row + 2) * TN + colb);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float sup = c ? su.y : su.x, smin = c ? sm.y : sm.x;
      s.d_lo[c] = __fmul_rn(sup, static_cast<float>((ls_lo >> (8 * c)) & 0xFF));
      s.d_hi[c] = __fmul_rn(sup, static_cast<float>((ls_hi >> (8 * c)) & 0xFF));
      s.m_lo[c] = __fmul_rn(smin, static_cast<float>((lm_lo >> (8 * c)) & 0xFF));
      s.m_hi[c] = __fmul_rn(smin, static_cast<float>((lm_hi >> (8 * c)) & 0xFF));
    }
  } else {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float sup = c ? su.y : su.x;
      s.d_lo[c] = __fmul_rn(sup, static_cast<float>(static_cast<int8_t>(ls_lo >> (8 * c))));
      s.d_hi[c] = __fmul_rn(sup, static_cast<float>(static_cast<int8_t>(ls_hi >> (8 * c))));
    }
  }
}

// the A fragments of slice pair jj: a[0..3] the low slice (x atom 0), a[4..7]
// the high one (atom 1).  Registers 0-3 of a slice hold (column 0, K 2q and
// 2q + 1), (column 1, same), (column 0, K 2q + 8 and 2q + 9), (column 1,
// same) of the thread's 2 columns: stage rows 16jj + 2q + {0, 1} and
// 16jj + 2q + {8, 9} (q8_0's high slice: 64 rows further).  `pair` is the
// step's crumb pair (q6_k: s; the high nibbles take 2 + s).
template <int FMT, int BM>
__device__ __forceinline__ void dequant_pair(const uint8_t* sb, int jj, int q, int colb,
                                             int pair, uint32_t m, const Scales& s,
                                             uint32_t (&a)[8]) {
  using L = Stage<FMT, BM>;
  // 2^23 + code - OFF is the value before its scale, exactly: q8_0's code is
  // the int8 byte + 128 (its sign bit flipped), the 4-bit ones the nibble
  // (q6_k: with its crumb); q4_k subtracts its min after the multiply
  constexpr float OFF = FMT == Q8_0 ? 8388736.f : FMT == Q4_0 ? 8388616.f
                        : FMT == Q6_K ? 8388640.f : 8388608.f;
  const int r0 = 16 * jj + 2 * q;
  uint32_t nl[4], nh[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = r0 + (e & 1) + 8 * (e >> 1);
    const uint32_t w = lds16(sb + L::W + wrow(row, colb));
    if (FMT == Q8_0) {
      nl[e] = w ^ 0x8080u;
      nh[e] = lds16(sb + L::W + wrow(64 + row, colb)) ^ 0x8080u;
    } else {
      nl[e] = w & 0x0F0Fu;
      nh[e] = (w >> 4) & 0x0F0Fu;
    }
    if (FMT == Q6_K) {
      const uint32_t cw = lds16(sb + L::HI + wrow(row, colb));
      nl[e] |= ((cw >> (2 * pair)) & 0x0303u) << 4;
      nh[e] |= ((cw >> (2 * (2 + pair))) & 0x0303u) << 4;
    }
  }
  float lo[4][2], hi[4][2];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float fl[2] = {magic<0>(nl[e], m), magic<1>(nl[e], m)};
    const float fh[2] = {magic<0>(nh[e], m), magic<1>(nh[e], m)};
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      lo[e][c] = __fmul_rn(__fsub_rn(fl[c], OFF), s.d_lo[c]);
      hi[e][c] = __fmul_rn(__fsub_rn(fh[c], OFF), s.d_hi[c]);
      if (FMT == Q4_K) {
        lo[e][c] = __fsub_rn(lo[e][c], s.m_lo[c]);
        hi[e][c] = __fsub_rn(hi[e][c], s.m_hi[c]);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float (&v)[4][2] = h ? hi : lo;
    a[4 * h + 0] = pack_bf16(v[0][0], v[1][0]);
    a[4 * h + 1] = pack_bf16(v[0][1], v[1][1]);
    a[4 * h + 2] = pack_bf16(v[2][0], v[3][0]);
    a[4 * h + 3] = pack_bf16(v[2][1], v[3][1]);
  }
}

// one 16-byte chunk of a field's stage rows: stage row rr from global row
// grow (zeros unless `rok`), chunk c (16 columns) at its swizzled place
// (`swz`: the weight-row swizzle, else none)
template <bool VEC>
__device__ __forceinline__ void load_chunk(uint8_t* dst, const uint8_t* base, int grow, bool rok,
                                           int N, int n0, int rr, int c, bool swz) {
  const int gn = n0 + c * 16;
  uint8_t* d = dst + (swz ? wrow(rr, c * 16) : rr * TN + c * 16);
  const uint8_t* src = base + static_cast<size_t>(grow) * N + gn;
  if (VEC) {
    const bool ok = rok && gn < N;
    cp_async16(d, ok ? src : base, ok);
  } else {
#pragma unroll 4
    for (int b = 0; b < 16; ++b) d[b] = rok && gn + b < N ? src[b] : 0;
  }
}

// chunk c (4 floats) of an f32 row of TN columns (zeros unless `rok`)
template <bool VEC>
__device__ __forceinline__ void load_f32(uint8_t* dst, const float* base, int grow, bool rok,
                                         int N, int n0, int c) {
  const int gn = n0 + c * 4;
  const float* src = base + static_cast<size_t>(grow) * N + gn;
  float* d = reinterpret_cast<float*>(dst) + c * 4;
  if (VEC) {
    const bool ok = rok && gn < N;
    cp_async16(d, ok ? src : base, ok);
  } else {
#pragma unroll
    for (int b = 0; b < 4; ++b) d[b] = rok && gn + b < N ? src[b] : 0.f;
  }
}

// the producer warpgroup: K step ks (4-bit: fold group ks / 2, half ks % 2)
// into stage `sb`; producer thread pt (of 128) takes every 128th 16-byte chunk
// of each field
template <int FMT, int BM, bool VEC>
__device__ __forceinline__ void fill_stage(uint8_t* sb, const QArgs& qa, int N, int K, int n0,
                                           int ks, int pt) {
  using L = Stage<FMT, BM>;
  // (the x tile comes by TMA: see the producer loop)
  const int g = ks >> 1, s = ks & 1, rr = pt >> 3, c = pt & 7;
  if (FMT == Q8_0) {
    // int8 rows: stage row R <- row 128 ks + R; rows past K read as zeros
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int grow = ks * STEP + rr + 16 * i;
      load_chunk<VEC>(sb + L::W, qa.data, grow, grow < K, N, n0, rr + 16 * i, c, true);
    }
  } else {
    // packed nibbles: stage row R <- packed row g*128 + s*64 + R; (q6_k) crumbs:
    // stage row R <- crumb row g*64 + R
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      load_chunk<VEC>(sb + L::W, qa.data, g * 128 + s * 64 + rr + 16 * i, true, N, n0,
                      rr + 16 * i, c, true);
      if (FMT == Q6_K)
        load_chunk<VEC>(sb + L::HI, qa.data_hi, g * 64 + rr + 16 * i, true, N, n0,
                        rr + 16 * i, c, true);
    }
  }
  if (L::BLOCK32) {
    // f32 block scales: stage row j = 2a + e <- the scale row of block e of x
    // atom a (q8_0: block 4 ks + j; q4_0: g*8 + a*4 + s*2 + e)
    const int j = pt >> 5;
    const int brow = FMT == Q8_0 ? ks * 4 + j : g * 8 + (j >> 1) * 4 + s * 2 + (j & 1);
    load_f32<VEC>(sb + L::SUP + j * TN * 4, qa.scales, brow, brow < K / 32, N, n0, pt & 31);
  } else if (FMT == Q6_K) {
    // i8 sub-scales: stage row h*4 + jj <- sub-block g*16 + h*8 + s*4 + jj
    if (pt < 64) load_chunk<VEC>(sb + L::LS, qa.sub_scales,
                                 g * 16 + (rr >> 2) * 8 + s * 4 + (rr & 3), true, N, n0, rr, c,
                                 false);
    else if (pt < 96) load_f32<VEC>(sb + L::SUP, qa.super_scales, g, true, N, n0, pt - 64);
  } else {
    // u8 sub-scales and sub-mins: stage row h*2 + e <- sub-block g*8 + h*4 + s*2 + e
    const int sub = g * 8 + ((rr & 3) >> 1) * 4 + s * 2 + (rr & 1);
    if (pt < 32) load_chunk<VEC>(sb + L::LS, qa.sub_scales, sub, true, N, n0, rr & 3, c, false);
    else if (pt < 64) load_chunk<VEC>(sb + L::LM, qa.sub_mins, sub, true, N, n0, rr & 3, c, false);
    else if (pt < 96) load_f32<VEC>(sb + L::SUP, qa.super_scales, g, true, N, n0, pt - 64);
    else load_f32<VEC>(sb + L::SMIN, qa.super_mins, g, true, N, n0, pt - 96);
  }
}

// one output value pair (columns gn, gn + 1 of row gm) with the bias added
__device__ __forceinline__ void store_pair(void* out, int out_bf16, int gm, int gn, int N,
                                           bool vec2, float v0, float v1) {
  if (out_bf16) {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + static_cast<size_t>(gm) * N + gn;
    if (vec2) {
      *reinterpret_cast<uint32_t*>(o) = pack_bf16(v0, v1);
    } else {
      if (gn < N) o[0] = __float2bfloat16(v0);
      if (gn + 1 < N) o[1] = __float2bfloat16(v1);
    }
  } else {
    float* o = static_cast<float*>(out) + static_cast<size_t>(gm) * N + gn;
    if (vec2) {
      *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
    } else {
      if (gn < N) o[0] = v0;
      if (gn + 1 < N) o[1] = v1;
    }
  }
}

template <int FMT, int BM, bool VEC>
__global__ void __launch_bounds__(THREADS, BM == 16 ? 2 : 1)
qmm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap, const QArgs qa,
                 const float* __restrict__ bias, void* __restrict__ out, int M, int N, int K,
                 int out_bf16, int steps_per_split) {
  using L = Stage<FMT, BM>;
  constexpr int NA = BM / 2;                       // accumulators per thread
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[L::STAGES], empty[L::STAGES];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);   // 1024-aligned

  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * BM;
  const int step0 = blockIdx.z * steps_per_split;
  const int nsteps = min(steps_per_split, (K + STEP - 1) / STEP - step0);
  const bool split = gridDim.z > 1;                // a cluster of the K splits
  if (threadIdx.x == 0) {
    for (int i = 0; i < L::STAGES; ++i) {
      mbar_init(&full[i], PRODUCERS + 1);    // + the x tile's transaction count
      mbar_init(&empty[i], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer ----
    const int pt = threadIdx.x - CONSUMERS;
    for (int it = 0; it < nsteps; ++it) {
      const int st = it % L::STAGES;
      if (it >= L::STAGES) mbar_wait(&empty[st], ((it / L::STAGES) - 1) & 1);
      const int ks = step0 + it;
      uint8_t* sb = smem + st * L::BYTES;
      if (pt == 0) {
        // x: two atoms of BM rows x 64 K columns (the step's K order, above),
        // swizzled by the copy engine; rows past M and columns past K read 0
        mbar_expect_tx(&full[st], 2 * BM * 128);
        const int k0 = FMT == Q8_0 ? ks * STEP : (ks >> 1) * FOLD + (ks & 1) * 64;
        tma_load_2d(sb + L::X, &xmap, k0, m0, &full[st]);
        tma_load_2d(sb + L::X + BM * 128, &xmap, k0 + (FMT == Q8_0 ? 64 : 128), m0, &full[st]);
      }
      fill_stage<FMT, BM, VEC>(sb, qa, N, K, n0, ks, pt);
      if (VEC) {
        cp_async_arrive(&full[st]);
      } else {
        fence_proxy_async();           // plain stores, read by wgmma
        mbar_arrive(&full[st]);
      }
    }
    if (split) {                       // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // ---- consumer warpgroups: warpgroup wg owns columns wg*64 .. wg*64 + 63 ----
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int w = t >> 5, lane = t & 31, r = lane >> 2, q = lane & 3;
  const int colb = wg * 64 + 2 * (8 * w + r);   // tile row 16w + r + 8h: column colb + h
  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
  uint32_t a[4][8];                    // the A fragments of the step's four slice pairs
  Scales sc;
  const uint32_t m = magic_reg();

  // the step's two halves (pairs 0-1, 2-3): one wgmma group each
  auto dequant_half = [&](const uint8_t* b, int h, int pair, uint32_t (&x0)[8],
                          uint32_t (&x1)[8]) {
    load_scales<FMT, BM>(b, 2 * h, colb, sc);
    dequant_pair<FMT, BM>(b, 2 * h, q, colb, pair, m, sc, x0);
    if (FMT == Q6_K) load_scales<FMT, BM>(b, 2 * h + 1, colb, sc);
    dequant_pair<FMT, BM>(b, 2 * h + 1, q, colb, pair, m, sc, x1);
  };
  mbar_wait(&full[0], 0);
  fence_proxy_async();
  dequant_half(smem, 0, step0 & 1, a[0], a[1]);
  reg_fence(acc);
  for (int it = 0; it < nsteps; ++it) {
    const int st = it % L::STAGES;
    const uint8_t* sb = smem + st * L::BYTES;
    const uint32_t xaddr = smem_u32(sb + L::X);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      wgmma_fence();
#pragma unroll
      for (int jj = 2 * h; jj < 2 * h + 2; ++jj) {   // x atom 0: low slices, atom 1: high
        wgmma_rs(acc, a[jj], kmajor_sw128_desc(xaddr + 32 * jj));
        wgmma_rs(acc, a[jj] + 4, kmajor_sw128_desc(xaddr + BM * 128 + 32 * jj));
      }
      wgmma_commit();
      wgmma_wait<1>();                   // the half before this one is done
      if (h == 0 && it > 0) {            // so is the step before: release its stage
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(it - 1) % L::STAGES]);
      }
      if (h == 0) {
        reg_fence(a[2]);
        reg_fence(a[3]);
        dequant_half(sb, 1, (step0 + it) & 1, a[2], a[3]);
      } else if (it + 1 < nsteps) {
        const int sn = (it + 1) % L::STAGES;
        const uint8_t* nb = smem + sn * L::BYTES;
        mbar_wait(&full[sn], ((it + 1) / L::STAGES) & 1);
        fence_proxy_async();
        reg_fence(a[0]);
        reg_fence(a[1]);
        dequant_half(nb, 0, (step0 + it + 1) & 1, a[0], a[1]);
      }
    }
  }
  wgmma_wait<0>();
  reg_fence(acc);

  // thread's outputs: x row (i >> 2)*8 + 2q + (i & 1), columns colb and
  // colb + 1 = (acc[i], acc[i + 2]) for the i with (i >> 1) & 1 == 0
  if (split) {
    // park the partial tile [BM x rows][TN columns] in the drained ring (both
    // warpgroups' wgmmas have read their last x tiles), then add this block's
    // share of the tile's valid rows over the cluster's blocks in split order
    float* part = reinterpret_cast<float*>(smem);
    asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      if ((i >> 1) & 1) continue;
      const int row = (i >> 2) * 8 + 2 * q + (i & 1);
      *reinterpret_cast<float2*>(part + row * PS + colb) = make_float2(acc[i], acc[i + 2]);
    }
    cluster_sync();
    const int splits = gridDim.z, rank = static_cast<int>(cluster_rank());
    const int chunks = min(BM, M - m0) * (TN / 4);   // float4 chunks of the valid rows
    const int per = (chunks + splits - 1) / splits;
    const int end = min(chunks, (rank + 1) * per);
    const bool vec4 = (N & 3) == 0;
    for (int e = rank * per + threadIdx.x; e < end; e += CONSUMERS) {
      const int row = e / (TN / 4), c4 = e % (TN / 4);
      const int gm = m0 + row, gn = n0 + 4 * c4;
      if (gn >= N) continue;
      const uint32_t addr = smem_u32(part + row * PS + 4 * c4);
      float4 p[MAX_SPLITS];
#pragma unroll
      for (int z = 0; z < MAX_SPLITS; ++z)
        if (z < splits) p[z] = ld_cluster(addr, z);
      float4 v = p[0];
#pragma unroll
      for (int z = 1; z < MAX_SPLITS; ++z) {
        if (z < splits) {
          v.x += p[z].x;
          v.y += p[z].y;
          v.z += p[z].z;
          v.w += p[z].w;
        }
      }
      float vals[4] = {v.x, v.y, v.z, v.w};
      if (bias != nullptr) {
#pragma unroll
        for (int c = 0; c < 4; ++c) vals[c] += gn + c < N ? bias[gn + c] : 0.f;
      }
      store_pair(out, out_bf16, gm, gn, N, vec4, vals[0], vals[1]);
      store_pair(out, out_bf16, gm, gn + 2, N, vec4, vals[2], vals[3]);
    }
    cluster_sync();                    // no block leaves while its tile is read
    return;
  }
  const int gn = n0 + colb;
  const bool vec2 = (N & 1) == 0 && gn + 1 < N;
  float b2[2] = {0.f, 0.f};
  if (bias != nullptr) {
#pragma unroll
    for (int c = 0; c < 2; ++c) b2[c] = gn + c < N ? bias[gn + c] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    if ((i >> 1) & 1) continue;
    const int gm = m0 + (i >> 2) * 8 + 2 * q + (i & 1);
    if (gm >= M) continue;
    store_pair(out, out_bf16, gm, gn, N, vec2, acc[i] + b2[0], acc[i + 2] + b2[1]);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda at link time)
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// sets the kernel's shared-memory limit once (per process: the port runs on one card)
template <int FMT, int BM, bool VEC>
cudaError_t prepare() {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        qmm_wgmma_kernel<FMT, BM, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Stage<FMT, BM>::SMEM);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  return cudaSuccess;
}

template <int FMT, int BM, bool VEC>
cudaError_t launch_bm(const __nv_bfloat16* x, const QArgs& qa, const float* bias, void* out,
                      int M, int N, int K, int out_bf16, int splits, int steps_per_split,
                      cudaStream_t stream) {
  using L = Stage<FMT, BM>;
  // x [M, K] as a 2-D tensor map: boxes of 64 K columns (128 bytes) x BM rows,
  // 128-byte swizzle, rows past M and columns past K read as zeros
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap xmap;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t box[2] = {64, BM};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<__nv_bfloat16*>(x), dims,
             strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const cudaError_t err = prepare<FMT, BM, VEC>();
  if (err != cudaSuccess) return err;
  const dim3 grid((N + TN - 1) / TN, (M + BM - 1) / BM, splits);
  if (splits == 1) {
    qmm_wgmma_kernel<FMT, BM, VEC><<<grid, THREADS, L::SMEM, stream>>>(
        xmap, qa, bias, out, M, N, K, out_bf16, steps_per_split);
    return cudaSuccess;
  }
  // the K splits of a tile: one cluster along grid z
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = L::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, qmm_wgmma_kernel<FMT, BM, VEC>, xmap, qa, bias, out, M, N,
                            K, out_bf16, steps_per_split);
}

// clusters of `splits` blocks at BM x rows the card holds at once (<= 0: the
// query failed)
template <int FMT, int BM>
int clusters_bm(int splits) {
  if (prepare<FMT, BM, true>() != cudaSuccess) return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, 1, splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Stage<FMT, BM>::SMEM;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, qmm_wgmma_kernel<FMT, BM, true>, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return n;
}

template <int FMT>
int clusters_fmt(int bm, int splits) {
  if (splits < 1 || splits > MAX_SPLITS) return -1;
  return bm == 16 ? clusters_bm<FMT, 16>(splits)
         : bm == 64 ? clusters_bm<FMT, 64>(splits)
         : bm == 128 ? clusters_bm<FMT, 128>(splits) : -1;
}

template <int FMT, int BM>
cudaError_t launch_vec(bool vec, const __nv_bfloat16* x, const QArgs& qa, const float* bias,
                       void* out, int M, int N, int K, int out_bf16, int splits,
                       int steps_per_split, cudaStream_t stream) {
  return vec ? launch_bm<FMT, BM, true>(x, qa, bias, out, M, N, K, out_bf16, splits,
                                        steps_per_split, stream)
             : launch_bm<FMT, BM, false>(x, qa, bias, out, M, N, K, out_bf16, splits,
                                         steps_per_split, stream);
}

template <int FMT>
int launch(const void* xv, const QArgs& qa, const void* biasv, void* out, int M, int N, int K,
           int out_bf16, int bm, int splits, void* stream) {
  const int align = FMT == Q8_0 ? 32 : FOLD;
  const int steps = (K + STEP - 1) / STEP;
  if (K <= 0 || K % align != 0 || M < 0 || N <= 0 || splits < 1 || splits > steps ||
      splits > MAX_SPLITS || (bm != 16 && bm != 64 && bm != 128) || !aligned16(xv))
    return static_cast<int>(cudaErrorInvalidValue);
  // whole steps per split, every split non-empty
  const int per = (steps + splits - 1) / splits;
  if ((steps + per - 1) / per != splits) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return static_cast<int>(cudaSuccess);
  const auto* x = static_cast<const __nv_bfloat16*>(xv);
  const auto* bias = static_cast<const float*>(biasv);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* ptrs[] = {qa.data, qa.data_hi, qa.sub_scales, qa.sub_mins, qa.super_scales,
                        qa.super_mins, qa.scales};
  bool vec = N % 16 == 0;
  for (const void* p : ptrs) vec = vec && aligned16(p);      // null pointers pass
  const auto run = bm == 16 ? launch_vec<FMT, 16> : bm == 64 ? launch_vec<FMT, 64>
                                                               : launch_vec<FMT, 128>;
  const cudaError_t err = run(vec, x, qa, bias, out, M, N, K, out_bf16, splits, per, s);
  if (err != cudaSuccess) {
    cudaGetLastError();        // a refused launch is not sticky: clear it, report it
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One call: an array of 8-byte slots (one argument, so the host's cost of a
// call stays small): format (0..3: q8_0, q4_0, q4_k, q6_k), x, the format's
// field pointers in the order of ops/cuda/qmm.py's KERNELS (q8_0 / q4_0: data,
// scales; q4_k: data, sub_scales, sub_mins, super_scales, super_mins; q6_k:
// data, data_hi, sub_scales, super_scales), then bias (0: none), out, M, N, K,
// out_bf16, bm, splits, stream.
extern "C" int acestep_qmm(const int64_t* slots) {
  const int fmt = static_cast<int>(slots[0]);
  const auto ptr = [&](int i) { return reinterpret_cast<const void*>(slots[i]); };
  QArgs a{};
  a.data = static_cast<const uint8_t*>(ptr(2));
  int next = 4;                            // the slot after the format's fields
  switch (fmt) {
    case Q8_0:
    case Q4_0:
      a.scales = static_cast<const float*>(ptr(3));
      break;
    case Q4_K:
      a.sub_scales = static_cast<const uint8_t*>(ptr(3));
      a.sub_mins = static_cast<const uint8_t*>(ptr(4));
      a.super_scales = static_cast<const float*>(ptr(5));
      a.super_mins = static_cast<const float*>(ptr(6));
      next = 7;
      break;
    case Q6_K:
      a.data_hi = static_cast<const uint8_t*>(ptr(3));
      a.sub_scales = static_cast<const uint8_t*>(ptr(4));
      a.super_scales = static_cast<const float*>(ptr(5));
      next = 6;
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t* r = slots + next;
  const void* x = ptr(1);
  const void* bias = reinterpret_cast<const void*>(r[0]);
  void* out = reinterpret_cast<void*>(r[1]);
  const int M = static_cast<int>(r[2]), N = static_cast<int>(r[3]), K = static_cast<int>(r[4]);
  const int out_bf16 = static_cast<int>(r[5]), bm = static_cast<int>(r[6]);
  const int splits = static_cast<int>(r[7]);
  void* stream = reinterpret_cast<void*>(r[8]);
  switch (fmt) {
    case Q8_0: return launch<Q8_0>(x, a, bias, out, M, N, K, out_bf16, bm, splits, stream);
    case Q4_0: return launch<Q4_0>(x, a, bias, out, M, N, K, out_bf16, bm, splits, stream);
    case Q4_K: return launch<Q4_K>(x, a, bias, out, M, N, K, out_bf16, bm, splits, stream);
    default: return launch<Q6_K>(x, a, bias, out, M, N, K, out_bf16, bm, splits, stream);
  }
}

// how many clusters of `splits` blocks of the format's kernel at `bm` x rows
// the card holds at once (format 0..3: q8_0, q4_0, q4_k, q6_k; <= 0: the query
// failed): the plan keeps a split launch within one wave of them
extern "C" int acestep_qmm_clusters(int fmt, int bm, int splits) {
  switch (fmt) {
    case Q8_0: return clusters_fmt<Q8_0>(bm, splits);
    case Q4_0: return clusters_fmt<Q4_0>(bm, splits);
    case Q4_K: return clusters_fmt<Q4_K>(bm, splits);
    case Q6_K: return clusters_fmt<Q6_K>(bm, splits);
    default: return -1;
  }
}

// out[64, 128] (f32) = a[64, 64] (bf16) @ b[128, 64]^T (bf16): one warpgroup
extern "C" int acestep_wgmma_tile_check(const void* a, const void* b, void* out, void* stream) {
  wgmma_tile_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
