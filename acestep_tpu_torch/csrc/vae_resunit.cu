// Fused Oobleck residual units for Hopper (sm_90a): the convolutions on tensor
// cores in error-compensated TF32 (3xTF32), everything else in f32.
//
//   unit(x) = x + conv1x1(snake2(conv7_dil(snake1(x))))      snake(v) = v + sin(a v)^2 / (b + 1e-9)
//
// acestep_vae_res_unit replaces acestep_tpu/ops/pallas/vae_resunit.py:52 `_kernel`
// (fused_res_unit, the 256-channel decoder block, dilation d = 1, 3, 9);
// acestep_vae_res_trio replaces vae_resunit.py:255 `_trio_kernel` (fused_res_trio,
// the three chained units d = 1, 3, 9 of a 128-channel block).
//
// Layout: activations [N, L, C] channels-last f32.  The weights come prepared
// once per parameter set by the wrapper (ops/cuda/vae_resunit.py stage_images):
// transposed to [Cout, Cin], split, permuted and swizzled into the exact image
// of one shared-memory stage; the per-channel vectors as [6, C] (conv1 bias,
// conv2 bias, snake1 alpha and 1 / (beta + 1e-9), snake2 alpha and 1 / (beta +
// 1e-9), alpha and beta already exponentiated), one set per unit.
//
// Bound on the H100: operations.  A row of a unit costs 2*8*C*C flops (7 taps
// + the 1x1) against 8*C bytes, 256 flops a byte at C = 128.  On CUDA cores
// (67 TFLOP/s f32) that bounds the 60 s trio at 63.7 ms.  Single-pass TF32
// (495 TFLOP/s) keeps 11 significant bits, too few for the 1e-4 bound; three
// TF32 products keep ~22: 165 TFLOP/s of f32-accurate work, a 25.9 ms bound
// for the 60 s trio, still operations-bound (balance 49 flops a byte).
//
// Design.
//  - GEMM view: conv1 out[r, co] = sum_j sum_ci T[r + j*d, ci] W1[j, ci, co],
//    T = snake1(x) with zero rows outside [0, L); conv2 the same with one tap.
//    wgmma.mma_async m64n128k8 tf32: A (64 rows x 8 ci) from registers, B (128
//    couts x 8 ci, K-major) from shared memory under the 128-byte swizzle.
//    Each operand is split v = hi + lo, hi = cvt.rna.tf32(v), lo =
//    cvt.rna.tf32(v - hi), and the f32 accumulators take hi*hi + lo*hi + hi*lo
//    (each product exact in f32).  The activations are split in registers as
//    they are loaded; the weights arrive split.  Within each group of 8 ci the
//    K order is permuted (slot u <-> ci 2u, slot 4 + u <-> ci 2u + 1), so that
//    a thread's two A columns of a k8 step are adjacent floats (one 8-byte
//    load).
//  - A block owns a tile of TM output rows of one window: TM = 128 at C = 128
//    (warpgroup w: rows 64w.., all 128 couts), TM = 64 at C = 256 (warpgroup
//    w: all 64 rows, couts 128w..).  The tile's input rows [t0 - 3d, t0 + TM +
//    3d) are read once (zeros outside [0, L)) and snake1 is applied in shared
//    memory (row stride C + 8 floats: conflict-free 8-byte fragment loads);
//    conv1 runs over 7 taps x C/32 chunks of 32 ci; its outputs (+ bias,
//    snake2) go back to shared memory over T as conv2's A; conv2 runs over
//    C/32 chunks; the residual (+ bias) is added in f32 on the way out.  Snake is one non-inlined function (its ~100 inlined
//    copies crowded the instruction cache) taking 1 / (b + 1e-9) from the
//    wrapper.
//  - Weights stream through a 96 KB ring: one stage is one 32-ci chunk of one
//    part (hi or lo) for all C couts (C x 128 B), one cp.async.bulk each from
//    one thread of a producer warpgroup (which gives its registers to the
//    consumers: setmaxnreg), handed over by mbarriers (full: landed; empty: the 8
//    consumer warps are done with it).  The producer walks the consumers'
//    sequence and runs ahead across tiles and units.
//  - Accuracy on the tensor cores: each wgmma truncates its sum to the
//    accumulator's exponent, which over the conv's 7 * C / 8 k steps of three
//    products cost ~10x f32's error (2.0x the 1e-4 bound after the trio's three
//    units: tools/vae_resunit_errors.py on a one-accumulator build).  So a 32-ci chunk is summed from zero (lo
//    stage: hi*lo, then hi stage: lo*hi, then hi*hi: small terms first) and
//    added to a register total in f32, rounded to nearest.  The next chunk's A
//    values are read from shared memory while a chunk's groups run.
//  - Persistent grid, one block an SM, walking the tiles.  The trio runs its
//    three units as three phases of one cooperative launch separated by a grid
//    barrier (x -> out -> scratch -> out): no halo is recomputed (keeping the
//    chained units on chip would recompute the 39-row reach a side, 1.66x the
//    operations at 64-row tiles), for ~3.3 ms more device-memory bytes at 60 s
//    against ~26 ms of operations.
//  - Numerics: snake with accurate sinf; conv1 bias before snake2, conv2 bias
//    before the residual; fixed summation order and no atomics on data, so a
//    rerun is bit-identical.
// The *_tf32 entry points build the same kernel without the lo products
// (single-pass TF32): a planted fault for the checks and an ablation for
// tools/time_vae_resunit.py, never reached from the model.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CONSUMERS = 256;               // two warpgroups
constexpr int THREADS = CONSUMERS + 128;     // and a producer warpgroup (one thread copies)
// registers a thread: the launch gives 168 to each of the 384 threads; the
// producer warpgroup hands most of its share to the consumers, whose two
// accumulators (a chunk's and the total) and A fragments need ~200
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
// the weight ring (a 128 KB ring at C = 128 measured no faster)
constexpr int RING = 96 * 1024;
constexpr int TRIO_DMAX = 9;

template <int C>
struct Geo {
  static constexpr int TM = 16384 / C;            // output rows of a tile: 128 or 64
  static constexpr int TS = C + 8;                // row stride (floats) of T and Y
  static constexpr int KC = C / 32;               // 32-ci chunks
  static constexpr int STAGE = C * 128;           // bytes: one chunk, one part, all couts
  static constexpr int NS = RING / STAGE;         // 6 or 3 stages
  static constexpr int WG_ROW = C == 128 ? 64 : 0;    // warpgroup w: rows w * WG_ROW ..
  static constexpr int WG_COL = C == 128 ? 0 : 128;   // .. and couts w * WG_COL + [0, 128)
  static constexpr int UNIT_STAGES = 16 * KC;     // 8 taps (conv2 last) x KC chunks x 2 parts
  static_assert(TM == 2 * WG_ROW || WG_ROW == 0, "tile rows");
};

int smem_bytes(int C, int dmax) {
  const int tm = 16384 / C;
  return 1024 + RING + (tm + 6 * dmax) * (C + 8) * 4;
}

struct ResArgs {
  const float* x;
  float* out;
  float* scratch;           // the trio's second intermediate
  unsigned* sync;           // grid barrier: counter, generation (zeroed)
  const uint8_t* stages;    // [phases][UNIT_STAGES][STAGE bytes]
  const float* vec;         // [phases][6][C]
  int N, L, phases;
  int dil[3];
};

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  return now;
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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// `bytes` contiguous bytes global -> shared by the copy engine, counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the consumer warpgroups only (the producer warpgroup never joins)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
}

// Grid-wide barrier of the consumers (on the named barrier): sync[0] counts
// arrivals, sync[1] is the generation word; the last block to arrive resets
// the counter, then bumps the generation.  Every block is resident
// (cooperative launch).  A wait past ~10 s traps.
__device__ __forceinline__ void consumer_grid_barrier(unsigned* sync) {
  consumer_sync();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = sync + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(sync, 1u) == gridDim.x - 1) {
      atomicExch(sync, 0u);
      __threadfence();
      atomicAdd(sync + 1, 1u);
    } else {
      const uint64_t t0 = globaltimer();
      while (*gen == g) {
        __nanosleep(64);
        if (globaltimer() - t0 > 10000000000ull) asm volatile("trap;");
      }
    }
    __threadfence();
  }
  consumer_sync();
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

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// wgmma shared-memory descriptor of a K-major operand under the 128-byte
// swizzle: rows of 128 bytes (32 tf32 of K), 8-row groups 1024 bytes apart
// (stride byte offset), the leading byte offset unused; `addr` is the stage
// row block's 1024-aligned base plus 32 bytes per k8 step.
__device__ __forceinline__ uint64_t kmajor_sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// d (64 x 128 f32) = A (64 x 8 tf32, four registers a thread) * B (by
// descriptor) + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t* a, uint64_t desc,
                                           int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// not inlined: its ~100 inlined copies crowded the instruction cache (one
// copy ran faster)
// (inv_b = 1 / (b + 1e-9), rounded once per channel by the wrapper, as the
// plain version rounds it)
__device__ __noinline__ float snake(float v, float a, float inv_b) {
  const float s = sinf(a * v);
  return v + inv_b * (s * s);
}

// ---------------------------------------------------------------------------
// the tensor-core conv
// ---------------------------------------------------------------------------

// The A values of one 32-ci chunk (four k8 steps) for rows `row` and row + 8
// of `src` (row stride TS floats): element i of step s is v[4s + i], i = 0..3
// at (row, slot t), (row + 8, t), (row, t + 4), (row + 8, t + 4), slots t and
// t + 4 being ci 2t and 2t + 1 of the group of 8.
template <int TS>
__device__ __forceinline__ void fetch_chunk(const float* src, int row, int ci0, int t,
                                            float (&v)[16]) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const float2 v0 = *reinterpret_cast<const float2*>(src + row * TS + ci0 + 8 * s + 2 * t);
    const float2 v1 =
        *reinterpret_cast<const float2*>(src + (row + 8) * TS + ci0 + 8 * s + 2 * t);
    v[4 * s] = v0.x;
    v[4 * s + 1] = v1.x;
    v[4 * s + 2] = v0.y;
    v[4 * s + 3] = v1.y;
  }
}

// ... split into the A fragments hi + lo
template <bool COMP>
__device__ __forceinline__ void split_chunk(const float (&v)[16], uint32_t (&hi)[16],
                                            uint32_t (&lo)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    hi[i] = tf32_rna(v[i]);
    if (COMP) lo[i] = tf32_rna(v[i] - __uint_as_float(hi[i]));
  }
}

// The products of one chunk, in a fresh accumulator, the small ones first (the
// tensor cores truncate each sum to the accumulator's exponent, so a small
// term added to a large sum loses bits): with the lo stage (b_lo) hi*lo, then
// with the hi stage (b_hi) lo*hi, then hi*hi.  Without COMP, hi*hi alone.
__device__ __forceinline__ void mma_lo(float (&acc)[64], const uint32_t (&hi)[16], uint32_t b_lo) {
#pragma unroll
  for (int s = 0; s < 4; ++s) wgmma_tf32(acc, hi + 4 * s, kmajor_sw128_desc(b_lo + 32 * s), s > 0);
}

template <bool COMP>
__device__ __forceinline__ void mma_hi(float (&acc)[64], const uint32_t (&hi)[16],
                                       const uint32_t (&lo)[16], uint32_t b_hi) {
  if (COMP) {
#pragma unroll
    for (int s = 0; s < 4; ++s) wgmma_tf32(acc, lo + 4 * s, kmajor_sw128_desc(b_hi + 32 * s));
  }
#pragma unroll
  for (int s = 0; s < 4; ++s)
    wgmma_tf32(acc, hi + 4 * s, kmajor_sw128_desc(b_hi + 32 * s), COMP || s > 0);
}

// One conv of the tile: tot (this warpgroup's 64 rows x 128 couts, D layout)
// = the sum over `chunks` 32-ci chunks; chunk c reads A rows row + (c / KC) *
// dil of `src`, ci (c % KC) * 32 .., and the ring's next stages (lo then hi
// with COMP, hi alone without).  `it` counts the stages taken from the ring.
// Each chunk is summed on the tensor cores from zero (one or two wgmma
// groups) and then added to tot in f32 on the CUDA cores, rounded to nearest:
// the truncation stays within a chunk's 12 products a k step instead of
// growing over the conv's 7 * C / 8 k steps.  (Two chunks a flush ran barely
// faster and had more error than plain f32: not taken.)
// The next chunk's A values are read from shared memory while the groups run;
// a warpgroup holds at most two stages (the ring has three at C = 256).
template <int C, bool COMP>
__device__ __forceinline__ void conv_tile(const float* src, int row, int dil, int chunks,
                                          const uint8_t* ring, uint64_t* full,
                                          uint64_t* empty, int& it, float (&tot)[64]) {
  using G = Geo<C>;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const uint32_t boff = smem_u32(ring) + (threadIdx.x >> 7) * G::WG_COL * 128;
  float acc[64], v[16];
  uint32_t hi[16], lo[16];
#pragma unroll
  for (int i = 0; i < 64; ++i) tot[i] = acc[i] = 0.f;
  fetch_chunk<G::TS>(src, row, 0, t, v);
  split_chunk<COMP>(v, hi, lo);
  for (int cc = 0; cc < chunks; ++cc) {
    const int first = it;
    if (COMP) {
      mbar_wait(&full[it % G::NS], (it / G::NS) & 1);
      wgmma_fence();
      mma_lo(acc, hi, boff + (it % G::NS) * G::STAGE);
      wgmma_commit();
      ++it;
    }
    mbar_wait(&full[it % G::NS], (it / G::NS) & 1);
    wgmma_fence();
    mma_hi<COMP>(acc, hi, lo, boff + (it % G::NS) * G::STAGE);
    wgmma_commit();
    ++it;
    if (cc + 1 < chunks)
      fetch_chunk<G::TS>(src, row + ((cc + 1) / G::KC) * dil, ((cc + 1) % G::KC) * 32, t, v);
    wgmma_wait<0>();
    reg_fence(acc);
    __syncwarp();
    if (lane == 0) {
      for (int st = first; st < it; ++st) mbar_arrive(&empty[st % G::NS]);
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) tot[i] += acc[i];
    if (cc + 1 < chunks) {
      reg_fence(hi);
      reg_fence(lo);
      split_chunk<COMP>(v, hi, lo);
    }
  }
}

// ---------------------------------------------------------------------------
// the kernel: `phases` units in sequence (1: a unit, 3: the trio)
// ---------------------------------------------------------------------------

template <int C, bool COMP>
__global__ void __launch_bounds__(THREADS, 1) res_kernel(const ResArgs a) {
  using G = Geo<C>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[G::NS], empty[G::NS];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);   // 1024-aligned
  float* T = reinterpret_cast<float*>(ring + RING);   // snake1 rows, then conv2's A
  const int per_window = (a.L + G::TM - 1) / G::TM;
  const int tiles = a.N * per_window;

  if (threadIdx.x == 0) {
    for (int i = 0; i < G::NS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer: the consumers' stage sequence, one bulk copy a stage ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS) {
      int it = 0;
      for (int p = 0; p < a.phases; ++p) {
        const uint8_t* w = a.stages + static_cast<size_t>(p) * G::UNIT_STAGES * G::STAGE;
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
          // chunk c's stages: 2c + 1 (lo) then 2c (hi) with COMP, 2c alone without
          for (int k = COMP ? 0 : 1; k < G::UNIT_STAGES; k += COMP ? 1 : 2, ++it) {
            const int st = k ^ 1;
            const int slot = it % G::NS;
            if (it >= G::NS) mbar_wait(&empty[slot], ((it / G::NS) - 1) & 1);
            mbar_expect_tx(&full[slot], G::STAGE);
            bulk_load(ring + slot * G::STAGE, w + static_cast<size_t>(st) * G::STAGE, G::STAGE,
                      &full[slot]);
          }
        }
      }
    }
    return;
  }

  // ---- consumers ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int wg = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int arow = wg * G::WG_ROW + 16 * w + g;     // the thread's A / D rows: arow, arow + 8
  const int col0 = wg * G::WG_COL + 2 * t;          // its D columns: col0 + 8q + {0, 1}
  int it = 0;
  float acc[64];
  for (int p = 0; p < a.phases; ++p) {
    const float* src = p == 0 ? a.x : p == 1 ? a.out : a.scratch;
    float* dst = p == 1 ? a.scratch : a.out;
    const float* vec = a.vec + p * 6 * C;
    const float *b1 = vec, *b2 = vec + C, *a1 = vec + 2 * C, *ib1 = vec + 3 * C;
    const float *a2 = vec + 4 * C, *ib2 = vec + 5 * C;
    const int d = p == 0 ? a.dil[0] : p == 1 ? a.dil[1] : a.dil[2];   // no local copy
    const int rows = G::TM + 6 * d;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int n = tile / per_window, t0 = (tile % per_window) * G::TM;
      const float* xs = src + static_cast<size_t>(n) * a.L * C;
      float* ys = dst + static_cast<size_t>(n) * a.L * C;
      consumer_sync();                 // the last tile's conv2 is done with Y
      // T = snake1(x rows [t0 - 3d, t0 + TM + 3d)), zero outside [0, L); a
      // thread's 4 channels are the same in every row (256 % (C / 4) == 0);
      // its rows are read 8 at a time, all 8 loads in flight together.
      // (Computing the next 32 channels' snake1 under conv1's wgmma groups
      // instead, conv1 walked channel block major, ran slower: the loads
      // stall the warps that start the groups.)
      {
        constexpr int STEP = CONSUMERS / (C / 4), BATCH = 8;
        const int c4 = threadIdx.x % (C / 4);
        const float4 av = __ldg(reinterpret_cast<const float4*>(a1) + c4);
        const float4 bv = __ldg(reinterpret_cast<const float4*>(ib1) + c4);
        for (int r = threadIdx.x / (C / 4); r < rows; r += BATCH * STEP) {
          float4 v[BATCH];
#pragma unroll
          for (int i = 0; i < BATCH; ++i) {
            const int pos = t0 - 3 * d + r + i * STEP;
            const float4* src4 = reinterpret_cast<const float4*>(xs + static_cast<size_t>(pos) * C);
            v[i] = r + i * STEP < rows && pos >= 0 && pos < a.L ? __ldcg(src4 + c4)
                                                                : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int i = 0; i < BATCH; ++i) {       // snake(0) = 0: the padding stays zero
            if (r + i * STEP < rows)
              *reinterpret_cast<float4*>(T + (r + i * STEP) * G::TS + 4 * c4) =
                  make_float4(snake(v[i].x, av.x, bv.x), snake(v[i].y, av.y, bv.y),
                              snake(v[i].z, av.z, bv.z), snake(v[i].w, av.w, bv.w));
          }
        }
      }
      consumer_sync();
      // conv1 over T, then conv2 over Y: one call site (the conv is large code)
#pragma unroll 1
      for (int k = 0; k < 2; ++k) {
        conv_tile<C, COMP>(T, arow, k ? 0 : d, k ? G::KC : 7 * G::KC, ring, full, empty, it, acc);
        if (k) break;
        consumer_sync();               // every warpgroup is done reading T
        // Y = snake2(conv1 + b1) over T's first TM rows
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const int col = col0 + 8 * q;
          const float2 bb = __ldg(reinterpret_cast<const float2*>(b1 + col));
          const float2 aa = __ldg(reinterpret_cast<const float2*>(a2 + col));
          const float2 ee = __ldg(reinterpret_cast<const float2*>(ib2 + col));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 y = make_float2(snake(acc[4 * q + 2 * h] + bb.x, aa.x, ee.x),
                                         snake(acc[4 * q + 2 * h + 1] + bb.y, aa.y, ee.y));
            *reinterpret_cast<float2*>(T + (arow + 8 * h) * G::TS + col) = y;
          }
        }
        consumer_sync();
      }
      // out = x + (conv2 + b2), rows below L
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pos = t0 + arow + 8 * h;
        if (pos >= a.L) continue;
        const float* xr = xs + static_cast<size_t>(pos) * C;
        float* yr = ys + static_cast<size_t>(pos) * C;
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const int col = col0 + 8 * q;
          const float2 bb = __ldg(reinterpret_cast<const float2*>(b2 + col));
          const float2 xv = __ldcg(reinterpret_cast<const float2*>(xr + col));
          *reinterpret_cast<float2*>(yr + col) =
              make_float2(xv.x + (acc[4 * q + 2 * h] + bb.x),
                          xv.y + (acc[4 * q + 2 * h + 1] + bb.y));
        }
      }
    }
    if (p + 1 < a.phases) consumer_grid_barrier(a.sync);
  }
}

template <int C, bool COMP>
int launch_c(const ResArgs& a, int dmax, cudaStream_t stream) {
  const int smem = smem_bytes(C, dmax);
  const auto kern = res_kernel<C, COMP>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0, sms = 0, dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
  if (err != cudaSuccess) {
    cudaGetLastError();              // a refused launch is not sticky: clear it, report it
    return static_cast<int>(err);
  }
  const long tiles = static_cast<long>(a.N) * ((a.L + Geo<C>::TM - 1) / Geo<C>::TM);
  const int grid = static_cast<int>(tiles < static_cast<long>(per_sm) * sms
                                        ? tiles : static_cast<long>(per_sm) * sms);
  if (a.phases == 1) {
    kern<<<grid, THREADS, smem, stream>>>(a);
  } else {                            // every block resident for the grid barrier
    void* args[] = {const_cast<ResArgs*>(&a)};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern), dim3(grid),
                                      dim3(THREADS), args, smem, stream);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool COMP>
int launch(const void* x, const void* stages, const void* vec, void* out, void* scratch,
           void* sync, int N, int L, int C, int phases, const int* dil, int dmax, void* stream) {
  if (N < 0 || L < 0 || dmax < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 || L == 0) return static_cast<int>(cudaSuccess);
  ResArgs a{static_cast<const float*>(x), static_cast<float*>(out),
            static_cast<float*>(scratch), static_cast<unsigned*>(sync),
            static_cast<const uint8_t*>(stages), static_cast<const float*>(vec),
            N, L, phases, {dil[0], phases > 1 ? dil[1] : 0, phases > 2 ? dil[2] : 0}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 128) return launch_c<128, COMP>(a, dmax, s);
  if (C == 256) return launch_c<256, COMP>(a, dmax, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const int kTrioDil[3] = {1, 3, 9};

}  // namespace

// Shared-memory bytes a launch needs (the wrapper checks them against the card).
extern "C" int acestep_vae_res_unit_smem(int C, int dilation) {
  return smem_bytes(C, dilation);
}

extern "C" int acestep_vae_res_trio_smem(int C) { return smem_bytes(C, TRIO_DMAX); }

// One unit: x [N, L, C] -> out; stages [UNIT_STAGES, C, 32] f32 images, vec [6, C].
extern "C" int acestep_vae_res_unit(const void* x, const void* stages, const void* vec,
                                    void* out, int N, int L, int C, int dilation,
                                    void* stream) {
  return launch<true>(x, stages, vec, out, nullptr, nullptr, N, L, C, 1, &dilation, dilation,
                      stream);
}

// The trio: three units (d = 1, 3, 9) in one cooperative launch; stages and
// vec carry a leading axis of 3; scratch is [N, L, C] f32, sync two zeroed
// 32-bit words.
extern "C" int acestep_vae_res_trio(const void* x, const void* stages, const void* vec,
                                    void* out, void* scratch, void* sync, int N, int L, int C,
                                    void* stream) {
  if (C != 128) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(x, stages, vec, out, scratch, sync, N, L, C, 3, kTrioDil, TRIO_DMAX,
                      stream);
}

// The same kernels without the lo products (single-pass TF32): a planted
// fault for the checks and an ablation for the timing tool.
extern "C" int acestep_vae_res_unit_tf32(const void* x, const void* stages, const void* vec,
                                         void* out, int N, int L, int C, int dilation,
                                         void* stream) {
  return launch<false>(x, stages, vec, out, nullptr, nullptr, N, L, C, 1, &dilation,
                       dilation, stream);
}

extern "C" int acestep_vae_res_trio_tf32(const void* x, const void* stages, const void* vec,
                                         void* out, void* scratch, void* sync, int N, int L,
                                         int C, void* stream) {
  if (C != 128) return static_cast<int>(cudaErrorInvalidValue);
  return launch<false>(x, stages, vec, out, scratch, sync, N, L, C, 3, kTrioDil, TRIO_DMAX,
                       stream);
}
