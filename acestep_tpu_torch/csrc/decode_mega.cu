// One LM decode step through every transformer layer in ONE launch.
//
// Replaces acestep_tpu/ops/pallas/decode_mega.py:131 _mega_kernel (via
// decode_layers_mega, :357): q8_0 serving-fused weights (qkv_proj, o_proj,
// gateup_proj, down_proj, stacked [L, K, N]), hidden 1024, head dim 128,
// B <= 8, an int8 KV cache [L, B, Hkv, T, D] read without the current token.
//
// Bound: bytes.  A step streams the layers' q8_0 weights once (15.7 MB of
// int8 a layer at 0.6B, 4.7 us at the H100 SXM's 3.35 TB/s at 700 W; 0.44 GB
// in all plus scales) and the valid KV; the GEMVs do 2 x B FLOP per weight
// byte.  What costs more is
// latency: a layer is a chain of six dependent stages, each a few microseconds
// of loads, reductions and hand-overs between blocks.
//
// Design: a persistent cooperative kernel (every block resident, grid from
// the occupancy query) whose blocks walk one fixed queue of work units:
//   S1  rms(x) -> bf16, a 128 x 128 tile of the qkv GEMV (split-K partial)
//   S2  per (b, kv head, 128-position chunk of the cache): the heads of the
//       chunk's q (and, in chunk 0, k and v) from the S1 partials summed in
//       K order, q/k RMSNorm and NEOX rope, the new K/V row's int8
//       quantization (chunk 0), the self term (chunk 0), the chunk's scores
//       and their max
//   S3  per (b, kv head, chunk): the softmax against the max over all chunks
//       and the self term, the chunk's share of the denominator and of P.V
//   S4  o_proj tile; its input (one head per 128-row K chunk) is the chunks'
//       shares summed with the self term; the last block to finish a column
//       tile sums its partials in K order and adds the residual
//   S5  post-norm -> bf16, a gate-up tile (split-K partial)
//   S6  SiLU(gate) * up -> bf16 from the S5 partials summed in K order, a
//       down_proj tile, residual as S4
// Block j takes units u = j, j + grid, ... of each stage, layer after layer.
//   * No grid barrier.  A unit waits only for the tiles it reads (wait_unit),
//     on ready counters that the producing units raise after a release fence
//     (S1 / S5 tiles and S2 / S3 chunks count their arrivals, o_proj /
//     down_proj tiles their publications): an S2 unit waits for its heads'
//     qkv tiles, S3 for its (b, kv head)'s chunks, o_proj for its query
//     head's attention, gate-up for the whole residual row (RMSNorm),
//     down_proj for its gate and up tiles, the next layer's qkv for the whole
//     residual row.  Counters grow through the launch (targets are multiples
//     of the layer index + 1), so none is reset in it; the last block to
//     leave zeroes them.  Every unit's dependencies lie in earlier stages and
//     each block walks its queue in stage order, so the co-resident grid
//     cannot deadlock; each scratch region is written by one stage, and a
//     layer's writer of a region waits (transitively) for every reader of
//     the layer before.  ops/cuda/decode_mega.py holds the same plan (queues,
//     waits, regions) and tests/test_torch_decode_mega_plan.py simulates it.
//   * Weights and cache chunks stream ahead of the data.  Which 16 KB tile
//     (a 128 x 128 int8 weight tile and its scales, or a cache chunk's 128
//     K or V rows and their scales) every unit reads is known at launch, so
//     each block keeps the next tiles of its queue in flight in a ring of 3-4
//     shared-memory slots filled by cp.async, across stage and layer
//     boundaries; a unit waits for its activations only.  Warp 0 copies
//     nothing: it makes the block's polls, fences and atomics, and a fence
//     waits for the thread's copies in flight.  A unit publishes its output
//     before it refills its slot.
//   * Instantiated per batch bucket (1, 2, 4, 8 rows): the register arrays
//     and unrolled row loops are no wider than the batch, and at B <= 2 three
//     blocks fit an SM (396: every stage's units at 0.6B in one round).  The
//     kernel's code runs once a layer per block, so its loops over weights,
//     keys and values are rolled (instruction fetches cost as much as work).
//   * GEMV: a 128-row x 128-column tile, each thread 4 adjacent columns of 16
//     rows from the ring, int8 -> f32 exactly through 0x4B000000 | (b ^ 0x80),
//     dequantized in f32 and rounded once to bf16, f32 sums; the 8 warps' row
//     phases summed in shared memory.
// No f32 atomics: partials go to scratch and are summed in a fixed order, so
// reruns, and runs with another grid, are bit-identical.  Everything written
// inside the launch is read back with ld.global.cg (L2), never through the
// non-coherent L1.
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
#include <string.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int D = 128;          // head dim
constexpr int HID = 1024;       // hidden size (the gate's)
constexpr int TILE = 128;       // GEMV tile: 128 rows (K) x 128 columns (N)
constexpr int NK1 = HID / TILE; // K chunks of qkv and gate-up
constexpr int TCH = 128;        // cache positions per attention unit
constexpr int MAXB = 8;
constexpr int MAXG = 4;         // query heads per kv head
constexpr int QBLK = 32;        // q8_0 block rows
constexpr int STAGES = 6;
constexpr int SLOT_DATA = TILE * TILE;           // int8 weight tile or 128 cache rows
constexpr int SLOT_AUX = 4 * TILE * 4;           // 4 rows of f32 scales, or 128 cache scales
constexpr int SLOT = SLOT_DATA + SLOT_AUX;
constexpr float NEG = -1e30f;

// scratch regions (f32) and sync-word groups, in the order of
// ops/cuda/decode_mega.py's REGIONS / GROUPS
enum Region { PART_QKV, VF, SSELF, ESELF, SCORES, CMAX, LPART, APART, PART_O, PART_GU, PART_DN,
              REGIONS };
enum Group { C_QKV, C_S2, C_S3, T_O, R_O, C_GU, T_DN, R_DN, DONE, GROUPS };

struct Plan {
  long long region[REGIONS + 1];   // offsets in floats; [REGIONS]: the total
  long long group[GROUPS + 1];     // offsets in 32-bit words; [GROUPS]: the total
};

Plan make_plan(long long B, long long H, long long Hq, long long Hkv, long long I,
               long long T) {
  const long long nch = T / TCH, nqkv = (Hq + 2 * Hkv) * D, qdim = Hq * D;
  const long long size[REGIONS] = {(H / TILE) * B * nqkv, B * Hkv * D, B * Hq, B * Hq,
                                   B * Hq * T, B * Hq * nch, B * Hq * nch, B * Hq * nch * D,
                                   (qdim / TILE) * B * H, (H / TILE) * B * 2 * I,
                                   (I / TILE) * B * H};
  const long long words[GROUPS] = {nqkv / TILE, B * Hkv, B * Hkv, H / TILE, H / TILE,
                                   2 * I / TILE, H / TILE, H / TILE, 1};
  Plan p{};
  for (int r = 0; r < REGIONS; ++r) p.region[r + 1] = p.region[r] + (size[r] + 3) / 4 * 4;
  for (int g = 0; g < GROUPS; ++g) p.group[g + 1] = p.group[g] + words[g];
  return p;
}

struct Params {
  const int8_t* wd[4];                   // qkv, o, gate-up, down: int8 [L, K, N]
  const void* ws[4];                     // their scales [L, K/32, N]
  int f16;                               // 1: f16 scales, 0: f32
  const float* in_norm;                  // [L, H]
  const float* post_norm;                // [L, H]
  const float* q_norm;                   // [L, D]
  const float* k_norm;                   // [L, D]
  const int8_t* kc; const float* ksc;    // [L, B, Hkv, T, D], [L, B, Hkv, T]
  const int8_t* vc; const float* vsc;
  const int* lengths;                    // [B]
  const void* x0; int x0_bf16;           // [B, H] f32 or bf16
  const float* cos; const float* sin;    // [B, D]
  float* x;                              // [B, H] residual stream and output
  int8_t* k_new; float* ks_new;          // [L, B, Hkv, D], [L, B, Hkv]
  int8_t* v_new; float* vs_new;
  float* r[REGIONS];
  unsigned* g[GROUPS];
  unsigned* sync; int sync_words;
  unsigned long long* stamps;            // optional [2 + STAGES L] %globaltimer ns (block 0)
  int L, B, Hq, Hkv, I, T, NCH, G, nqkv, n_qkv, n_h, n_gu, nk4, nk6;
  int units[STAGES];
  float eps;
};

// ---------------------------------------------------------------------------
// helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// both values rounded to bf16 (one paired conversion)
__device__ __forceinline__ void bf16r2(float& a, float& b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  a = __low2float(h);
  b = __high2float(h);
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

// Block-wide max of each of the G <= MAXG values v[g] in one exchange
// (red: [WARPS][MAXG]); every thread gets the results in v.
__device__ void block_max_g(float (&v)[MAXG], int G, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < MAXG; ++g) v[g] = warp_max(v[g]);
  __syncthreads();
  if (lane < G) red[warp * MAXG + lane] = v[lane];
  __syncthreads();
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    float m = red[g];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) m = fmaxf(m, red[w * MAXG + g]);
    v[g] = g < G ? m : v[g];
  }
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Block 0 records the time at which it finished a stage (for profiling; off
// when stamps is null).
__device__ __forceinline__ void stamp(const Params& p, int i) {
  if (p.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) p.stamps[i] = globaltimer();
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* a) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(a) : "memory");
  return v;
}

__device__ __forceinline__ void fence_acq_rel() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

// Spin until *a >= target, then read it once more with acquire semantics, so
// that the thread's later loads come after it (the caller's __syncthreads
// passes that on to the block).  A wait that does not end within ~10 s is a
// fault of the kernel (a broken plan): trap, so that the launch fails instead
// of hanging the card.
__device__ void spin_ge(const unsigned* a, unsigned target) {
  if (ld_relaxed(a) < target) {
    const unsigned long long t0 = globaltimer();
    for (unsigned tries = 1; ld_relaxed(a) < target; ++tries) {
      __nanosleep(32);
      if (tries % 1024 == 0 && globaltimer() - t0 > 10000000000ull) asm volatile("trap;");
    }
  }
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(a) : "memory");
  (void)v;
}

// The block's writes before it are published on counter c (a release add:
// __syncthreads passes the block's writes on to thread 0).  One release or
// acquire instruction measured faster than a fence beside a relaxed one.
__device__ __forceinline__ void arrive(unsigned* c) {
  __syncthreads();
  if (threadIdx.x == 0) asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(c) : "memory");
}

// After a unit's partials: true in the last block to finish column tile
// `ticket` of a GEMV with `nk` K-chunks (that block then owns the reduction);
// the ticket returns to 0.
__device__ bool last_for_tile(unsigned* ticket, int nk, int* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned prev;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;" : "=r"(prev) : "l"(ticket)
                 : "memory");
    *flag = prev == (unsigned)(nk - 1);
    if (*flag) atomicExch(ticket, 0u);
  }
  __syncthreads();
  return *flag;
}

// The sum of the nk partials part[(kc * B + b) * N + n] over kc, in order,
// with the loads of F chunks in flight at a time.
template <int F>
__device__ __forceinline__ float sum_partials(const float* part, int nk, size_t step,
                                              size_t idx) {
  const float* src = part + idx;
  float v = 0.f;
  for (int j = 0; j < nk; j += F) {
    float t[F];
#pragma unroll
    for (int q = 0; q < F; ++q) t[q] = j + q < nk ? __ldcg(src + (size_t)(j + q) * step) : 0.f;
#pragma unroll
    for (int q = 0; q < F; ++q)
      if (j + q < nk) v += t[q];
  }
  return v;
}

// ---------------------------------------------------------------------------
// the work queue and the ring of tiles
// ---------------------------------------------------------------------------

struct Item {
  int l, s, u;
};

// Attention units past a row's length do nothing (chunk 0 always runs).
__device__ __forceinline__ bool valid_unit(const Params& p, int s, int u) {
  if (s != 1 && s != 2) return true;
  const int c = u % p.NCH, b = u / (p.NCH * p.Hkv);
  return c == 0 || c * TCH < __ldg(p.lengths + b);
}

// Advance `it` to the block's next unit; false past the last layer.
__device__ bool next_item(const Params& p, Item& it) {
  it.u += gridDim.x;
  for (;;) {
    if (it.u < p.units[it.s]) {
      if (valid_unit(p, it.s, it.u)) return true;
      it.u += gridDim.x;
      continue;
    }
    it.u = blockIdx.x;
    if (++it.s == STAGES) {
      it.s = 0;
      if (++it.l == p.L) return false;
    }
  }
}

// weight index, K and N of a GEMV stage (0, 3, 4, 5)
__device__ __forceinline__ void gemv_shape(const Params& p, int s, int* wi, int* K, int* N) {
  switch (s) {
    case 0: *wi = 0; *K = HID; *N = p.nqkv; break;
    case 3: *wi = 1; *K = p.Hq * D; *N = HID; break;
    case 4: *wi = 2; *K = HID; *N = 2 * p.I; break;
    default: *wi = 3; *K = p.I; *N = HID; break;
  }
}

// Issue the cp.async copies of the tile that unit `it` reads into `slot`.
// Warp 0 issues none: it makes the block's polls, fences and atomics, and a
// fence waits for the thread's copies in flight.
__device__ void fill(const Params& p, uint8_t* slot, const Item& it) {
  constexpr int COPIERS = THREADS - 32;
  const int tid = threadIdx.x - 32;
  if (tid < 0) return;
  if (it.s == 1 || it.s == 2) {
    const int c = it.u % p.NCH, h = (it.u / p.NCH) % p.Hkv, b = it.u / (p.NCH * p.Hkv);
    const size_t row0 = (((size_t)it.l * p.B + b) * p.Hkv + h) * (size_t)p.T + (size_t)c * TCH;
    const int n = min(TCH, __ldg(p.lengths + b) - c * TCH);   // valid rows (may be <= 0)
    const int8_t* src = (it.s == 1 ? p.kc : p.vc) + row0 * D;
    // K piece-major ([16-byte piece][position]: a warp reads one piece of 32
    // positions), V row-major ([position][D])
    for (int i = tid; i < n * (D / 16); i += COPIERS)
      cp_async16(slot + (it.s == 1 ? ((i & 7) * TCH + (i >> 3)) : i) * 16, src + i * 16);
    const float* sc = (it.s == 1 ? p.ksc : p.vsc) + row0;
    if (tid < TCH / 4) cp_async16(slot + SLOT_DATA + tid * 16, sc + tid * 4);
    return;
  }
  int wi, K, N;
  gemv_shape(p, it.s, &wi, &K, &N);
  const int nct = N / TILE, ct = it.u % nct, kc = it.u / nct;
  const int8_t* W = p.wd[wi] + (size_t)it.l * K * N + (size_t)kc * TILE * N + ct * TILE;
  for (int i = tid; i < TILE * 8; i += COPIERS) {
    const int r = i >> 3, q = i & 7;
    cp_async16(slot + r * TILE + q * 16, W + (size_t)r * N + q * 16);
  }
  const int esz = p.f16 ? 2 : 4, cpr = TILE * esz / 16;
  const char* S = static_cast<const char*>(p.ws[wi]) +
                  ((size_t)it.l * (K / QBLK) * N + (size_t)kc * (TILE / QBLK) * N + ct * TILE) *
                      esz;
  for (int i = tid; i < (TILE / QBLK) * cpr; i += COPIERS) {
    const int r = i / cpr, q = i % cpr;
    cp_async16(slot + SLOT_DATA + r * TILE * esz + q * 16, S + (size_t)r * N * esz + q * 16);
  }
}

// The block's ring of R slots: unit number `used` of its queue reads slot
// used % R; the copies of units used .. used + R - 1 are in flight (one
// cp.async group a unit, an empty group past the end of the queue).
template <int R>
struct Ring {
  uint8_t* base;
  int used, filled;
  Item fetch;
  bool more;

  __device__ void fill_next(const Params& p) {
    if (more) {
      fill(p, base + (filled % R) * SLOT, fetch);
      more = next_item(p, fetch);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    ++filled;
  }

  // The current unit's tile, landed and visible to the block.
  __device__ __forceinline__ const uint8_t* take() {
    asm volatile("cp.async.wait_group %0;" ::"n"(R - 1) : "memory");
    __syncthreads();
    return base + (used % R) * SLOT;
  }

  // The current unit is done with its tile (and has published its output):
  // refill the slot R units ahead.
  __device__ __forceinline__ void release(const Params& p) {
    __syncthreads();
    ++used;
    fill_next(p);
  }
};

// ---------------------------------------------------------------------------
// the units
// ---------------------------------------------------------------------------

// the residual entering the layer (x0 before layer 0)
__device__ __forceinline__ float xin(const Params& p, bool first, size_t i) {
  if (!first) return __ldcg(p.x + i);
  return p.x0_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.x0)[i])
                   : static_cast<const float*>(p.x0)[i];
}

// rinv[b] = 1 / rms(x[b]) for the B <= BB rows, each thread 4 columns of
// each row with all their loads in flight, summed in a fixed order; the rows
// are kept in xrow [B][HID] for load_normed.  `red` holds [WARPS][MAXB].
template <int BB>
__device__ void rms_rows(const Params& p, bool first, float* rinv, float* red, float* xrow) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float v[BB][HID / THREADS];
#pragma unroll
  for (int b = 0; b < BB; ++b)
    if (b < p.B)
#pragma unroll
      for (int j = 0; j < HID / THREADS; ++j)
        v[b][j] = xin(p, first, (size_t)b * HID + tid + j * THREADS);
#pragma unroll
  for (int b = 0; b < BB; ++b)
    if (b < p.B) {
      float ss = 0.f;
#pragma unroll
      for (int j = 0; j < HID / THREADS; ++j) {
        ss = fmaf(v[b][j], v[b][j], ss);
        xrow[b * HID + tid + j * THREADS] = v[b][j];
      }
      ss = warp_sum(ss);
      if (lane == 0) red[warp * MAXB + b] = ss;
    }
  __syncthreads();
  if (tid < p.B) {
    float ss = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) ss += red[w * MAXB + tid];
    rinv[tid] = 1.f / sqrtf(ss / (float)HID + p.eps);
  }
  __syncthreads();
}

// xs[b][r] = bf16(x[b][k] * rinv[b] * w[k]) for the 128 rows k of K chunk kc;
// x from xrow (shared memory) when rms_rows just filled it, else from device
// memory.
__device__ void load_normed(const Params& p, bool first, const float* w, int kc, float* xs,
                            const float* rinv, const float* xrow) {
  for (int i = threadIdx.x; i < p.B * TILE; i += THREADS) {
    const int b = i / TILE, k = kc * TILE + i % TILE;
    const size_t idx = (size_t)b * HID + k;
    const float xv = xrow != nullptr ? xrow[idx] : xin(p, first, idx);
    xs[i] = bf16r(__fmul_rn(__fmul_rn(xv, rinv[b]), w[k]));
  }
  __syncthreads();
}

__device__ __forceinline__ float4 slot_scales(const Params& p, const uint8_t* slot, int j,
                                              int cg) {
  const uint8_t* aux = slot + SLOT_DATA;
  if (p.f16) {
    const uint2 raw = *reinterpret_cast<const uint2*>(aux + (j * TILE + 4 * cg) * 2);
    const __half2 a = *reinterpret_cast<const __half2*>(&raw.x);
    const __half2 b = *reinterpret_cast<const __half2*>(&raw.y);
    return make_float4(__low2float(a), __high2float(a), __low2float(b), __high2float(b));
  }
  return *reinterpret_cast<const float4*>(aux + (j * TILE + 4 * cg) * 4);
}

// byte c of u (an int8 value stored as b ^ 0x80) as an exact f32
__device__ __forceinline__ float i8f(uint32_t u, int c) {
  return __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | c)) - 8388736.f;
}

// dst[b * ld + c] = sum over the tile's 128 rows r of xs[b][r] * bf16(W[r][c]
// * s[r / 32][c]), for the 128 columns c of the tile in `slot`.
template <int BB>
__device__ void gemv(const Params& p, const uint8_t* slot, const float* xs, float* gred,
                     float* dst, size_t ld) {
  const int tid = threadIdx.x, cg = tid & 31, rp = tid >> 5;
  float acc[BB][4];
#pragma unroll
  for (int b = 0; b < BB; ++b)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[b][c] = 0.f;
  // rows rp, rp + 8, ...: unrolled by 4 only (the kernel runs each unit's
  // code once a layer, so its size costs instruction fetches)
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    const int r = rp + 8 * i;
    const uint32_t w = *reinterpret_cast<const uint32_t*>(slot + r * TILE + 4 * cg) ^ 0x80808080u;
    const float4 sj = slot_scales(p, slot, i / 4, cg);
    float w0 = __fmul_rn(i8f(w, 0), sj.x), w1 = __fmul_rn(i8f(w, 1), sj.y);
    float w2 = __fmul_rn(i8f(w, 2), sj.z), w3 = __fmul_rn(i8f(w, 3), sj.w);
    bf16r2(w0, w1);
    bf16r2(w2, w3);
#pragma unroll
    for (int b = 0; b < BB; ++b)
      if (b < p.B) {
        const float xv = xs[b * TILE + r];
        acc[b][0] = fmaf(xv, w0, acc[b][0]);
        acc[b][1] = fmaf(xv, w1, acc[b][1]);
        acc[b][2] = fmaf(xv, w2, acc[b][2]);
        acc[b][3] = fmaf(xv, w3, acc[b][3]);
      }
  }
#pragma unroll
  for (int b = 0; b < BB; ++b)
    if (b < p.B)
      *reinterpret_cast<float4*>(gred + (rp * p.B + b) * TILE + 4 * cg) =
          make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
  __syncthreads();
  for (int i = tid; i < p.B * TILE; i += THREADS) {
    const int b = i / TILE, c = i % TILE;
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < WARPS; ++r) v += gred[(r * p.B + b) * TILE + c];
    __stcg(dst + (size_t)b * ld + c, v);
  }
}

// Shared-memory floats after the ring: xs [MAXB][TILE], rinv [MAXB], red
// [WARPS][MAXB], then the GEMV's warp partials [WARPS][B][TILE] (also
// rms_rows' rows [B][HID]); the attention units use the same space from its
// start.
constexpr int RINV_AT = MAXB * TILE;
constexpr int RED_AT = RINV_AT + MAXB;
constexpr int GRED_AT = RED_AT + WARPS * MAXB;
constexpr int SCORES_FLOATS = 2 * MAXG * D + D + WARPS * MAXG + MAXG * TCH;
constexpr int PV_FLOATS = MAXG * TCH + MAXG + WARPS + WARPS * MAXG * D;

__host__ __device__ constexpr int floats_for(int B) {
  const int g = GRED_AT + WARPS * B * TILE;
  const int a = SCORES_FLOATS > PV_FLOATS ? SCORES_FLOATS : PV_FLOATS;
  return g > a ? g : a;
}

// `rms_at` (l * STAGES + s) names the stage whose rinv the block holds: a
// block's second unit of a stage reuses it.
template <int BB, int R>
__device__ void unit_qkv(const Params& p, Ring<R>& rg, float* sm, int& rms_at, int l, int u) {
  const int ct = u % p.n_qkv, kc = u / p.n_qkv;
  float* gred = sm + GRED_AT;
  const float* xrow = nullptr;
  if (rms_at != l * STAGES) {
    rms_rows<BB>(p, l == 0, sm + RINV_AT, sm + RED_AT, gred);
    rms_at = l * STAGES;
    xrow = gred;
  }
  load_normed(p, l == 0, p.in_norm + (size_t)l * HID, kc, sm, sm + RINV_AT, xrow);
  const uint8_t* slot = rg.take();
  gemv<BB>(p, slot, sm, gred, p.r[PART_QKV] + (size_t)kc * p.B * p.nqkv + ct * TILE, p.nqkv);
  arrive(p.g[C_QKV] + ct);
  rg.release(p);
}

// Column tile ct of row b's qkv, summed over the K chunks in order: lane l
// holds dims 4l..4l+3.
__device__ __forceinline__ void head_sum(const Params& p, int b, int ct, float v[4]) {
  const int lane = threadIdx.x & 31;
  const float* src = p.r[PART_QKV] + (size_t)b * p.nqkv + ct * TILE + 4 * lane;
  float4 t[NK1];
#pragma unroll
  for (int kc = 0; kc < NK1; ++kc)
    t[kc] = __ldcg(reinterpret_cast<const float4*>(src + (size_t)kc * p.B * p.nqkv));
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = 0.f;
#pragma unroll
  for (int kc = 0; kc < NK1; ++kc) {
    v[0] += t[kc].x;
    v[1] += t[kc].y;
    v[2] += t[kc].z;
    v[3] += t[kc].w;
  }
}

// q/k RMSNorm (weight w, [D]) and NEOX rope of row b, in place; the rope
// partner of dim d is d +- 64, held by lane l ^ 16.
__device__ __forceinline__ void norm_rope(const Params& p, const float* w, int b, float v[4]) {
  const int lane = threadIdx.x & 31;
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) ss = fmaf(v[j], v[j], ss);
  const float r = 1.f / sqrtf(warp_sum(ss) / (float)D + p.eps);
  float y[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) y[j] = __fmul_rn(__fmul_rn(v[j], r), w[4 * lane + j]);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float other = __shfl_xor_sync(0xffffffffu, y[j], 16);
    const float rot = lane < 16 ? -other : other;
    const int d = 4 * lane + j;
    v[j] = __fadd_rn(__fmul_rn(y[j], p.cos[(size_t)b * D + d]),
                     __fmul_rn(rot, p.sin[(size_t)b * D + d]));
  }
}

// kv_cache.quantize_kv of one head row (lane l holds dims 4l..4l+3) into the
// new-token outputs of layer l, row b, kv head h.
__device__ __forceinline__ void quantize_row(const Params& p, const float v[4], int l, int b,
                                             int h, bool is_k) {
  const int lane = threadIdx.x & 31;
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

// S2 for (b, kv head h, chunk c): the heads, then the chunk's scores -> scores,
// their max -> cmax; chunk 0 also the new K/V rows, v -> vf and the self
// term (f32 q . k / sqrt(D)) -> sself.
template <int R>
__device__ void unit_scores(const Params& p, Ring<R>& rg, float* sm, int l, int u) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = u % p.NCH, h = (u / p.NCH) % p.Hkv, b = u / (p.NCH * p.Hkv);
  const int G = p.G, hq0 = h * G, length = __ldg(p.lengths + b);
  const float sm_scale = 1.f / sqrtf((float)D);
  float* qf = sm;                       // [MAXG][D] normed, roped q
  float* kf = qf + MAXG * D;            // [D] normed, roped k
  float* qb = kf + D;                   // [MAXG][D] bf16-valued q
  float* red = qb + MAXG * D;           // [WARPS][MAXG]
  float* hx = red + WARPS * MAXG;       // [MAXG][TCH] the second half's dots
  if (warp < G) {
    float v[4];
    head_sum(p, b, hq0 + warp, v);
    norm_rope(p, p.q_norm + (size_t)l * D, b, v);
    *reinterpret_cast<float4*>(qf + warp * D + 4 * lane) = make_float4(v[0], v[1], v[2], v[3]);
  } else if (c == 0 && warp == G) {
    float v[4];
    head_sum(p, b, p.Hq + h, v);
    norm_rope(p, p.k_norm + (size_t)l * D, b, v);
    *reinterpret_cast<float4*>(kf + 4 * lane) = make_float4(v[0], v[1], v[2], v[3]);
    quantize_row(p, v, l, b, h, true);
  } else if (c == 0 && warp == G + 1) {
    float v[4];
    head_sum(p, b, p.Hq + p.Hkv + h, v);
    __stcg(reinterpret_cast<float4*>(p.r[VF] + ((size_t)b * p.Hkv + h) * D + 4 * lane),
           make_float4(v[0], v[1], v[2], v[3]));
    quantize_row(p, v, l, b, h, false);
  }
  __syncthreads();
  if (c == 0 && warp < G) {
    float v = 0.f;
    for (int d = lane; d < D; d += 32) v = fmaf(qf[warp * D + d], kf[d], v);
    v = warp_sum(v);
    if (lane == 0) __stcg(p.r[SSELF] + (size_t)b * p.Hq + hq0 + warp, v * sm_scale);
  }
  for (int i = tid; i < G * D; i += THREADS) qb[i] = bf16r(qf[i]);
  const uint8_t* slot = rg.take();
  // two threads per position, 64 dims each: thread t takes position t % 128
  // and half t / 128, so a warp's lanes read one K piece of 32 positions and
  // the same q values (a broadcast)
  const int i = tid % TCH, half = tid / TCH;
  const int t = c * TCH + i;
  const bool valid = t < length;
  float dot[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) dot[g] = 0.f;
  if (valid) {
#pragma unroll 2
    for (int q = 0; q < 4; ++q) {
      const int j = half * 4 + q;
      const uint4 kv = *reinterpret_cast<const uint4*>(slot + (j * TCH + i) * 16);
      const uint32_t kw[4] = {kv.x ^ 0x80808080u, kv.y ^ 0x80808080u, kv.z ^ 0x80808080u,
                              kv.w ^ 0x80808080u};
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        const float k0 = i8f(kw[e4], 0), k1 = i8f(kw[e4], 1);
        const float k2 = i8f(kw[e4], 2), k3 = i8f(kw[e4], 3);
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
          if (g < G) {
            const float4 qv = *reinterpret_cast<const float4*>(qb + g * D + j * 16 + 4 * e4);
            dot[g] = fmaf(qv.w, k3, fmaf(qv.z, k2, fmaf(qv.y, k1, fmaf(qv.x, k0, dot[g]))));
          }
      }
    }
  }
  // half 1 hands its dots to half 0 of the same position
  if (half == 1)
#pragma unroll
    for (int g = 0; g < MAXG; ++g) hx[g * TCH + i] = dot[g];
  __syncthreads();
  float sv[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) sv[g] = NEG;
  if (valid && half == 0) {
    const float ks = reinterpret_cast<const float*>(slot + SLOT_DATA)[i];
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < G) {
        sv[g] = ((dot[g] + hx[g * TCH + i]) * sm_scale) * ks;
        __stcg(p.r[SCORES] + ((size_t)b * p.Hq + hq0 + g) * p.T + t, sv[g]);
      }
  }
  block_max_g(sv, G, red);
  if (tid < G) __stcg(p.r[CMAX] + ((size_t)b * p.Hq + hq0 + tid) * p.NCH + c, sv[tid]);
  arrive(p.g[C_S2] + b * p.Hkv + h);
  rg.release(p);
}

// valid chunks of row b (at least one: chunk 0 holds the self term)
__device__ __forceinline__ int chunks(const Params& p, int b) {
  return max(1, (__ldg(p.lengths + b) + TCH - 1) / TCH);
}

// S3 for (b, kv head h, chunk c): m = max(self, every chunk max); e = exp(s -
// m) over the chunk -> lpart (sum of e), apart (sum of bf16(e * v_scale) * v);
// chunk 0 also exp(self - m) -> eself.
template <int R>
__device__ void unit_pv(const Params& p, Ring<R>& rg, float* sm, int l, int u) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = u % p.NCH, h = (u / p.NCH) % p.Hkv, b = u / (p.NCH * p.Hkv);
  const int G = p.G, hq0 = h * G, length = __ldg(p.lengths + b);
  const int nch = chunks(p, b);
  float* e = sm;                        // [G][TCH]
  float* mrow = e + MAXG * TCH;         // [G]
  float* red = mrow + MAXG;             // [WARPS]
  float* wred = red + WARPS;            // [WARPS][G][D]
  const int n = min(TCH, length - c * TCH);         // valid positions of the chunk (may be <= 0)
  // the chunk's scores, loaded beside the maxima (one round trip)
  constexpr int PER = MAXG * TCH / THREADS;
  float sc[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = tid + j * THREADS, g = i / TCH, k = i % TCH;
    sc[j] = g < G && k < n
                ? __ldcg(p.r[SCORES] + ((size_t)b * p.Hq + hq0 + g) * p.T + c * TCH + k)
                : 0.f;
  }
  if (warp < G) {
    const size_t bh = (size_t)b * p.Hq + hq0 + warp;
    float m = NEG;
    for (int j = lane; j < nch; j += 32) m = fmaxf(m, __ldcg(p.r[CMAX] + bh * p.NCH + j));
    const float ss = __ldcg(p.r[SSELF] + bh);
    m = fmaxf(warp_max(m), ss);
    if (lane == 0) {
      mrow[warp] = m;
      if (c == 0) __stcg(p.r[ESELF] + bh, expf(ss - m));
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = tid + j * THREADS, g = i / TCH, k = i % TCH;
    if (g < G) e[i] = k < n ? expf(sc[j] - mrow[g]) : 0.f;
  }
  __syncthreads();
  {
    // each warp sums its 32 positions of every g; warp partials in fixed order
    float part[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) part[g] = warp_sum(tid < TCH && g < G ? e[g * TCH + tid] : 0.f);
    if (lane == 0)
#pragma unroll
      for (int g = 0; g < MAXG; ++g) wred[warp * MAXG + g] = part[g];
    __syncthreads();
    if (tid < G) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) sum += wred[w * MAXG + tid];
      __stcg(p.r[LPART] + ((size_t)b * p.Hq + hq0 + tid) * p.NCH + c, sum);
    }
  }
  const uint8_t* slot = rg.take();
  // P.V: warp w takes positions w, w + 8, ...; lane l the dims 4l..4l+3
  float acc[MAXG][4];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[g][j] = 0.f;
  const float* vscale = reinterpret_cast<const float*>(slot + SLOT_DATA);
  constexpr int PER_WARP = TCH / WARPS;
#pragma unroll 4
  for (int r = 0; r < PER_WARP; ++r) {
    const int k = warp + WARPS * r;
    if (k < n) {
      const uint32_t v4 = reinterpret_cast<const uint32_t*>(slot + k * D)[lane] ^ 0x80808080u;
      const float vs = vscale[k];
      const float vv[4] = {i8f(v4, 0), i8f(v4, 1), i8f(v4, 2), i8f(v4, 3)};
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) {
          const float pv = bf16r(e[g * TCH + k] * vs);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[g][j] = fmaf(pv, vv[j], acc[g][j]);
        }
    }
  }
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
    if (g < G)
      *reinterpret_cast<float4*>(wred + (warp * G + g) * D + 4 * lane) =
          make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  __syncthreads();
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) o += wred[w * G * D + i];
    __stcg(p.r[APART] + (((size_t)b * p.Hq + hq0 + g) * p.NCH + c) * D + d, o);
  }
  arrive(p.g[C_S3] + b * p.Hkv + h);
  rg.release(p);
}

// The attention output of query head hq, row b, dim d: the chunks' P.V and
// denominators summed in chunk order, plus the self term.
__device__ __forceinline__ float attn_out(const Params& p, int b, int hq, int d) {
  const int nch = chunks(p, b);
  const size_t bh = (size_t)b * p.Hq + hq;
  float acc = 0.f, den = 0.f;
  int c = 0;
  for (; c + 8 <= nch; c += 8) {          // 8 chunks' loads in flight, summed in order
    float a[8], l4[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      a[q] = __ldcg(p.r[APART] + (bh * p.NCH + c + q) * D + d);
      l4[q] = __ldcg(p.r[LPART] + bh * p.NCH + c + q);
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      acc += a[q];
      den += l4[q];
    }
  }
  for (; c < nch; ++c) {
    acc += __ldcg(p.r[APART] + (bh * p.NCH + c) * D + d);
    den += __ldcg(p.r[LPART] + bh * p.NCH + c);
  }
  const float es = __ldcg(p.r[ESELF] + bh);
  const float v = __ldcg(p.r[VF] + ((size_t)b * p.Hkv + hq / p.G) * D + d);
  return (acc + es * v) / (den + es);
}

// The last block of an o_proj / down_proj column tile: x += the partials
// summed in K order, rounded to bf16; then the tile is published.
__device__ void residual_tile(const Params& p, const float* part, int nk, int ct, bool first,
                              unsigned* ready) {
  for (int i = threadIdx.x; i < p.B * TILE; i += THREADS) {
    const int b = i / TILE, n = ct * TILE + i % TILE;
    const size_t idx = (size_t)b * HID + n;
    const float xv = xin(p, first, idx);
    const float y = sum_partials<32>(part, nk, (size_t)p.B * HID, idx);
    __stcg(p.x + idx, bf16r(xv + y));
  }
  arrive(ready);
}

// S4: one o_proj tile (K chunk kc = query head kc).
template <int BB, int R>
__device__ void unit_o(const Params& p, Ring<R>& rg, float* sm, int* flag, int l, int u) {
  const int ct = u % p.n_h, kc = u / p.n_h;
  for (int i = threadIdx.x; i < p.B * TILE; i += THREADS)
    sm[i] = bf16r(attn_out(p, i / TILE, kc, i % TILE));
  __syncthreads();
  const uint8_t* slot = rg.take();
  float* part = p.r[PART_O];
  gemv<BB>(p, slot, sm, sm + GRED_AT, part + (size_t)kc * p.B * HID + ct * TILE, HID);
  if (last_for_tile(p.g[T_O] + ct, p.nk4, flag))
    residual_tile(p, part, p.nk4, ct, l == 0, p.g[R_O] + ct);
  rg.release(p);
}

// S5: one gate-up tile's split-K partial.
template <int BB, int R>
__device__ void unit_gu(const Params& p, Ring<R>& rg, float* sm, int& rms_at, int l, int u) {
  const int ct = u % p.n_gu, kc = u / p.n_gu;
  float* gred = sm + GRED_AT;
  const float* xrow = nullptr;
  if (rms_at != l * STAGES + 4) {
    rms_rows<BB>(p, false, sm + RINV_AT, sm + RED_AT, gred);
    rms_at = l * STAGES + 4;
    xrow = gred;
  }
  load_normed(p, false, p.post_norm + (size_t)l * HID, kc, sm, sm + RINV_AT, xrow);
  const uint8_t* slot = rg.take();
  gemv<BB>(p, slot, sm, gred, p.r[PART_GU] + (size_t)kc * p.B * 2 * p.I + ct * TILE, 2 * p.I);
  arrive(p.g[C_GU] + ct);
  rg.release(p);
}

// S6: one down_proj tile (K chunk kc: gate tile kc and up tile I / 128 + kc).
template <int BB, int R>
__device__ void unit_dn(const Params& p, Ring<R>& rg, float* sm, int* flag, int l, int u) {
  const int ct = u % p.n_h, kc = u / p.n_h;
  const float* gu = p.r[PART_GU];
  const size_t step = (size_t)p.B * 2 * p.I;
  for (int i = threadIdx.x; i < p.B * TILE; i += THREADS) {
    const size_t idx = (size_t)(i / TILE) * 2 * p.I + kc * TILE + i % TILE;
    float tg[NK1], tu[NK1];              // gate and up partials, all loads in flight
#pragma unroll
    for (int k = 0; k < NK1; ++k) {
      tg[k] = __ldcg(gu + k * step + idx);
      tu[k] = __ldcg(gu + k * step + idx + p.I);
    }
    float g = 0.f, up = 0.f;
#pragma unroll
    for (int k = 0; k < NK1; ++k) {
      g += tg[k];
      up += tu[k];
    }
    const float sg = bf16r(g * (1.f / (1.f + expf(-g))));
    sm[i] = bf16r(sg * bf16r(up));
  }
  __syncthreads();
  const uint8_t* slot = rg.take();
  float* part = p.r[PART_DN];
  gemv<BB>(p, slot, sm, sm + GRED_AT, part + (size_t)kc * p.B * HID + ct * TILE, HID);
  if (last_for_tile(p.g[T_DN] + ct, p.nk6, flag))
    residual_tile(p, part, p.nk6, ct, false, p.g[R_DN] + ct);
  rg.release(p);
}

// Wait until every tile unit u of stage s in layer l reads is published (the
// kernel's side of ops/cuda/decode_mega.unit_waits): one thread a counter.
__device__ void wait_unit(const Params& p, int l, int s, int u) {
  const int tid = threadIdx.x;
  const unsigned need = (unsigned)(l + 1) * NK1;
  switch (s) {
    case 0:                       // the whole residual row after layer l - 1
      if (l > 0 && tid < p.n_h) spin_ge(p.g[R_DN] + tid, (unsigned)l);
      break;
    case 1: {                     // the heads' qkv tiles, every K chunk
      const int c = u % p.NCH, h = (u / p.NCH) % p.Hkv;
      if (tid < p.G) spin_ge(p.g[C_QKV] + h * p.G + tid, need);
      else if (c == 0 && tid < p.G + 2) spin_ge(p.g[C_QKV] + p.Hq + (tid - p.G) * p.Hkv + h, need);
      break;
    }
    case 2: {                     // every chunk of (b, h) scored
      const int h = (u / p.NCH) % p.Hkv, b = u / (p.NCH * p.Hkv);
      if (tid == 0) spin_ge(p.g[C_S2] + b * p.Hkv + h, (unsigned)(l + 1) * chunks(p, b));
      break;
    }
    case 3:                       // query head kc's attention, every row
      if (tid < p.B)
        spin_ge(p.g[C_S3] + tid * p.Hkv + (u / p.n_h) / p.G, (unsigned)(l + 1) * chunks(p, tid));
      break;
    case 4:                       // the whole residual row after o_proj
      if (tid < p.n_h) spin_ge(p.g[R_O] + tid, (unsigned)(l + 1));
      break;
    default:                      // gate tile kc and up tile I / 128 + kc
      if (tid < 2) spin_ge(p.g[C_GU] + tid * (p.I / TILE) + u / p.n_h, need);
      break;
  }
  __syncthreads();
}

// Blocks an SM holds, and ring slots, at batch bucket BB: three blocks with a
// 3-slot ring at B <= 2 (396 blocks: every stage's units in one round at the
// 0.6B shapes), else two with a 4-slot ring.
__host__ __device__ constexpr int blocks_per_sm(int BB) { return BB <= 2 ? 3 : 2; }
__host__ __device__ constexpr int ring_slots(int BB) { return BB <= 2 ? 3 : 4; }

template <int BB>
__global__ void __launch_bounds__(THREADS, blocks_per_sm(BB)) decode_mega_kernel(Params p) {
  constexpr int R = ring_slots(BB);
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int flag;
  float* sm = reinterpret_cast<float*>(smem + R * SLOT);
  stamp(p, 0);
  Ring<R> rg;
  rg.base = smem;
  rg.used = rg.filled = 0;
  rg.fetch = {0, 0, (int)blockIdx.x - (int)gridDim.x};
  rg.more = next_item(p, rg.fetch);
  for (int i = 0; i < R; ++i) rg.fill_next(p);
  int rms_at = -1;
  stamp(p, 1);
  for (int l = 0; l < p.L; ++l)
    for (int s = 0; s < STAGES; ++s) {
      for (int u = blockIdx.x; u < p.units[s]; u += gridDim.x) {
        if (!valid_unit(p, s, u)) continue;
        wait_unit(p, l, s, u);
        switch (s) {
          case 0: unit_qkv<BB>(p, rg, sm, rms_at, l, u); break;
          case 1: unit_scores(p, rg, sm, l, u); break;
          case 2: unit_pv(p, rg, sm, l, u); break;
          case 3: unit_o<BB>(p, rg, sm, &flag, l, u); break;
          case 4: unit_gu<BB>(p, rg, sm, rms_at, l, u); break;
          default: unit_dn<BB>(p, rg, sm, &flag, l, u); break;
        }
      }
      stamp(p, 2 + STAGES * l + s);
    }
  // the last block to leave returns every sync word to 0 for the next launch
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    fence_acq_rel();
    flag = atomicAdd(p.g[DONE], 1u) == gridDim.x - 1;
    if (flag) fence_acq_rel();
  }
  __syncthreads();
  if (flag) {
    for (int i = threadIdx.x; i < p.sync_words; i += THREADS) __stcg(p.sync + i, 0u);
  }
}

int bucket(int B) { return B <= 1 ? 1 : B <= 2 ? 2 : B <= 4 ? 4 : 8; }

int smem_bytes(int B) {
  return ring_slots(bucket(B)) * SLOT + (int)sizeof(float) * floats_for(B);
}

template <int BB>
cudaError_t grid_bb(int B, int* grid) {
  const int smem = smem_bytes(B);
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(decode_mega_kernel<BB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes(BB));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, decode_mega_kernel<BB>, THREADS, smem);
  *grid = sms * (occ < blocks_per_sm(BB) ? occ : blocks_per_sm(BB));
  return e;
}

template <int BB>
cudaError_t launch_bb(Params& p, int B, int grid, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      decode_mega_kernel<BB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(BB));
  if (e != cudaSuccess) return e;
  if (grid <= 0) {
    const cudaError_t e = grid_bb<BB>(B, &grid);
    if (e != cudaSuccess) return e;
    if (grid <= 0) return cudaErrorInvalidConfiguration;
  }
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel((const void*)decode_mega_kernel<BB>, dim3(grid),
                                     dim3(THREADS), args, (size_t)smem_bytes(B), stream);
}

// C slots (ops/cuda/decode_mega.py SLOTS mirrors this order)
enum Slot {
  S_WD = 0, S_WS = 4, S_F16 = 8, S_IN_NORM, S_POST_NORM, S_Q_NORM, S_K_NORM, S_KC, S_KSC, S_VC,
  S_VSC, S_LENGTHS, S_X0, S_X0_BF16, S_COS, S_SIN, S_X, S_K_NEW, S_KS_NEW, S_V_NEW, S_VS_NEW,
  S_SCRATCH, S_SYNC, S_STAMPS, S_L, S_B, S_H, S_HQ, S_HKV, S_I, S_T, S_EPS, S_GRID, S_STREAM,
  S_REGION, S_GROUP = S_REGION + REGIONS + 1, S_COUNT = S_GROUP + GROUPS + 1
};

}  // namespace

// Blocks of the cooperative grid at batch B: min(occupancy, 3) per SM at
// B <= 2, min(occupancy, 2) beyond (< 0: the occupancy query failed).
extern "C" int acestep_decode_mega_grid(int B) {
  if (B < 1 || B > MAXB) return -1;
  int grid = 0;
  const int bb = bucket(B);
  const cudaError_t e = bb == 1 ? grid_bb<1>(B, &grid) : bb == 2 ? grid_bb<2>(B, &grid)
                        : bb == 4 ? grid_bb<4>(B, &grid) : grid_bb<8>(B, &grid);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return grid;
}

// One call: an array of 8-byte slots (enum Slot; ops/cuda/decode_mega.py packs
// them), the plan's region and sync-word offsets among them: they must be this
// source's own (make_plan), or the call is refused before any launch.
extern "C" int acestep_decode_mega(const int64_t* slots) {
  const auto ptr = [&](int i) { return reinterpret_cast<void*>(slots[i]); };
  const auto num = [&](int i) { return static_cast<int>(slots[i]); };
  const int L = num(S_L), B = num(S_B), H = num(S_H), Hq = num(S_HQ), Hkv = num(S_HKV);
  const int I = num(S_I), T = num(S_T);
  if (L < 1 || B < 1 || B > MAXB || H != HID || Hkv < 1 || Hq % Hkv || Hq / Hkv > MAXG ||
      I < TILE || I % TILE || T < TCH || T % TCH || (Hq * D) % TILE)
    return cudaErrorInvalidValue;
  const Plan plan = make_plan(B, H, Hq, Hkv, I, T);
  for (int r = 0; r <= REGIONS; ++r)
    if (slots[S_REGION + r] != plan.region[r]) return cudaErrorInvalidValue;
  for (int g = 0; g <= GROUPS; ++g)
    if (slots[S_GROUP + g] != plan.group[g]) return cudaErrorInvalidValue;
  Params p{};
  for (int i = 0; i < 4; ++i) {
    p.wd[i] = static_cast<const int8_t*>(ptr(S_WD + i));
    p.ws[i] = ptr(S_WS + i);
  }
  p.f16 = num(S_F16);
  p.in_norm = static_cast<const float*>(ptr(S_IN_NORM));
  p.post_norm = static_cast<const float*>(ptr(S_POST_NORM));
  p.q_norm = static_cast<const float*>(ptr(S_Q_NORM));
  p.k_norm = static_cast<const float*>(ptr(S_K_NORM));
  p.kc = static_cast<const int8_t*>(ptr(S_KC));
  p.ksc = static_cast<const float*>(ptr(S_KSC));
  p.vc = static_cast<const int8_t*>(ptr(S_VC));
  p.vsc = static_cast<const float*>(ptr(S_VSC));
  p.lengths = static_cast<const int*>(ptr(S_LENGTHS));
  p.x0 = ptr(S_X0);
  p.x0_bf16 = num(S_X0_BF16);
  p.cos = static_cast<const float*>(ptr(S_COS));
  p.sin = static_cast<const float*>(ptr(S_SIN));
  p.x = static_cast<float*>(ptr(S_X));
  p.k_new = static_cast<int8_t*>(ptr(S_K_NEW));
  p.ks_new = static_cast<float*>(ptr(S_KS_NEW));
  p.v_new = static_cast<int8_t*>(ptr(S_V_NEW));
  p.vs_new = static_cast<float*>(ptr(S_VS_NEW));
  float* f = static_cast<float*>(ptr(S_SCRATCH));
  for (int r = 0; r < REGIONS; ++r) p.r[r] = f + plan.region[r];
  p.sync = static_cast<unsigned*>(ptr(S_SYNC));
  p.sync_words = static_cast<int>(plan.group[GROUPS]);
  for (int g = 0; g < GROUPS; ++g) p.g[g] = p.sync + plan.group[g];
  p.stamps = static_cast<unsigned long long*>(ptr(S_STAMPS));
  p.L = L; p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.I = I; p.T = T; p.NCH = T / TCH;
  p.G = Hq / Hkv;
  p.nqkv = (Hq + 2 * Hkv) * D;
  p.n_qkv = p.nqkv / TILE;
  p.n_h = HID / TILE;
  p.n_gu = 2 * I / TILE;
  p.nk4 = Hq * D / TILE;
  p.nk6 = I / TILE;
  const int n_attn = B * Hkv * p.NCH;
  const int units[STAGES] = {p.n_qkv * NK1, n_attn, n_attn, p.n_h * p.nk4, p.n_gu * NK1,
                             p.n_h * p.nk6};
  for (int s = 0; s < STAGES; ++s) p.units[s] = units[s];
  const int eps_bits = num(S_EPS);
  memcpy(&p.eps, &eps_bits, sizeof(float));
  const int grid = num(S_GRID);
  const cudaStream_t stream = reinterpret_cast<cudaStream_t>(ptr(S_STREAM));
  const int bb = bucket(B);
  const cudaError_t e = bb == 1 ? launch_bb<1>(p, B, grid, stream)
                        : bb == 2 ? launch_bb<2>(p, B, grid, stream)
                        : bb == 4 ? launch_bb<4>(p, B, grid, stream)
                                  : launch_bb<8>(p, B, grid, stream);
  if (e != cudaSuccess) {
    cudaGetLastError();          // a refused launch is not sticky: clear it, report it
    return e;
  }
  return cudaGetLastError();
}
