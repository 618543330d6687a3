// Single-token GQA decode attention over layer `li` of the stacked int8 KV
// cache, and the same with the per-layer prologue fused in front of it.
//
// Replaces acestep_tpu/ops/pallas/decode_attn.py:
//   row 9   <- _kernel (:57), via decode_attention_int8_stacked
//   row 10  <- _fused_kernel (:145), via decode_attention_fused_stacked
//
// Design: the unit of work is (sequence b, kv head h, chunk c) of CHUNK = 128
// cache positions, serving the G <= 8 query heads of h.  Only the chunks
// that hold positions < length[b] are worked on (chunk 0 always), so the work
// grows with the valid length, not only with B x Hkv.  Every load of a chunk
// (its K or V rows, 16 or 4 bytes a thread, and their scales) is issued
// before the first use.  Two phases:
//   scores  s = q . k / sqrt(D) * k_scale for the chunk's positions, and the
//       chunk's max per head.  Each unit makes this token's q rows itself (in
//       the fused kernel: RMSNorm and rope, the same code, so the same bits)
//       and the self term q . k_self / sqrt(D); chunk 0 of the fused kernel
//       also quantizes the new K / V.
//   P.V  the anchor of the chunk's `tb` block j (the Pallas kernel's T block,
//       the largest of 1024/512/256/128 dividing T) is m_j = max(self term,
//       every chunk max of blocks 0..j): the running max the sequential kernel
//       holds after block j.  p = exp(s - m_j); the chunk's l = sum p and
//       o = sum bf16(p * v_scale) v.  Then the combine, in block order with the
//       sequential kernel's recurrence, seeded with m = self term, l = 1,
//       acc = v_self: alpha = exp(m - m_j), acc = acc alpha + sum o (chunks in
//       order), l = l alpha + sum l, m = m_j; out = acc / l.
// Cluster design: one launch, a thread-block cluster of up to 16
// blocks per (b, h); block r takes the chunks r, r + cs, ... (at most NRMAX),
// issues every load of their K and V rows at once, and keeps its scores in
// shared memory.  Blocks exchange data by storing into each other's shared
// memory (DSMEM): each block pushes its chunk maxima to every block of the
// cluster, and a cluster barrier publishes them; then its chunk partials of
// head g to block g % cs, arriving on that block's mbarrier, and block g % cs
// combines head g.  A first cluster barrier, its arrive at the start and its
// wait before the first push, makes sure every block has started.
// Two-launch design (for caches that need more than NRMAX chunks a block, or
// grids of more than CLUSTER_GRID blocks): one block a unit, a
// scores launch and a P.V launch through scratch in global memory, the last
// unit of (b, h) to finish (an atomic ticket) combining.  Sums run in a
// fixed order and no f32 value is summed by atomics, so reruns are
// bit-identical.
//
// Bound: bytes.  A call reads length[b] rows of int8 K and V (2 x 128 bytes)
// and their two f32 scales per (b, h) and does 4 x G FLOP per (row, dim):
// with G <= 8 query rows per kv head that is ~2 FLOP per cache byte, so the
// work runs on the CUDA cores, not the tensor cores.  At B = 1 and lengths of
// a few hundred the reads are ~1-2 MB: latency, not bandwidth, sets the time,
// hence one launch, units spread over the SMs, every load of a block in
// flight at once, and intermediate data kept on chip.
//
// Numerics (the Pallas kernels'): q is bf16; scores are bf16 q . (int8 -> bf16)
// K accumulated in f32, times 1/sqrt(D), times the K scale; softmax state f32;
// p times the V scale is rounded to bf16 against the running max of its T
// block, as on the TPU, and the P.V product accumulates in f32.  The fused
// prologue rounds to bf16 after the q/k RMSNorm and after the NEOX rope, and
// quantizes the new K / V as kv_cache.quantize_kv.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

namespace {

constexpr int D = 128;           // head dim (the only one the kernels take)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAXG = 8;          // query heads per kv head
constexpr int CHUNK = 128;       // positions per chunk (64 measured slower: PERF.md)
constexpr int MAXCS = 16;        // blocks of a cluster (non-portable above 8)
constexpr int NRMAX = 2;         // chunks a block of the cluster design
constexpr int NCHMAX = MAXCS * NRMAX;   // chunks of a (b, h) in the cluster design
constexpr int CLUSTER_GRID = 256;  // most blocks of the cluster design: past it (B > 2
                                   // at 8 kv heads, T = 1408), two launches run faster
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
static_assert(THREADS % D == 0, "THREADS / D heads at a time in the P.V sums and the combine");

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The four signed bytes of w as floats, exactly: each byte, offset by 128,
// becomes the low byte of the float 2^23 + byte, and 2^23 + 128 comes off.
__device__ __forceinline__ void bytes_to_float4(unsigned w, float f[4]) {
  const unsigned u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
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
  // scratch of the two-launch design (carved by carve()); NCH = T / CHUNK chunks
  float* o_part;                 // [B, Hq, NCH, D] each chunk's sum of bf16(p v_scale) v
  float* s;                      // [B, Hq, T] scores
  float* cmax;                   // [B, Hq, NCH] each chunk's max score
  float* l_part;                 // [B, Hq, NCH] each chunk's sum of p
  float* anchor;                 // [B, Hq, NCH] the anchor m_j of each chunk's T block
  float* s_self;                 // [B, Hq] the self term
  unsigned* ticket;              // [B, Hkv] units of the P.V launch finished
  int B, Hq, Hkv, T, li, tb, nch;
  float eps;
};

// Shared memory of one unit at a time, for GM >= G query heads (the arrays
// read as float4 first, at 16-byte offsets).
template <int GM>
struct __align__(16) Unit {
  float part[WARPS * GM * D];    // the warps' P.V partial sums
  float q[GM * D];               // this token's q rows (bf16 values)
  float pv[GM * CHUNK];          // bf16(p * v_scale)
  float kself[D];
  float sself[GM];               // the self term per head
  float red[WARPS * GM];
  float anch[GM];                // the anchor of the unit's T block per head
  float lp[GM * CHUNK / 32];     // sums of p over 32 positions
  int last;
};

// Where a thread's share of a chunk lies: K rows for the scores (row tid / R,
// 16-byte segments (tid % R) * SEG ..), V rows for P.V (lane l: dims
// 4l..4l+3 of the rows warp * PW + i), the K scale of its row, the V scale of
// position tid % CHUNK.
struct ChunkShape {
  static constexpr int R = THREADS / CHUNK;      // threads per K row
  static constexpr int SEG = D / 16 / R;         // 16-byte K segments per thread
  static constexpr int PW = CHUNK / WARPS;       // V rows per warp
};

// The chunk in registers, every load issued by load_k() / load_v().
struct ChunkRegs : ChunkShape {
  int4 kw[SEG];
  unsigned vw[PW];
  float ksv, vsv;

  __device__ __forceinline__ void load_k(const Args& a, size_t row0, int t0) {
    const int tid = threadIdx.x;
    const int t = t0 + tid / R;
    const int4* src = reinterpret_cast<const int4*>(a.kc + (row0 + t) * D) + (tid % R) * SEG;
#pragma unroll
    for (int i = 0; i < SEG; ++i) kw[i] = __ldg(src + i);
    ksv = __ldg(a.ksc + row0 + t);
  }

  __device__ __forceinline__ void load_v(const Args& a, size_t row0, int t0) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < PW; ++i)
      vw[i] = __ldg(reinterpret_cast<const unsigned*>(a.vc + (row0 + t0 + warp * PW + i) * D) +
                    lane);
    vsv = __ldg(a.vsc + row0 + t0 + threadIdx.x % CHUNK);
  }

  __device__ __forceinline__ int4 k(int i) const { return kw[i]; }
  __device__ __forceinline__ float ks() const { return ksv; }
  __device__ __forceinline__ unsigned v(int i) const { return vw[i]; }
  __device__ __forceinline__ float vs() const { return vsv; }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// The chunk copied to shared memory with cp.async (K segments swizzled by
// row, so that the scores read them without bank conflicts).
struct ChunkSmem : ChunkShape {
  int4 kb[CHUNK * D / 16];
  int4 vb[CHUNK * D / 16];
  float ksb[CHUNK], vsb[CHUNK];

  // issue the copies of chunk t0 .. t0 + CHUNK of the (b, h) rows at row0
  __device__ __forceinline__ void copy(const Args& a, size_t row0, int t0) {
    const int4* ksrc = reinterpret_cast<const int4*>(a.kc + (row0 + t0) * D);
    const int4* vsrc = reinterpret_cast<const int4*>(a.vc + (row0 + t0) * D);
    for (int q = threadIdx.x; q < CHUNK * D / 16; q += THREADS) {
      const int row = q / (D / 16), seg = q % (D / 16);
      cp_async16(&kb[row * (D / 16) + (seg ^ (row & 7))], ksrc + q);
      cp_async16(&vb[q], vsrc + q);
    }
    if (threadIdx.x < CHUNK / 4)
      cp_async16(&ksb[4 * threadIdx.x], a.ksc + row0 + t0 + 4 * threadIdx.x);
    else if (threadIdx.x < CHUNK / 2)
      cp_async16(&vsb[4 * (threadIdx.x - CHUNK / 4)],
                 a.vsc + row0 + t0 + 4 * (threadIdx.x - CHUNK / 4));
  }

  __device__ __forceinline__ int4 k(int i) const {
    const int row = threadIdx.x / R, seg = (threadIdx.x % R) * SEG + i;
    return kb[row * (D / 16) + (seg ^ (row & 7))];
  }
  __device__ __forceinline__ float ks() const { return ksb[threadIdx.x / R]; }
  __device__ __forceinline__ unsigned v(int i) const {
    const int row = (threadIdx.x >> 5) * PW + i;
    return reinterpret_cast<const unsigned*>(vb)[row * (D / 4) + (threadIdx.x & 31)];
  }
  __device__ __forceinline__ float vs() const { return vsb[threadIdx.x % CHUNK]; }
};

// The cluster design's block: a unit's space, its chunks' scores and maxima,
// and what the other blocks push: every chunk's max, and (in the blocks that
// combine) the partials of their heads, row (g / cs) * NCH + c.
template <int GM>
struct Block {
  ChunkSmem ch[NRMAX];
  Unit<GM> u;
  float s[NRMAX][GM * CHUNK];
  float cmax[NRMAX][GM];
  float cm_in[NCHMAX][GM];
  float part_in[NCHMAX][D];
  float l_in[NCHMAX];
  float an_in[NCHMAX];
  unsigned long long bar_part;   // mbarrier: cs arrivals
};

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count));
}

// Arrive (release, cluster scope) on the mbarrier at `bar`'s offset in block
// `rank` of the cluster.
__device__ __forceinline__ void mbar_arrive_remote(unsigned long long* bar, unsigned rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(smem_addr(bar)), "r"(rank));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(remote)
               : "memory");
}

// Wait (acquire, cluster scope) until phase 0 of the local mbarrier completes.
__device__ __forceinline__ void mbar_wait0(unsigned long long* bar) {
  asm volatile(
      "{\n\t.reg .pred done;\n"
      "WAIT_%=:\n\t"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], 0;\n\t"
      "@!done bra WAIT_%=;\n}" ::"r"(smem_addr(bar))
      : "memory");
}

// RMSNorm (rounded to bf16) then NEOX rope (rounded to bf16) of one row held
// by a warp, dims 4 lane .. 4 lane + 3 (w, c, s: the lane's norm weights, cos
// and sin); dim d's rope partner d +- 64 sits in lane ^ 16.
__device__ void norm_rope(float x[4], const float w[4], const float c[4], const float s[4],
                          float eps, int lane) {
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) ss += __fmul_rn(x[j], x[j]);
  const float r = 1.f / sqrtf(warp_sum(ss) / (float)D + eps);
  float y[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) y[j] = bf16r(__fmul_rn(__fmul_rn(x[j], r), w[j]));
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float o = __shfl_xor_sync(FULL, y[j], 16);
    const float rot = lane < 16 ? -o : o;
    x[j] = bf16r(__fadd_rn(__fmul_rn(y[j], c[j]), __fmul_rn(rot, s[j])));
  }
}

// kv_cache.quantize_kv of one row held by a warp (4 dims a lane).
__device__ void quantize_row(const float x[4], int lane, int8_t* q_out, float* s_out) {
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) amax = fmaxf(amax, fabsf(x[j]));
  const float scale = warp_max(amax) / 127.f;
  const float inv = scale > 0.f ? 1.f / fmaxf(scale, 1e-30f) : 0.f;
  char4 r;
  r.x = (signed char)fminf(fmaxf(rintf(__fmul_rn(x[0], inv)), -127.f), 127.f);
  r.y = (signed char)fminf(fmaxf(rintf(__fmul_rn(x[1], inv)), -127.f), 127.f);
  r.z = (signed char)fminf(fmaxf(rintf(__fmul_rn(x[2], inv)), -127.f), 127.f);
  r.w = (signed char)fminf(fmaxf(rintf(__fmul_rn(x[3], inv)), -127.f), 127.f);
  reinterpret_cast<char4*>(q_out)[lane] = r;
  if (lane == 0) *s_out = scale;
}

// Chunks of a sequence that hold valid positions (at least chunk 0).
__device__ __forceinline__ int valid_chunks(int length, int nch) {
  return max(1, min((length + CHUNK - 1) / CHUNK, nch));
}

// This token's rows: the G q rows, the self K and (`quant`, fused only) the
// new V, warp w holding rows w, w + WARPS, ...  load() issues the loads;
// finish() normalises and ropes them (fused), stores q and the self K to
// shared memory, quantizes the new K / V (`quant`) and takes the self term.
template <bool FUSED, int GM>
struct Prologue {
  static constexpr int PR = (GM + 2 + WARPS - 1) / WARPS;
  float x[PR][4];
  float w[PR][4], cosv[4], sinv[4];        // fused: norm weights, cos, sin

  __device__ __forceinline__ int rows(const Args& a, bool quant) const {
    return a.Hq / a.Hkv + 1 + (FUSED && quant ? 1 : 0);
  }

  __device__ __forceinline__ void load(const Args& a, int b, int h, bool quant) {
    const int G = a.Hq / a.Hkv, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const size_t kv_row = ((size_t)b * a.Hkv + h) * D;
#pragma unroll
    for (int k = 0; k < PR; ++k) {
      const int rr = warp + k * WARPS;
      if (rr < rows(a, quant)) {
        const __nv_bfloat16* src = rr < G ? a.q + ((size_t)b * a.Hq + h * G + rr) * D
                                          : (rr == G ? a.k_in : a.v_in) + kv_row;
#pragma unroll
        for (int j = 0; j < 4; ++j) x[k][j] = __bfloat162float(src[4 * lane + j]);
        if (FUSED && rr <= G) {
          const float* wp = rr < G ? a.q_norm : a.k_norm;
#pragma unroll
          for (int j = 0; j < 4; ++j) w[k][j] = wp[4 * lane + j];
        }
      }
    }
    if (FUSED)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        cosv[j] = a.cos[(size_t)b * D + 4 * lane + j];
        sinv[j] = a.sin[(size_t)b * D + 4 * lane + j];
      }
  }

  __device__ void finish(const Args& a, int b, int h, bool quant, Unit<GM>& u) {
    const int G = a.Hq / a.Hkv, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const size_t kv_row = ((size_t)b * a.Hkv + h) * D;
#pragma unroll
    for (int k = 0; k < PR; ++k) {
      const int rr = warp + k * WARPS;
      if (rr < rows(a, quant)) {
        if (FUSED && rr <= G) norm_rope(x[k], w[k], cosv, sinv, a.eps, lane);
        if (rr < G) {
#pragma unroll
          for (int j = 0; j < 4; ++j) u.q[rr * D + 4 * lane + j] = x[k][j];
        } else if (rr == G) {
#pragma unroll
          for (int j = 0; j < 4; ++j) u.kself[4 * lane + j] = x[k][j];
          if (FUSED && quant)
            quantize_row(x[k], lane, a.k_new + kv_row, a.ks_new + (size_t)b * a.Hkv + h);
        } else {
          quantize_row(x[k], lane, a.v_new + kv_row, a.vs_new + (size_t)b * a.Hkv + h);
        }
      }
    }
    __syncthreads();
    for (int g = warp; g < G; g += WARPS) {
      float p = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) p += u.q[g * D + 4 * lane + j] * u.kself[4 * lane + j];
      p = warp_sum(p);
      if (lane == 0) u.sself[g] = p * (1.f / sqrtf((float)D));
    }
    __syncthreads();
  }
};

// The scores of a chunk starting at t0 to s_out[g * s_stride + t], and its max
// per head to cmax_out[g * c_stride].  Needs u.q.
template <int GM, typename Chunk>
__device__ void scores(const Args& a, const Chunk& ch, int t0, int length, float* s_out,
                       int s_stride, float* cmax_out, int c_stride, Unit<GM>& u) {
  constexpr int R = ChunkShape::R, SEG = ChunkShape::SEG;
  const int G = a.Hq / a.Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = tid / R, sub = tid % R;   // the row, and the thread's part of it
  float dot[GM][4];                      // four partial sums a head: shorter FMA chains
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) dot[g][e] = 0.f;
#pragma unroll
  for (int i = 0; i < SEG; ++i) {
    const int4 kq = ch.k(i);
    const unsigned kw[4] = {(unsigned)kq.x, (unsigned)kq.y, (unsigned)kq.z, (unsigned)kq.w};
    const int d0 = (sub * SEG + i) * 16;
#pragma unroll
    for (int e4 = 0; e4 < 4; ++e4) {
      float kv[4];
      bytes_to_float4(kw[e4], kv);
#pragma unroll
      for (int g = 0; g < GM; ++g)
        if (g < G) {
          const float4 qv = *reinterpret_cast<const float4*>(&u.q[g * D + d0 + 4 * e4]);
          dot[g][e4] = fmaf(qv.x, kv[0], dot[g][e4]);
          dot[g][e4] = fmaf(qv.y, kv[1], dot[g][e4]);
          dot[g][e4] = fmaf(qv.z, kv[2], dot[g][e4]);
          dot[g][e4] = fmaf(qv.w, kv[3], dot[g][e4]);
        }
    }
  }
  const float sm_scale = 1.f / sqrtf((float)D);
#pragma unroll
  for (int g = 0; g < GM; ++g)
    if (g < G) {
#pragma unroll
      float dg = (dot[g][0] + dot[g][1]) + (dot[g][2] + dot[g][3]);
#pragma unroll
      for (int o = 1; o < R; o <<= 1) dg += __shfl_xor_sync(FULL, dg, o);
      const float s = t0 + r < length ? (dg * sm_scale) * ch.ks() : NEG_INF;
      if (sub == 0) s_out[g * s_stride + r] = s;
      const float mx = warp_max(s);
      if (lane == 0) u.red[warp * GM + g] = mx;
    }
  __syncthreads();
  if (tid < G) {
    float m = u.red[tid];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) m = fmaxf(m, u.red[w * GM + tid]);
    cmax_out[tid * c_stride] = m;
  }
  __syncthreads();
}

// P.V of a chunk against the anchors in u.anch: its scores s_in[g * s_stride
// + t] (read through L2 when `l2`), its V rows in `ch`.  The chunk's sum of
// bf16(p v_scale) v goes out through emit_o(g, d, value), its sum of p and
// its anchor through emit_l(g, l, anchor).
template <int GM, typename Chunk, typename EmitO, typename EmitL>
__device__ void pv(const Args& a, const Chunk& ch, const float* s_in, int s_stride, bool l2,
                   EmitO emit_o, EmitL emit_l, Unit<GM>& u) {
  constexpr int PW = ChunkShape::PW;
  const int G = a.Hq / a.Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // p and bf16(p * v_scale); the chunk's sum of p in 32-position pieces
  for (int i = tid; i < G * CHUNK; i += THREADS) {
    const int g = i / CHUNK, t = i % CHUNK;   // t == tid % CHUNK: ch.vs() is its scale
    const float s = l2 ? __ldcg(s_in + g * s_stride + t) : s_in[g * s_stride + t];
    const float p = expf(s - u.anch[g]);
    u.pv[g * CHUNK + t] = bf16r(p * ch.vs());
    const float ps = warp_sum(p);
    if (lane == 0) u.lp[i / 32] = ps;
  }
  __syncthreads();
  float acc[GM][4];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[g][j] = 0.f;
#pragma unroll
  for (int i = 0; i < PW; ++i) {
    float v[4];
    bytes_to_float4(ch.v(i), v);
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (g < G) {
        const float p = u.pv[g * CHUNK + warp * PW + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[g][j] = fmaf(p, v[j], acc[g][j]);
      }
  }
#pragma unroll
  for (int g = 0; g < GM; ++g)
    if (g < G)
      *reinterpret_cast<float4*>(&u.part[(warp * GM + g) * D + 4 * lane]) =
          make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  __syncthreads();
  for (int g = tid / D; g < G; g += THREADS / D) {     // thread tid sums dim tid % D
    const int d = tid % D;
    float o = u.part[g * D + d];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) o += u.part[(w * GM + g) * D + d];
    emit_o(g, d, o);
  }
  if (tid < G) {
    float l = 0.f;
#pragma unroll
    for (int k = 0; k < CHUNK / 32; ++k) l += u.lp[tid * (CHUNK / 32) + k];
    emit_l(tid, l, u.anch[tid]);
  }
  __syncthreads();
}

// The outputs of heads g = g0, g0 + gstep, ... (nh of them) of (b, h): the
// sequential kernel's recurrence over the valid chunks, one T block (cpb
// chunks) at a time, seeded with m = the self term, l = 1, acc = v_self:
// alpha = exp(m - m_j), acc = acc alpha + sum o, l = l alpha + sum l, m = m_j,
// chunks summed in order.  The anchors are known, so one thread a head takes
// the alphas and l first, then one thread a (head, dim) the acc chain.  Chunk
// c's partials of the q-th head come from lv(q, c), an(q, c) and ov(q, c, d),
// read 8 chunks at a time.  `alpha` holds nh x (T blocks) floats, `l_out` nh.
template <typename L, typename An, typename Ov>
__device__ void combine(const Args& a, int b, int h, int g0, int gstep, int nh,
                        const float* s_self, float v_self, int nvalid, int cpb, float* alpha,
                        float* l_out, L lv, An an, Ov ov) {
  const int G = a.Hq / a.Hkv, tid = threadIdx.x;
  const int nb = (nvalid + cpb - 1) / cpb;           // valid T blocks
  if (tid < nh) {
    const int g = g0 + tid * gstep;
    float m = s_self[g], l = 1.f, mj = m, lsum = 0.f;
    int k = 0, j = 0;
    for (int c0 = 0; c0 < nvalid; c0 += 8) {
      float l8[8], a8[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (c0 + u < nvalid) {
          l8[u] = lv(tid, c0 + u);
          a8[u] = an(tid, c0 + u);
        }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (c0 + u < nvalid) {
          if (k == 0) mj = a8[u];
          lsum += l8[u];
          if (++k == cpb || c0 + u == nvalid - 1) {   // the T block ends
            const float al = expf(m - mj);
            alpha[tid * nb + j++] = al;
            l = l * al + lsum;
            m = mj;
            lsum = 0.f;
            k = 0;
          }
        }
    }
    l_out[tid] = l;
  }
  __syncthreads();
  const int d = tid % D;
  for (int q = tid / D; q < nh; q += THREADS / D) {
    const int g = g0 + q * gstep;
    float acc = v_self, osum = 0.f;
    int k = 0, j = 0;
    for (int c0 = 0; c0 < nvalid; c0 += 8) {
      float o8[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (c0 + u < nvalid) o8[u] = ov(q, c0 + u, d);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (c0 + u < nvalid) {
          osum += o8[u];
          if (++k == cpb || c0 + u == nvalid - 1) {
            acc = acc * alpha[q * nb + j++] + osum;
            osum = 0.f;
            k = 0;
          }
        }
    }
    a.out[(((size_t)b * a.Hq + h * G + g)) * D + d] = acc / l_out[q];
  }
}

// ---- two-launch design: one block a unit, through scratch in global memory

__device__ __forceinline__ void unit_of(const Args& a, int& b, int& h, int& c) {
  const int u = blockIdx.x;
  c = u % a.nch;
  h = (u / a.nch) % a.Hkv;
  b = u / (a.nch * a.Hkv);
}

template <bool FUSED, int GM>
__global__ void __launch_bounds__(THREADS) scores_kernel(Args a) {
  __shared__ Unit<GM> u;
  int b, h, c;
  unit_of(a, b, h, c);
  Prologue<FUSED, GM> pro;
  pro.load(a, b, h, c == 0);
  const int length = a.lengths[b];
  const int t0 = c * CHUNK;
  if (c > 0 && t0 >= length) return;
  const size_t row0 = (((size_t)a.li * a.B + b) * a.Hkv + h) * (size_t)a.T;
  ChunkRegs ch;
  ch.load_k(a, row0, t0);
  pro.finish(a, b, h, c == 0, u);
  const int G = a.Hq / a.Hkv;
  const size_t hq0 = (size_t)b * a.Hq + h * G;
  if (c == 0) {
    if (threadIdx.x < G) a.s_self[hq0 + threadIdx.x] = u.sself[threadIdx.x];
    if (threadIdx.x == 0) a.ticket[b * a.Hkv + h] = 0u;
  }
  scores<GM>(a, ch, t0, length, a.s + hq0 * a.T + t0, a.T, a.cmax + hq0 * a.nch + c, a.nch, u);
}

template <int GM>
__global__ void __launch_bounds__(THREADS) pv_kernel(Args a) {
  __shared__ Unit<GM> u;
  int b, h, c;
  unit_of(a, b, h, c);
  const int length = a.lengths[b];
  const int t0 = c * CHUNK;
  if (c > 0 && t0 >= length) return;
  const size_t row0 = (((size_t)a.li * a.B + b) * a.Hkv + h) * (size_t)a.T;
  ChunkRegs ch;
  ch.load_v(a, row0, t0);
  const int G = a.Hq / a.Hkv;
  const int tid = threadIdx.x;
  const int nvalid = valid_chunks(length, a.nch), cpb = a.tb / CHUNK;
  const size_t hq0 = (size_t)b * a.Hq + h * G;
  {  // the anchor of the chunk's T block: 16 threads a head
    const int g = tid >> 4, sub = tid & 15;
    const int cend = min(nvalid, (c / cpb + 1) * cpb);
    float m = NEG_INF;
    if (g < G)
      for (int c2 = sub; c2 < cend; c2 += 16) m = fmaxf(m, __ldcg(a.cmax + (hq0 + g) * a.nch + c2));
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
    if (g < G && sub == 0) u.anch[g] = fmaxf(m, __ldcg(a.s_self + hq0 + g));
  }
  __syncthreads();
  pv<GM>(
      a, ch, a.s + hq0 * a.T + t0, a.T, true,
      [&](int g, int d, float o) { a.o_part[((hq0 + g) * a.nch + c) * D + d] = o; },
      [&](int g, float l, float an) {
        a.l_part[(hq0 + g) * a.nch + c] = l;
        a.anchor[(hq0 + g) * a.nch + c] = an;
      },
      u);
  // the last unit of (b, h) to finish combines its chunks in block order
  __threadfence();
  __syncthreads();
  if (tid == 0) u.last = atomicAdd(a.ticket + b * a.Hkv + h, 1u) == (unsigned)(nvalid - 1);
  __syncthreads();
  if (!u.last) return;
  __threadfence();
  const float v_self = __bfloat162float(a.v_in[((size_t)b * a.Hkv + h) * D + tid % D]);
  if (tid < G) u.sself[tid] = __ldcg(a.s_self + hq0 + tid);
  __syncthreads();
  combine(
      a, b, h, 0, 1, G, u.sself, v_self, nvalid, cpb, u.part, u.red,
      [&](int g, int cc) { return __ldcg(a.l_part + (hq0 + g) * a.nch + cc); },
      [&](int g, int cc) { return __ldcg(a.anchor + (hq0 + g) * a.nch + cc); },
      [&](int g, int cc, int d) { return __ldcg(a.o_part + ((hq0 + g) * a.nch + cc) * D + d); });
}

// ---- cluster design: one cluster of cs blocks per (b, h) = blockIdx.y

template <bool FUSED, int GM>
__global__ void __launch_bounds__(THREADS) cluster_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  Block<GM>& blk = *reinterpret_cast<Block<GM>*>(smem);
  Unit<GM>& u = blk.u;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x, cs = gridDim.x;
  const int b = blockIdx.y / a.Hkv, h = blockIdx.y % a.Hkv;
  const int G = a.Hq / a.Hkv, tid = threadIdx.x;
  // first every load: the length, this token's rows, v_self (for the
  // combine), then the K and V rows of the block's valid chunks
  const int length = a.lengths[b];
  Prologue<FUSED, GM> pro;
  pro.load(a, b, h, rank == 0);
  const float v_self = __bfloat162float(a.v_in[((size_t)b * a.Hkv + h) * D + tid % D]);
  const size_t row0 = (((size_t)a.li * a.B + b) * a.Hkv + h) * (size_t)a.T;
  if (tid == 0) {                // while the loads are in flight
    mbar_init(&blk.bar_part, cs);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // every block of the cluster has started (its shared memory may be written)
  // once this arrive has met its wait below
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  const int nvalid = valid_chunks(length, a.nch), cpb = a.tb / CHUNK;
#pragma unroll
  for (int j = 0; j < NRMAX; ++j)
    if (rank + j * cs < nvalid) blk.ch[j].copy(a, row0, (rank + j * cs) * CHUNK);
  asm volatile("cp.async.commit_group;" ::: "memory");
  pro.finish(a, b, h, rank == 0, u);
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NRMAX; ++j)
    if (rank + j * cs < nvalid)
      scores<GM>(a, blk.ch[j], (rank + j * cs) * CHUNK, length, blk.s[j], CHUNK, blk.cmax[j], 1,
                 u);
  // push this block's chunk maxima to every block; a second cluster barrier
  // (release / acquire) publishes them
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  for (int i = tid; i < cs * NRMAX * G; i += THREADS) {
    const int dst = i / (NRMAX * G), j = (i / G) % NRMAX, g = i % G, c = rank + j * cs;
    if (c < nvalid) *cluster.map_shared_rank(&blk.cm_in[c][g], dst) = blk.cmax[j][g];
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n\tbarrier.cluster.wait.acquire.aligned;"
               ::: "memory");
#pragma unroll
  for (int j = 0; j < NRMAX; ++j) {
    const int c = rank + j * cs;
    if (c < nvalid) {
      {  // the anchor of chunk c's T block: 16 threads a head
        const int g = tid >> 4, sub = tid & 15;
        const int cend = min(nvalid, (c / cpb + 1) * cpb);
        float m = NEG_INF;
        if (g < G)
          for (int c2 = sub; c2 < cend; c2 += 16) m = fmaxf(m, blk.cm_in[c2][g]);
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
        if (g < G && sub == 0) u.anch[g] = fmaxf(m, u.sself[g]);
      }
      __syncthreads();
      // head g's partials go to block g % cs, row (g / cs) * NCH + c (g < 8:
      // the quotient by subtraction)
      auto dest = [&](int g, int& row) {
        int r = g, q = 0;
        while (r >= cs) r -= cs, ++q;
        row = q * a.nch + c;
        return r;
      };
      pv<GM>(
          a, blk.ch[j], blk.s[j], CHUNK, false,
          [&](int g, int d, float o) {
            int row;
            const int r = dest(g, row);
            *cluster.map_shared_rank(&blk.part_in[row][d], r) = o;
          },
          [&](int g, float l, float an) {
            int row;
            const int r = dest(g, row);
            *cluster.map_shared_rank(&blk.l_in[row], r) = l;
            *cluster.map_shared_rank(&blk.an_in[row], r) = an;
          },
          u);
    }
  }
  __syncthreads();
  const int ncomb = min(G, cs);            // the blocks that combine
  if (tid < ncomb) mbar_arrive_remote(&blk.bar_part, tid);
  if (rank >= ncomb) return;
  mbar_wait0(&blk.bar_part);
  combine(
      a, b, h, rank, cs, (G - rank + cs - 1) / cs, u.sself, v_self, nvalid, cpb, u.part, u.red,
      [&](int q, int cc) { return blk.l_in[q * a.nch + cc]; },   // head rank + q cs: row q NCH + c
      [&](int q, int cc) { return blk.an_in[q * a.nch + cc]; },
      [&](int q, int cc, int d) { return blk.part_in[q * a.nch + cc][d]; });
}

// The cluster design when the cache's chunks fit NRMAX a block of a cluster and
// the grid is small; otherwise two launches.
template <bool FUSED, int GM>
int launch_t(Args a, cudaStream_t stream) {
  const int cs = a.nch < MAXCS ? a.nch : MAXCS;
  if ((a.nch + cs - 1) / cs <= NRMAX && a.B * a.Hkv * cs <= CLUSTER_GRID) {
    auto kernel = cluster_kernel<FUSED, GM>;
    const int smem = (int)sizeof(Block<GM>);
    // the kernel's attributes are set once per device
    static unsigned long long ready = 0;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= 64) return cudaErrorInvalidDevice;
    if (!(ready >> dev & 1ull)) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) {
        cudaGetLastError();
        return e;
      }
      ready |= 1ull << dev;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cs, a.B * a.Hkv);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, kernel, a);
    if (e != cudaSuccess) {
      cudaGetLastError();        // a refused launch is not sticky: clear it, report it
      return e;
    }
    return cudaGetLastError();
  }
  const int units = a.B * a.Hkv * a.nch;
  scores_kernel<FUSED, GM><<<units, THREADS, 0, stream>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  pv_kernel<GM><<<units, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

template <bool FUSED>
int launch_g(const Args& a, cudaStream_t stream) {
  const int G = a.Hq / a.Hkv;
  if (G == 1) return launch_t<FUSED, 1>(a, stream);
  if (G == 2) return launch_t<FUSED, 2>(a, stream);
  if (G <= 4) return launch_t<FUSED, 4>(a, stream);
  return launch_t<FUSED, 8>(a, stream);
}

size_t scratch_floats(int B, int Hq, int Hkv, int T) {
  const size_t nch = (size_t)T / CHUNK, bh = (size_t)B * Hq;
  return bh * nch * D + bh * T + 3 * bh * nch + bh + (size_t)B * Hkv;
}

// Carve the scratch (floats; the tickets at its end) in the order of Args.
void carve(Args& a, float* scratch) {
  const size_t nch = (size_t)a.T / CHUNK, bh = (size_t)a.B * a.Hq;
  a.o_part = scratch;
  a.s = a.o_part + bh * nch * D;
  a.cmax = a.s + bh * a.T;
  a.l_part = a.cmax + bh * nch;
  a.anchor = a.l_part + bh * nch;
  a.s_self = a.anchor + bh * nch;
  a.ticket = reinterpret_cast<unsigned*>(a.s_self + bh);
}

template <bool FUSED>
int launch(Args& a, void* scratch, void* stream) {
  const int G = a.Hkv > 0 ? a.Hq / a.Hkv : 0;
  if (a.B < 1 || G < 1 || G > MAXG || a.Hq % a.Hkv || a.tb % 128 || a.T % a.tb ||
      a.T / a.tb > WARPS * D)        // the combine's alphas fit in Unit::part
    return cudaErrorInvalidValue;
  a.nch = a.T / CHUNK;
  carve(a, (float*)scratch);
  return launch_g<FUSED>(a, (cudaStream_t)stream);
}

}  // namespace

// Floats of scratch one call needs.
extern "C" int acestep_decode_attn_scratch(int B, int Hq, int Hkv, int T) {
  if (B < 1 || Hkv < 1 || T % CHUNK) return -1;
  return (int)scratch_floats(B, Hq, Hkv, T);
}

// The entry points take one array of 8-byte slots (pointers, ints, eps as a
// double): a call from Python packs a few values, not 30 ctypes arguments.
// The first part of the slots stays the same for a cache, shapes and stream.
enum Slot {
  KC, KSC, VC, VSC, SCRATCH, NB, NHQ, NHKV, NT, NTB,                  // per cache and shapes
  LENGTHS, LI, STREAM, Q, K_IN, V_IN, OUT,                           // per call, row 9
  Q_NORM, K_NORM, COS, SIN, K_NEW, KS_NEW, V_NEW, VS_NEW, EPS,       // per call, row 10
  NSLOTS
};

namespace {

template <bool FUSED>
int run(const int64_t* s) {
  Args a{};
  a.q = (const __nv_bfloat16*)s[Q];
  a.k_in = (const __nv_bfloat16*)s[K_IN];
  a.v_in = (const __nv_bfloat16*)s[V_IN];
  a.kc = (const int8_t*)s[KC];
  a.ksc = (const float*)s[KSC];
  a.vc = (const int8_t*)s[VC];
  a.vsc = (const float*)s[VSC];
  a.lengths = (const int*)s[LENGTHS];
  a.out = (float*)s[OUT];
  a.B = (int)s[NB]; a.Hq = (int)s[NHQ]; a.Hkv = (int)s[NHKV]; a.T = (int)s[NT];
  a.li = (int)s[LI]; a.tb = (int)s[NTB];
  if (FUSED) {
    a.q_norm = (const float*)s[Q_NORM];
    a.k_norm = (const float*)s[K_NORM];
    a.cos = (const float*)s[COS];
    a.sin = (const float*)s[SIN];
    a.k_new = (int8_t*)s[K_NEW];
    a.ks_new = (float*)s[KS_NEW];
    a.v_new = (int8_t*)s[V_NEW];
    a.vs_new = (float*)s[VS_NEW];
    double eps;
    memcpy(&eps, s + EPS, sizeof eps);
    a.eps = (float)eps;
  }
  return launch<FUSED>(a, (void*)s[SCRATCH], (void*)s[STREAM]);
}

}  // namespace

// Row 9: slots KC .. OUT.
extern "C" int acestep_decode_attn(const int64_t* slots) { return run<false>(slots); }

// Row 10: slots KC .. EPS.
extern "C" int acestep_decode_attn_fused(const int64_t* slots) { return run<true>(slots); }
