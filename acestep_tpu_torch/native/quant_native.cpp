// Host-side block quantizers of the checkpoint converter: the port's own copy
// of the JAX package's native quantizers (the same loops, the same bits).
//
// The weights are in kernel layout [K, N] (row-major f32, blocks along K) and
// the 4-bit formats use fold-256 nibble packing, as in
// acestep_tpu_torch/quant/formats.py, which these loops must match bit for bit
// (tests/test_torch_native_quant.py holds every field of every format to it).
// Fused single-pass loops over column stripes, one std::thread each, convert a
// multi-GB checkpoint in seconds where numpy's elementwise chains take minutes.
//
//   q8_0: d = amax/127 (stored f16), q = roundf(x/d) int8           [K, N]
//   q4_0: d = signed_absmax/-8 (f16), q = clip(floor(x/d + 8.5))    fold-256
//   q4_k: per-32 asym (d_b, min_b) -> 6-bit ls/lm vs per-256 super  fold-256
//   q6_k: per-16 d_b = signed_absmax/-32 -> int8 ls vs per-256 super,
//         q = clip(roundf(x/d_eff), -32, 31) + 32: low nibbles fold-256,
//         high 2 bits fold-64
//
// Bound through the raw CPython C API (no pybind11 needed); built with g++ by
// acestep_tpu_torch/native/__init__.py.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int BLOCK = 32;
constexpr int SUPER = 256;
constexpr int FOLD = 256;

// ---------------------------------------------------------------------------
// f16 helpers (scalar; scales only — O(K/32 * N) elements)
// ---------------------------------------------------------------------------

static uint16_t f32_to_f16(float f) {
    uint32_t x;
    std::memcpy(&x, &f, 4);
    const uint32_t sign = (x >> 16) & 0x8000u;
    int32_t exp = static_cast<int32_t>((x >> 23) & 0xFF) - 127 + 15;
    uint32_t mant = x & 0x7FFFFFu;
    if (exp <= 0) {
        if (exp < -10) return static_cast<uint16_t>(sign);
        mant |= 0x800000u;
        const uint32_t shift = static_cast<uint32_t>(14 - exp);
        uint32_t rounded = (mant + (1u << (shift - 1))) >> shift;
        return static_cast<uint16_t>(sign | rounded);
    }
    if (exp >= 31) return static_cast<uint16_t>(sign | 0x7C00u);
    // round mantissa to 10 bits (nearest even)
    uint32_t rounded = mant + 0xFFFu + ((mant >> 13) & 1u);
    if (rounded & 0x800000u) {  // mantissa overflow -> bump exponent
        rounded = 0;
        ++exp;
        if (exp >= 31) return static_cast<uint16_t>(sign | 0x7C00u);
    }
    return static_cast<uint16_t>(sign | (static_cast<uint32_t>(exp) << 10) | (rounded >> 13));
}

static float f16_to_f32(uint16_t h) {
    const uint32_t sign = (static_cast<uint32_t>(h) & 0x8000u) << 16;
    uint32_t exp = (h >> 10) & 0x1Fu;
    uint32_t mant = h & 0x3FFu;
    uint32_t out;
    if (exp == 0) {
        if (mant == 0) {
            out = sign;
        } else {
            exp = 127 - 15 + 1;
            while (!(mant & 0x400u)) { mant <<= 1; --exp; }
            mant &= 0x3FFu;
            out = sign | (exp << 23) | (mant << 13);
        }
    } else if (exp == 31) {
        out = sign | 0x7F800000u | (mant << 13);
    } else {
        out = sign | ((exp - 15 + 127) << 23) | (mant << 13);
    }
    float f;
    std::memcpy(&f, &out, 4);
    return f;
}

static inline float roundf_away(float x) {
    return std::trunc(x + std::copysign(0.5f, x));
}

// ---------------------------------------------------------------------------
// parallel-for over column stripes
// ---------------------------------------------------------------------------

template <typename F>
static void parallel_cols(int64_t n, F&& fn) {
    unsigned hw = std::max(1u, std::thread::hardware_concurrency());
    const int64_t stripe = std::max<int64_t>(64, (n + hw - 1) / hw);
    std::vector<std::thread> ts;
    for (int64_t c0 = 0; c0 < n; c0 += stripe) {
        const int64_t c1 = std::min(n, c0 + stripe);
        ts.emplace_back([&fn, c0, c1]() { fn(c0, c1); });
    }
    for (auto& t : ts) t.join();
}

// ---------------------------------------------------------------------------
// quantizers (column-major loops over [K, N] row-major f32 input)
// ---------------------------------------------------------------------------

static void q8_0(const float* w, int64_t k, int64_t n, int8_t* data, uint16_t* scales) {
    parallel_cols(n, [&](int64_t c0, int64_t c1) {
        for (int64_t b = 0; b < k / BLOCK; ++b) {
            for (int64_t c = c0; c < c1; ++c) {
                float amax = 0.f;
                for (int r = 0; r < BLOCK; ++r) {
                    amax = std::max(amax, std::fabs(w[(b * BLOCK + r) * n + c]));
                }
                const float d = amax / 127.0f;
                scales[b * n + c] = f32_to_f16(d);
                const float inv = d > 0.f ? 1.0f / d : 0.0f;
                for (int r = 0; r < BLOCK; ++r) {
                    float q = roundf_away(w[(b * BLOCK + r) * n + c] * inv);
                    q = std::min(127.f, std::max(-127.f, q));
                    data[(b * BLOCK + r) * n + c] = static_cast<int8_t>(q);
                }
            }
        }
    });
}

// fold-256 pack position: row r of group g -> byte (g*128 + r%128), nibble r/128
static inline void pack_nibble(uint8_t* packed, int64_t n, int64_t row, int64_t col,
                               uint8_t val) {
    const int64_t g = row / FOLD;
    const int64_t r = row % FOLD;
    uint8_t* cell = &packed[(g * (FOLD / 2) + (r % (FOLD / 2))) * n + col];
    if (r < FOLD / 2) {
        *cell = static_cast<uint8_t>((*cell & 0xF0u) | val);
    } else {
        *cell = static_cast<uint8_t>((*cell & 0x0Fu) | (val << 4));
    }
}

static void q4_0(const float* w, int64_t k, int64_t n, uint8_t* data, uint16_t* scales) {
    std::memset(data, 0, static_cast<size_t>(k / 2) * n);
    parallel_cols(n, [&](int64_t c0, int64_t c1) {
        for (int64_t b = 0; b < k / BLOCK; ++b) {
            for (int64_t c = c0; c < c1; ++c) {
                float best = 0.f, amax = 0.f;
                for (int r = 0; r < BLOCK; ++r) {
                    const float v = w[(b * BLOCK + r) * n + c];
                    if (std::fabs(v) > amax) { amax = std::fabs(v); best = v; }
                }
                const float d = best / -8.0f;
                scales[b * n + c] = f32_to_f16(d);
                const float inv = d != 0.f ? 1.0f / d : 0.0f;
                for (int r = 0; r < BLOCK; ++r) {
                    float q = std::floor(w[(b * BLOCK + r) * n + c] * inv + 8.5f);
                    q = std::min(15.f, std::max(0.f, q));
                    pack_nibble(data, n, b * BLOCK + r, c, static_cast<uint8_t>(q));
                }
            }
        }
    });
}

static void q4_k(const float* w, int64_t k, int64_t n, uint8_t* data,
                 uint8_t* ls, uint8_t* lm, uint16_t* dsup, uint16_t* msup) {
    std::memset(data, 0, static_cast<size_t>(k / 2) * n);
    const int64_t nb = k / BLOCK;
    const int64_t ns = k / SUPER;
    const int sub = SUPER / BLOCK;
    parallel_cols(n, [&](int64_t c0, int64_t c1) {
        std::vector<float> d_b(sub), min_b(sub);
        for (int64_t s = 0; s < ns; ++s) {
            for (int64_t c = c0; c < c1; ++c) {
                float dmax = 0.f, mmax = 0.f;
                for (int j = 0; j < sub; ++j) {
                    const int64_t b = s * sub + j;
                    float mn = 0.f, mx = -1e30f;
                    for (int r = 0; r < BLOCK; ++r) {
                        const float v = w[(b * BLOCK + r) * n + c];
                        mn = std::min(mn, v);
                        mx = std::max(mx, v);
                    }
                    d_b[j] = (mx - mn) / 15.0f;
                    min_b[j] = -mn;
                    dmax = std::max(dmax, d_b[j]);
                    mmax = std::max(mmax, min_b[j]);
                }
                const float ds = dmax / 63.0f;
                const float ms = mmax / 63.0f;
                dsup[s * n + c] = f32_to_f16(ds);
                msup[s * n + c] = f32_to_f16(ms);
                for (int j = 0; j < sub; ++j) {
                    const int64_t b = s * sub + j;
                    float lsv = ds > 0.f ? roundf_away(d_b[j] / ds) : 0.f;
                    float lmv = ms > 0.f ? roundf_away(min_b[j] / ms) : 0.f;
                    lsv = std::min(63.f, std::max(0.f, lsv));
                    lmv = std::min(63.f, std::max(0.f, lmv));
                    ls[b * n + c] = static_cast<uint8_t>(lsv);
                    lm[b * n + c] = static_cast<uint8_t>(lmv);
                    const float d_eff = ds * lsv;   // unrounded super scale,
                    const float m_eff = ms * lmv;   // matching the numpy golden path
                    const float inv = d_eff > 0.f ? 1.0f / d_eff : 0.0f;
                    for (int r = 0; r < BLOCK; ++r) {
                        float q = roundf_away((w[(b * BLOCK + r) * n + c] + m_eff) * inv);
                        q = std::min(15.f, std::max(0.f, q));
                        pack_nibble(data, n, b * BLOCK + r, c, static_cast<uint8_t>(q));
                    }
                }
            }
        }
    });
}

// fold-64 2-bit pack: row r of group g -> byte (g*64 + r%64), bit pair r/64
static inline void pack_crumb(uint8_t* packed, int64_t n, int64_t row, int64_t col,
                              uint8_t val) {
    const int64_t g = row / FOLD;
    const int64_t r = row % FOLD;
    uint8_t* cell = &packed[(g * (FOLD / 4) + (r % (FOLD / 4))) * n + col];
    const int shift = 2 * static_cast<int>(r / (FOLD / 4));
    *cell = static_cast<uint8_t>((*cell & ~(0x3u << shift)) |
                                 (static_cast<uint32_t>(val & 0x3u) << shift));
}

static void q6_k(const float* w, int64_t k, int64_t n, uint8_t* data,
                 uint8_t* data_hi, int8_t* ls, uint16_t* dsup) {
    constexpr int SUB16 = 16;
    std::memset(data, 0, static_cast<size_t>(k / 2) * n);
    std::memset(data_hi, 0, static_cast<size_t>(k / 4) * n);
    const int64_t ns = k / SUPER;
    const int sub = SUPER / SUB16;
    parallel_cols(n, [&](int64_t c0, int64_t c1) {
        std::vector<float> d_b(sub);
        for (int64_t s = 0; s < ns; ++s) {
            for (int64_t c = c0; c < c1; ++c) {
                float dmax = 0.f;
                for (int j = 0; j < sub; ++j) {
                    const int64_t b = s * sub + j;
                    float best = 0.f, amax = 0.f;
                    for (int r = 0; r < SUB16; ++r) {
                        const float v = w[(b * SUB16 + r) * n + c];
                        if (std::fabs(v) > amax) { amax = std::fabs(v); best = v; }
                    }
                    d_b[j] = best / -32.0f;
                    dmax = std::max(dmax, std::fabs(d_b[j]));
                }
                const float ds = dmax / 127.0f;
                dsup[s * n + c] = f32_to_f16(ds);
                for (int j = 0; j < sub; ++j) {
                    const int64_t b = s * sub + j;
                    float lsv = ds > 0.f ? roundf_away(d_b[j] / ds) : 0.f;
                    lsv = std::min(127.f, std::max(-127.f, lsv));
                    ls[b * n + c] = static_cast<int8_t>(lsv);
                    const float d_eff = ds * lsv;   // unrounded super scale,
                    const float inv = d_eff != 0.f ? 1.0f / d_eff : 0.0f;
                    for (int r = 0; r < SUB16; ++r) {
                        float q = roundf_away(w[(b * SUB16 + r) * n + c] * inv);
                        q = std::min(31.f, std::max(-32.f, q)) + 32.f;
                        const uint8_t u = static_cast<uint8_t>(q);
                        pack_nibble(data, n, b * SUB16 + r, c, u & 0xF);
                        pack_crumb(data_hi, n, b * SUB16 + r, c, u >> 4);
                    }
                }
            }
        }
    });
}

static void bf16_from_f32(const float* src, uint16_t* dst, int64_t count) {
    parallel_cols(count, [&](int64_t i0, int64_t i1) {
        for (int64_t i = i0; i < i1; ++i) {
            uint32_t bits;
            std::memcpy(&bits, &src[i], 4);
            const uint32_t rounding = 0x7FFFu + ((bits >> 16) & 1u);
            dst[i] = static_cast<uint16_t>((bits + rounding) >> 16);
        }
    });
}

// ---------------------------------------------------------------------------
// Python bindings (buffer-protocol based; numpy arrays arrive as memoryviews)
// ---------------------------------------------------------------------------

struct BufView {
    Py_buffer view{};
    bool ok = false;
    BufView(PyObject* obj, int flags) { ok = PyObject_GetBuffer(obj, &view, flags) == 0; }
    ~BufView() { if (ok) PyBuffer_Release(&view); }
};

static PyObject* py_quantize_q8_0(PyObject*, PyObject* args) {
    PyObject *w_obj, *data_obj, *scales_obj;
    Py_ssize_t k, n;
    if (!PyArg_ParseTuple(args, "OnnOO", &w_obj, &k, &n, &data_obj, &scales_obj)) return nullptr;
    BufView w(w_obj, PyBUF_C_CONTIGUOUS), d(data_obj, PyBUF_WRITABLE), s(scales_obj, PyBUF_WRITABLE);
    if (!w.ok || !d.ok || !s.ok) return nullptr;
    Py_BEGIN_ALLOW_THREADS
    q8_0(static_cast<const float*>(w.view.buf), k, n,
         static_cast<int8_t*>(d.view.buf), static_cast<uint16_t*>(s.view.buf));
    Py_END_ALLOW_THREADS
    Py_RETURN_NONE;
}

static PyObject* py_quantize_q4_0(PyObject*, PyObject* args) {
    PyObject *w_obj, *data_obj, *scales_obj;
    Py_ssize_t k, n;
    if (!PyArg_ParseTuple(args, "OnnOO", &w_obj, &k, &n, &data_obj, &scales_obj)) return nullptr;
    BufView w(w_obj, PyBUF_C_CONTIGUOUS), d(data_obj, PyBUF_WRITABLE), s(scales_obj, PyBUF_WRITABLE);
    if (!w.ok || !d.ok || !s.ok) return nullptr;
    Py_BEGIN_ALLOW_THREADS
    q4_0(static_cast<const float*>(w.view.buf), k, n,
         static_cast<uint8_t*>(d.view.buf), static_cast<uint16_t*>(s.view.buf));
    Py_END_ALLOW_THREADS
    Py_RETURN_NONE;
}

static PyObject* py_quantize_q4_k(PyObject*, PyObject* args) {
    PyObject *w_obj, *data_obj, *ls_obj, *lm_obj, *ds_obj, *ms_obj;
    Py_ssize_t k, n;
    if (!PyArg_ParseTuple(args, "OnnOOOOO", &w_obj, &k, &n, &data_obj, &ls_obj,
                          &lm_obj, &ds_obj, &ms_obj)) return nullptr;
    BufView w(w_obj, PyBUF_C_CONTIGUOUS), d(data_obj, PyBUF_WRITABLE),
        ls(ls_obj, PyBUF_WRITABLE), lm(lm_obj, PyBUF_WRITABLE),
        ds(ds_obj, PyBUF_WRITABLE), ms(ms_obj, PyBUF_WRITABLE);
    if (!w.ok || !d.ok || !ls.ok || !lm.ok || !ds.ok || !ms.ok) return nullptr;
    Py_BEGIN_ALLOW_THREADS
    q4_k(static_cast<const float*>(w.view.buf), k, n,
         static_cast<uint8_t*>(d.view.buf),
         static_cast<uint8_t*>(ls.view.buf), static_cast<uint8_t*>(lm.view.buf),
         static_cast<uint16_t*>(ds.view.buf), static_cast<uint16_t*>(ms.view.buf));
    Py_END_ALLOW_THREADS
    Py_RETURN_NONE;
}

static PyObject* py_quantize_q6_k(PyObject*, PyObject* args) {
    PyObject *w_obj, *data_obj, *hi_obj, *ls_obj, *ds_obj;
    Py_ssize_t k, n;
    if (!PyArg_ParseTuple(args, "OnnOOOO", &w_obj, &k, &n, &data_obj, &hi_obj,
                          &ls_obj, &ds_obj)) return nullptr;
    BufView w(w_obj, PyBUF_C_CONTIGUOUS), d(data_obj, PyBUF_WRITABLE),
        hi(hi_obj, PyBUF_WRITABLE), ls(ls_obj, PyBUF_WRITABLE),
        ds(ds_obj, PyBUF_WRITABLE);
    if (!w.ok || !d.ok || !hi.ok || !ls.ok || !ds.ok) return nullptr;
    Py_BEGIN_ALLOW_THREADS
    q6_k(static_cast<const float*>(w.view.buf), k, n,
         static_cast<uint8_t*>(d.view.buf), static_cast<uint8_t*>(hi.view.buf),
         static_cast<int8_t*>(ls.view.buf), static_cast<uint16_t*>(ds.view.buf));
    Py_END_ALLOW_THREADS
    Py_RETURN_NONE;
}

static PyObject* py_bf16_from_f32(PyObject*, PyObject* args) {
    PyObject *src_obj, *dst_obj;
    Py_ssize_t count;
    if (!PyArg_ParseTuple(args, "OOn", &src_obj, &dst_obj, &count)) return nullptr;
    BufView src(src_obj, PyBUF_C_CONTIGUOUS), dst(dst_obj, PyBUF_WRITABLE);
    if (!src.ok || !dst.ok) return nullptr;
    Py_BEGIN_ALLOW_THREADS
    bf16_from_f32(static_cast<const float*>(src.view.buf),
                  static_cast<uint16_t*>(dst.view.buf), count);
    Py_END_ALLOW_THREADS
    Py_RETURN_NONE;
}

static PyMethodDef methods[] = {
    {"quantize_q8_0", py_quantize_q8_0, METH_VARARGS, "q8_0(w_f32, K, N, data_i8, scales_u16)"},
    {"quantize_q4_0", py_quantize_q4_0, METH_VARARGS, "q4_0(w_f32, K, N, packed_u8, scales_u16)"},
    {"quantize_q4_k", py_quantize_q4_k, METH_VARARGS,
     "q4_k(w_f32, K, N, packed_u8, ls_u8, lm_u8, dsup_u16, msup_u16)"},
    {"quantize_q6_k", py_quantize_q6_k, METH_VARARGS,
     "q6_k(w_f32, K, N, packed_u8, hi_u8, ls_i8, dsup_u16)"},
    {"bf16_from_f32", py_bf16_from_f32, METH_VARARGS, "bf16_from_f32(src_f32, dst_u16, count)"},
    {nullptr, nullptr, 0, nullptr},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_quant_native",
    "Native block quantizers of the checkpoint converter", -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__quant_native(void) { return PyModule_Create(&moduledef); }
