// Native marshaling kernels for polars-matmul-tpu.
//
// Analog of the reference's Rust host-side marshaling layer
// (reference src/matmul.rs:131-286): the compute path is JAX/XLA, but
// ragged Arrow List columns still need a host-side gather/pack into dense
// row-major matrices before device upload, and that pack is the hot host
// loop for List-typed inputs (the reference's List path is 2.4x slower than
// Array for exactly this reason, README.md:130-144).  Implemented in C++ and
// exposed via a small C ABI consumed with ctypes (no pybind11 dependency).
//
// Build: polars_matmul_tpu/interop/native.py compiles this file on first use
// (g++ -O3 -shared -fPIC, no -march) into build/native/, named by source
// hash and host architecture; `make native` does the same.
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Pack a ragged list column (flat values + offsets + optional row validity)
// into a dense row-major (n_rows, dim) matrix.  Null rows and missing tails
// become 0.0 (reference matmul.rs:251,280).  Returns 0 on success, -1 if a
// valid row has length != dim (dimension mismatch).
#define DEFINE_PACK(NAME, T)                                                 \
  int NAME(const T* values, const int64_t* offsets, const uint8_t* validity, \
           int64_t n_rows, int64_t dim, T* out) {                            \
    for (int64_t i = 0; i < n_rows; ++i) {                                   \
      T* dst = out + i * dim;                                                \
      if (validity && !(validity[i >> 3] & (1 << (i & 7)))) {                \
        std::memset(dst, 0, sizeof(T) * dim);                                \
        continue;                                                            \
      }                                                                      \
      int64_t s = offsets[i], e = offsets[i + 1];                            \
      if (e - s != dim) return -1;                                           \
      std::memcpy(dst, values + s, sizeof(T) * dim);                         \
    }                                                                        \
    return 0;                                                                \
  }

DEFINE_PACK(pmm_pack_list_f32, float)
DEFINE_PACK(pmm_pack_list_f64, double)

// Widen f16 (stored as raw uint16 IEEE half) to f32. The reference treats
// f16 as storage-only and casts up for compute (README.md:154-156).
void pmm_half_to_float(const uint16_t* src, float* dst, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    uint16_t h = src[i];
    uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
    uint32_t exp = (h >> 10) & 0x1F;
    uint32_t mant = h & 0x3FF;
    uint32_t bits;
    if (exp == 0) {
      if (mant == 0) {
        bits = sign;
      } else {  // subnormal: normalize
        int shift = 0;
        while (!(mant & 0x400)) { mant <<= 1; ++shift; }
        mant &= 0x3FF;
        bits = sign | ((uint32_t)(127 - 15 - shift) << 23) | (mant << 13);
      }
    } else if (exp == 31) {
      bits = sign | 0x7F800000u | (mant << 13);  // inf/nan
    } else {
      bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
    }
    std::memcpy(dst + i, &bits, 4);
  }
}

// Interleave top-k (n, k) index/score rows into pre-allocated flat Arrow
// child buffers, widening indices to u32 and scores to f64
// (reference matmul.rs:446-447,497-518 — but flat, no per-row allocation).
void pmm_assemble_topk(const int32_t* indices, const float* scores,
                       int64_t n, int64_t k, uint32_t* idx_out,
                       double* score_out) {
  for (int64_t i = 0; i < n * k; ++i) {
    idx_out[i] = (uint32_t)indices[i];
    score_out[i] = (double)scores[i];
  }
}

// Per-row symmetric int8 quantization, fused into one pass per row (the
// row stays in L1/L2 between the amax scan and the quantize scan).  The
// NumPy path makes three full-matrix passes plus two temporaries — at
// corpus-ingestion scale (10M x 768 = 30 GB) this loop is host-memory-
// bandwidth-bound, so pass count is the cost.  Semantics mirror
// api/search.py::_quantize_rows_np EXACTLY (division by the scale, then
// round-half-even like np.rint) so the two paths are interchangeable:
// mixed-path corpora stay bit-identical.
void pmm_quantize_i8(const float* values, int64_t n, int64_t dim,
                     int8_t* codes, float* scales) {
  for (int64_t i = 0; i < n; ++i) {
    const float* row = values + i * dim;
    float amax = 0.0f;
    for (int64_t j = 0; j < dim; ++j) {
      float a = std::fabs(row[j]);
      if (a > amax) amax = a;
    }
    const float s = amax > 0.0f ? amax / 127.0f : 1.0f;
    int8_t* dst = codes + i * dim;
    for (int64_t j = 0; j < dim; ++j) {
      dst[j] = (int8_t)std::nearbyintf(row[j] / s);
    }
    scales[i] = s;
  }
}

// Per-row symmetric int4 quantization, nibble-packed per K-chunk in one
// fused pass (layout contract: kernels/fused_topk.py::quantize_int4 —
// within each ck-wide chunk, byte j holds feature j in the low nibble
// and feature j+ck/2 in the high nibble; features past dim pack as 0).
// Semantics mirror api/search.py::_quantize_rows_int4_np exactly
// (divide, round-half-even, clip to ±7).
static inline int pmm_q4(const float* row, int64_t f, int64_t dim,
                         float s) {
  if (f >= dim) return 0;
  float v = std::nearbyintf(row[f] / s);
  if (v > 7.0f) v = 7.0f;
  if (v < -7.0f) v = -7.0f;
  return (int)v;
}

void pmm_quantize_i4(const float* values, int64_t n, int64_t dim,
                     int64_t ck, int64_t dpp, int8_t* packed,
                     float* scales) {
  const int64_t half = ck / 2, nchunks = dpp / ck, width = dpp / 2;
  for (int64_t i = 0; i < n; ++i) {
    const float* row = values + i * dim;
    float amax = 0.0f;
    for (int64_t j = 0; j < dim; ++j) {
      float a = std::fabs(row[j]);
      if (a > amax) amax = a;
    }
    const float s = amax > 0.0f ? amax / 7.0f : 1.0f;
    scales[i] = s;
    int8_t* dst = packed + i * width;
    for (int64_t c = 0; c < nchunks; ++c) {
      const int64_t f0 = c * ck;
      for (int64_t j = 0; j < half; ++j) {
        const int lo = pmm_q4(row, f0 + j, dim, s);
        const int hi = pmm_q4(row, f0 + half + j, dim, s);
        dst[c * half + j] = (int8_t)((lo & 0xF) | ((hi & 0xF) << 4));
      }
    }
  }
}

}  // extern "C"
