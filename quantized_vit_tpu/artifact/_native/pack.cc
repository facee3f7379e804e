// Host-side int4 packing/unpacking for the artifact pipeline.
//
// The reference's host-side native work is the SIMD nibble-packing its
// Python emits as C++ HLS text (qnn_mem_process.py:11-24 array_to_string:
// w_bit values packed LSB-first, two's-complement, into wide words). Here
// the packing is a real compiled routine: signed int4 levels two-per-byte
// along the K axis, the exact layout quant/packing.py defines and the
// serving forward unpacks:
//
//   dst[i, j] = (src[i, j] & 0xF) | (src[i + K/2, j] << 4),  i < K/2
//
// Pairing row i with row i+K/2 (not i with i+1) lets the kernel split its
// K-contraction into two contiguous halves — no interleave in the inner
// loop. Build: g++ -O3 -march=native -shared -fPIC -fopenmp pack.cc.

#include <cstdint>
#include <cstring>

extern "C" {

// src: [k, n] row-major signed int8 holding int4-range levels (-8..7).
// dst: [k/2, n] row-major packed. k must be even.
void qvt_pack_int4(const int8_t* src, int64_t k, int64_t n, int8_t* dst) {
  const int64_t kh = k / 2;
  const int8_t* lo_rows = src;
  const int8_t* hi_rows = src + kh * n;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < kh; ++i) {
    const int8_t* lo = lo_rows + i * n;
    const int8_t* hi = hi_rows + i * n;
    int8_t* out = dst + i * n;
    for (int64_t j = 0; j < n; ++j) {
      out[j] = (int8_t)((lo[j] & 0xF) | ((hi[j] & 0xF) << 4));
    }
  }
}

// src: [kh, n] packed; dst: [2*kh, n] sign-extended int8 levels.
void qvt_unpack_int4(const int8_t* src, int64_t kh, int64_t n, int8_t* dst) {
  int8_t* lo_rows = dst;
  int8_t* hi_rows = dst + kh * n;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < kh; ++i) {
    const int8_t* in = src + i * n;
    int8_t* lo = lo_rows + i * n;
    int8_t* hi = hi_rows + i * n;
    for (int64_t j = 0; j < n; ++j) {
      // sign-extend low nibble via shift pair; arithmetic >> on int8
      lo[j] = (int8_t)((int8_t)(in[j] << 4) >> 4);
      hi[j] = (int8_t)(in[j] >> 4);
    }
  }
}

// Round-to-nearest-even quantization of float32 weights to int levels with
// per-column scale: dst[i,j] = clip(round(src[i,j] / scale[j]), lo, hi).
// The hot host loop when exporting an 86M-param checkpoint.
void qvt_quantize_levels(const float* src, const float* scale, int64_t k,
                         int64_t n, int lo, int hi, int8_t* dst) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < k; ++i) {
    const float* row = src + i * n;
    int8_t* out = dst + i * n;
    for (int64_t j = 0; j < n; ++j) {
      float v = row[j] / scale[j];
      // round half away from zero, matching numpy/jax rint closely enough
      // for quantizer grids (exact ties are measure-zero for trained w)
      int q = (int)(v >= 0.0f ? v + 0.5f : v - 0.5f);
      if (q < lo) q = lo;
      if (q > hi) q = hi;
      out[j] = (int8_t)q;
    }
  }
}

}  // extern "C"
