// lutvq_pack: native host-side data-layout kernels for checkpoint loading,
// the PyTorch port's copy of the JAX package's csrc/lutvq_pack.cpp.
//
// The host work of loading a checkpoint: code packing and layout
// transformation (the role of faiss-simd/pq4_fast_scan.cpp's
// pq4_pack_codes/pq4_pack_LUT and bs_lut_gemm's interleaved stores) and
// load-time dequantization (the role of aqlm's _dequantize_weight in
// benchmark_rq_gemm_cpu.py:128-130).  Called from Python via ctypes
// (tpu_lutvq_torch/utils/native.py); every entry point has a NumPy branch
// there with the same results bit for bit.
//
// Built on first use by tpu_lutvq_torch/utils/native.py with
// g++ -O3 -fPIC -shared -std=c++17 (-fopenmp where the compiler takes it)
// into build/native/ at the checkout root.

#include <cstdint>
#include <cstring>

extern "C" {

// Pack pairs of 4-bit codes into bytes: out[i] = lo[2i] | hi[2i+1]<<4.
// (T-MAC storage layout; reference vq.py:62, lut_ctor.cc interleaved stores.)
void lutvq_pack_nibbles(const uint8_t* in, uint8_t* out, int64_t n_pairs) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n_pairs; ++i) {
    out[i] = (uint8_t)((in[2 * i] & 0xF) | ((in[2 * i + 1] & 0xF) << 4));
  }
}

void lutvq_unpack_nibbles(const uint8_t* in, uint8_t* out, int64_t n_bytes) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n_bytes; ++i) {
    out[2 * i] = in[i] & 0xF;
    out[2 * i + 1] = in[i] >> 4;
  }
}

// Cache-blocked uint8 transpose: in (rows, cols) -> out (cols, rows).
// Used to produce the kernel-facing (G, d_out) codes_t layout from the
// checkpoint's (d_out, G) order at load time.
void lutvq_transpose_u8(const uint8_t* in, uint8_t* out, int64_t rows,
                        int64_t cols) {
  const int64_t B = 64;
#pragma omp parallel for collapse(2) schedule(static)
  for (int64_t rb = 0; rb < rows; rb += B) {
    for (int64_t cb = 0; cb < cols; cb += B) {
      int64_t rmax = rb + B < rows ? rb + B : rows;
      int64_t cmax = cb + B < cols ? cb + B : cols;
      for (int64_t r = rb; r < rmax; ++r) {
        for (int64_t c = cb; c < cmax; ++c) {
          out[c * rows + r] = in[r * cols + c];
        }
      }
    }
  }
}

// Load-time dequantization of additive-VQ weights (the 1x16 path):
//   w[o, m*g + j] = scale[o] * sum_n codebook[n, codes[o, m, n], j]
// codes are the *unsigned* values (caller bitcasts int16 -> uint16).
// codebook: (n_cb, K, g) float32; codes: (d_out, m_groups, n_cb) int32.
void lutvq_dequant_additive(const int32_t* codes, const float* codebook,
                            const float* scales, float* out, int64_t d_out,
                            int64_t m_groups, int64_t n_cb, int64_t K,
                            int64_t g) {
#pragma omp parallel for schedule(static)
  for (int64_t o = 0; o < d_out; ++o) {
    const float s = scales ? scales[o] : 1.0f;
    float* wrow = out + o * m_groups * g;
    for (int64_t m = 0; m < m_groups; ++m) {
      float acc[64];  // g <= 64 in all supported schemes
      for (int64_t j = 0; j < g; ++j) acc[j] = 0.0f;
      for (int64_t n = 0; n < n_cb; ++n) {
        const int64_t c = (int64_t)codes[(o * m_groups + m) * n_cb + n];
        const float* entry = codebook + (n * K + c) * g;
        for (int64_t j = 0; j < g; ++j) acc[j] += entry[j];
      }
      for (int64_t j = 0; j < g; ++j) wrow[m * g + j] = acc[j] * s;
    }
  }
}

// Column-parallel shard re-pack (kernels/lut_gemv.py repack_column_parallel):
// split (rows, d_out) into `shards` chunks of `local` columns, pad each to
// `local_pad` with `fill`, concatenate along columns.
void lutvq_shard_repack_u8(const uint8_t* in, uint8_t* out, int64_t rows,
                           int64_t local, int64_t local_pad, int64_t shards,
                           uint8_t fill) {
  const int64_t in_cols = local * shards;
  const int64_t out_cols = local_pad * shards;
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < rows; ++r) {
    const uint8_t* irow = in + r * in_cols;
    uint8_t* orow = out + r * out_cols;
    for (int64_t s = 0; s < shards; ++s) {
      memcpy(orow + s * local_pad, irow + s * local, (size_t)local);
      memset(orow + s * local_pad + local, fill, (size_t)(local_pad - local));
    }
  }
}

int lutvq_abi_version() { return 1; }

}  // extern "C"
