// f32-table dequant-matmul (the oracle tier) on Hopper (sm_90a).
//
// Replaces tpu_lutvq/kernels/dequant_mm.py::_dequant_mm_kernel and its
// VMEM-split twin ::_dequant_mm_kernel_v3.  Both compute
//     W[j, m*D + w] = sum_n cb[m, n, code(n*M+m, j), w]      (f32, n in order)
//     Y[r, j] = s[j] * sum_c x[r, c] * W[j, c]                (f32)
// with no rounding below f32: this is the tier other precisions are held
// to, and the only one for odd d_subvec.  So the contraction is f32 FMA
// on the CUDA cores; the tensor cores would take TF32 (about three decimal
// digits).  Any D (odd included), any N, K <= 256.  The v2/v3 split exists
// only for the TPU's 16 MiB VMEM; a Hopper block walks d_in in a loop.
//
// What bounds it on the H100: from ~16 rows up the f32 work, 2 * R * d_in *
// d_out operations at 67 TFLOP/s; at decode widths the uint8 codes.  Each
// block owns a 64x64 output tile (256 threads, 4x4 outputs each, strided
// so shared-memory reads broadcast or run contiguous) and per 16-input step
// rebuilds its (16 x 64) f32 weight tile from the codes and codebook rows
// (N code and N table reads per weight, no software pipelining yet).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;         // rows per block
constexpr int kBN = 64;         // output columns per block
constexpr int kBK = 16;         // inputs per k-step
constexpr int kThreads = 256;   // 16 x 16, 4 x 4 outputs each
constexpr int kPad = 4;

// x:      (R, d_in) f32, d_in = M * D
// codes:  (G_pad, d_out_pad) uint8, row g = n*M + m
// cb:     (M_cb, N, K, D) f32; cb_m_stride = N*K*D (per-subvector) or 0 (shared)
// scales: (d_out_pad,) f32 or null
// out:    (R, d_out) f32
__global__ void __launch_bounds__(kThreads)
dequant_mm_f32(const float* __restrict__ x, const uint8_t* __restrict__ codes,
               const float* __restrict__ cb, const float* __restrict__ scales,
               float* __restrict__ out, int R, int M, int N, int K, int D,
               long cb_m_stride, int d_out, int d_out_pad) {
  __shared__ float xt[kBK][kBM + kPad];
  __shared__ float wt[kBK][kBN + kPad];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  const int d_in = M * D;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d_in; k0 += kBK) {
    // x tile, stored transposed: (input, row)
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, kk = i - r * kBK;
      const int c = k0 + kk;
      xt[kk][r] = (row0 + r < R && c < d_in) ? x[static_cast<size_t>(row0 + r) * d_in + c]
                                             : 0.f;
    }
    // weight tile: (input, column), column fastest so a warp reads
    // contiguous code bytes; the codebook sum starts from n = 0
    for (int i = tid; i < kBN * kBK; i += kThreads) {
      const int kk = i / kBN, j = i - kk * kBN;
      const int c = k0 + kk;
      float v = 0.f;
      if (c < d_in && col0 + j < d_out_pad) {
        const int m = c / D, w = c - m * D;
        const float* row = cb + m * cb_m_stride + w;
        const uint8_t* code = codes + static_cast<size_t>(m) * d_out_pad + col0 + j;
        const size_t n_stride = static_cast<size_t>(M) * d_out_pad;
        v = row[static_cast<long>(code[0]) * D];
        for (int n = 1; n < N; ++n)
          v = v + row[(static_cast<long>(n) * K + code[n * n_stride]) * D];
      }
      wt[kk][j] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xt[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = wt[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = row0 + ty + 16 * i, c = col0 + tx + 16 * j;
      if (r < R && c < d_out) {
        float v = acc[i][j];
        if (scales != nullptr) v = v * scales[c];
        out[static_cast<size_t>(r) * d_out + c] = v;
      }
    }
}

}  // namespace

extern "C" int lutvq_dequant_mm_f32(const void* x, const void* codes, const void* cb,
                                    const void* scales, void* out, int R, int M, int N,
                                    int K, int D, int cb_shared, int d_out, int d_out_pad,
                                    void* stream_ptr) {
  if (N < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long cb_m_stride = cb_shared ? 0L : static_cast<long>(N) * K * D;
  dim3 grid((d_out + kBN - 1) / kBN, (R + kBM - 1) / kBM);
  dequant_mm_f32<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(cb), static_cast<const float*>(scales),
      static_cast<float*>(out), R, M, N, K, D, cb_m_stride, d_out, d_out_pad);
  return static_cast<int>(cudaGetLastError());
}
