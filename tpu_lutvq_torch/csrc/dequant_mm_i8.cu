// W8A8 dequant-matmul (quality="fast") on Hopper (sm_90a).
//
// Replaces tpu_lutvq/kernels/dequant_mm.py::_dequant_mm_i8_kernel and its
// VMEM-split twin ::_dequant_mm_i8_kernel_v3.  With the codebook words
// quantized to int8 per (word, group) and those row scales folded into the
// per-token int8 activations (kernels/dequant_mm.py does both), it computes
//     acc[r, j] = sum_{n, m, w} x_i8[r, n, m, w] * q[m, n, code(n*M+m, j), w]
//     out[r, j] = float(acc) * xs[r] * s[j]
// The sum is exact in int32 (|acc| <= 127^2 * N * d_in = 3.6e8 at 7B
// w_down), so the kernel equals its plain version bit for bit in any
// order of addition.  It follows JAX's v2 kernel, one int32 sum and one
// cast; v3's f32 partials per quarter exist only for the TPU's 16 MiB VMEM.
// The TPU's quad words (four int8 weights in one 32-bit lane gather) are
// not carried over: Hopper reads a D-byte codebook row directly.
//
// What bounds it on the H100: at decode widths (8 rows) the uint8 codes,
// G * d_out bytes streamed once (4 MiB for a 4096x4096 layer); at prefill
// widths (256 rows) the int8 tensor-core work, 2 * R * N * d_in * d_out
// operations at 1,979 TOPS.  Dense W never touches HBM: each block rebuilds
// a (64 cols x 64 inputs) int8 tile per codebook in shared memory from the
// codes and the D-byte quantized codebook rows, then runs mma.sync
// m16n8k32 (s8 x s8 -> s32).  Four warps, 64x64 output tile, no software
// pipelining.  At decode widths one row tile leaves only d_out/64 blocks,
// each walking d_in with two dependent loads and a barrier a step, so d_in
// is split across blocks (grid z): split sums meet in an int32 workspace
// by atomicAdd, exact in any order, so the result stays deterministic and
// equal to the plain version; a second kernel casts and scales.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;          // rows per block
constexpr int kBN = 64;          // output columns per block
constexpr int kBK = 64;          // int8 inputs per codebook per k-step
constexpr int kLds = kBK + 16;   // padded smem row (80 bytes): conflict-free fragments
constexpr int kNMax = 2;         // codebooks per subvector
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copies one D-byte codebook row (or zeros, src == nullptr).
template <int D>
__device__ __forceinline__ void copy_row(int8_t* dst, const int8_t* src) {
  if constexpr (D == 4) {
    *reinterpret_cast<uint32_t*>(dst) = src ? *reinterpret_cast<const uint32_t*>(src) : 0u;
  } else if constexpr (D == 8) {
    *reinterpret_cast<uint2*>(dst) =
        src ? *reinterpret_cast<const uint2*>(src) : make_uint2(0u, 0u);
  } else {
    *reinterpret_cast<uint4*>(dst) =
        src ? *reinterpret_cast<const uint4*>(src) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// x:      (R, N, Mp, D) int8, Mp = M rounded up to kBK / D, zeros past M
// xs:     (R,) f32 per-token scales
// codes:  (G_pad, d_out_pad) uint8, row g = n*M + m
// q:      (M_q, N, K, D) int8; q_m_stride = N*K*D (per-subvector) or 0 (shared)
// scales: (d_out_pad,) f32 or null
// out:    (R, d_out) f32, written when gridDim.z == 1
// ws:     (R, d_out) int32, zeroed, summed into when d_in is split
// Split z walks subvectors [z * m_split, (z + 1) * m_split).
template <int D>
__global__ void __launch_bounds__(kThreads)
dequant_mm_i8(const int8_t* __restrict__ x, const float* __restrict__ xs,
              const uint8_t* __restrict__ codes, const int8_t* __restrict__ q,
              const float* __restrict__ scales, float* __restrict__ out,
              int* __restrict__ ws, int R, int M, int Mp, int N, int K, long q_m_stride,
              int d_out, int d_out_pad, int m_split) {
  constexpr int kMSub = kBK / D;  // subvectors per k-step
  __shared__ __align__(16) int8_t xt[kNMax][kBM][kLds];
  __shared__ __align__(16) int8_t wt[kNMax][kBN][kLds];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;  // 2x2 warps, 32x32 each
  const int gid = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  const long x_row = static_cast<long>(N) * Mp * D;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int m_end = min(M, static_cast<int>(blockIdx.z + 1) * m_split);
  for (int m0 = blockIdx.z * m_split; m0 < m_end; m0 += kMSub) {
    // x tiles: per (codebook, row), kBK contiguous bytes as 4 x 16
    for (int i = tid; i < kNMax * kBM * 4; i += kThreads) {
      const int n = i / (kBM * 4);
      const int rem = i - n * (kBM * 4);
      const int r = rem >> 2, c16 = rem & 3;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n < N && row0 + r < R)
        v = *reinterpret_cast<const uint4*>(
            x + (row0 + r) * x_row + (static_cast<long>(n) * Mp + m0) * D + c16 * 16);
      *reinterpret_cast<uint4*>(&xt[n][r][c16 * 16]) = v;
    }
    // weight tiles: column fastest, so a warp reads contiguous code bytes
    for (int i = tid; i < kNMax * kMSub * kBN; i += kThreads) {
      const int n = i / (kMSub * kBN);
      const int rem = i - n * (kMSub * kBN);
      const int ms = rem / kBN, j = rem - ms * kBN;
      const int8_t* src = nullptr;
      if (n < N && m0 + ms < m_end && col0 + j < d_out_pad) {
        const int code = codes[static_cast<size_t>(n * M + m0 + ms) * d_out_pad + col0 + j];
        src = q + (m0 + ms) * q_m_stride + (static_cast<long>(n) * K + code) * D;
      }
      copy_row<D>(&wt[n][j][ms * D], src);
    }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < kNMax; ++n) {
      if (n >= N) break;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 32) {
        uint32_t a[2][4], b[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int r = wm * 32 + mt * 16 + gid;
          a[mt][0] = ld32(&xt[n][r][kk + tig * 4]);
          a[mt][1] = ld32(&xt[n][r + 8][kk + tig * 4]);
          a[mt][2] = ld32(&xt[n][r][kk + 16 + tig * 4]);
          a[mt][3] = ld32(&xt[n][r + 8][kk + 16 + tig * 4]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int c = wn * 32 + nt * 8 + gid;
          b[nt][0] = ld32(&wt[n][c][kk + tig * 4]);
          b[nt][1] = ld32(&wt[n][c][kk + 16 + tig * 4]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt]);
      }
    }
    __syncthreads();
  }

  // float(acc) * xs[r], then * s[j]: the plain version's order
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + wm * 32 + mt * 16 + gid + (e >> 1) * 8;
        const int c = col0 + wn * 32 + nt * 8 + tig * 2 + (e & 1);
        if (r < R && c < d_out) {
          const size_t o = static_cast<size_t>(r) * d_out + c;
          if (gridDim.z > 1) {
            atomicAdd(ws + o, acc[mt][nt][e]);
          } else {
            float v = __int2float_rn(acc[mt][nt][e]) * xs[r];
            if (scales != nullptr) v = v * scales[c];
            out[o] = v;
          }
        }
      }
}

// out[r, j] = float(ws[r, j]) * xs[r] * s[j], after a split sum
__global__ void dequant_mm_i8_finish(const int* __restrict__ ws, const float* __restrict__ xs,
                                     const float* __restrict__ scales, float* __restrict__ out,
                                     int R, int d_out) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(R) * d_out) return;
  const int r = static_cast<int>(idx / d_out), c = static_cast<int>(idx - static_cast<size_t>(r) * d_out);
  float v = __int2float_rn(ws[idx]) * xs[r];
  if (scales != nullptr) v = v * scales[c];
  out[idx] = v;
}

template <int D>
void launch(const void* x, const void* xs, const void* codes, const void* q,
            const void* scales, void* out, void* ws, int R, int M, int Mp, int N, int K,
            long q_m_stride, int d_out, int d_out_pad, int m_split, int n_splits,
            cudaStream_t stream) {
  dim3 grid((d_out + kBN - 1) / kBN, (R + kBM - 1) / kBM, n_splits);
  dequant_mm_i8<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const float*>(xs),
      static_cast<const uint8_t*>(codes), static_cast<const int8_t*>(q),
      static_cast<const float*>(scales), static_cast<float*>(out), static_cast<int*>(ws),
      R, M, Mp, N, K, q_m_stride, d_out, d_out_pad, m_split);
}

}  // namespace

// m_split: subvectors per split of d_in, a multiple of the k-step (kBK / D);
// n_splits > 1 needs ws, (R, d_out) int32, which this call zeroes.
extern "C" int lutvq_dequant_mm_i8(const void* x, const void* xs, const void* codes,
                                   const void* q, const void* scales, void* out, void* ws,
                                   int R, int M, int Mp, int N, int K, int D, int q_shared,
                                   int d_out, int d_out_pad, int m_split, int n_splits,
                                   void* stream_ptr) {
  if ((D != 4 && D != 8 && D != 16) || N < 1 || N > kNMax || Mp % (kBK / D) != 0 ||
      Mp < M || m_split % (kBK / D) != 0 || n_splits < 1 ||
      static_cast<long>(m_split) * n_splits < M || (n_splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long q_m_stride = q_shared ? 0L : static_cast<long>(N) * K * D;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t n_out = static_cast<size_t>(R) * d_out;
  if (n_splits > 1) {
    cudaError_t err = cudaMemsetAsync(ws, 0, n_out * sizeof(int), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  switch (D) {
    case 4: launch<4>(x, xs, codes, q, scales, out, ws, R, M, Mp, N, K, q_m_stride, d_out, d_out_pad, m_split, n_splits, stream); break;
    case 8: launch<8>(x, xs, codes, q, scales, out, ws, R, M, Mp, N, K, q_m_stride, d_out, d_out_pad, m_split, n_splits, stream); break;
    case 16: launch<16>(x, xs, codes, q, scales, out, ws, R, M, Mp, N, K, q_m_stride, d_out, d_out_pad, m_split, n_splits, stream); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return static_cast<int>(err);
  dequant_mm_i8_finish<<<static_cast<unsigned>((n_out + 255) / 256), 256, 0, stream>>>(
      static_cast<const int*>(ws), static_cast<const float*>(xs),
      static_cast<const float*>(scales), static_cast<float*>(out), R, d_out);
  return static_cast<int>(cudaGetLastError());
}
