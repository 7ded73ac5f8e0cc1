// Fused dequant-matmul for AQLM 2x8 (bf16 codebooks) on Hopper (sm_90a).
//
// Replaces tpu_lutvq/kernels/dequant_mm.py::_dequant_mm_bf16x2_kernel and
// its VMEM-split twin ::_dequant_mm_bf16x2_kernel_v3.  Both compute
//     Y[r, j] = s[j] * sum_{n, m, w} bf16(x[r, m*d + w]) * bf16(cb[m, n, code(j, n*M+m), w])
// with f32 accumulation.  The codebook sum over n is NOT rounded to bf16:
// the reference contracts each bf16 codebook entry against x duplicated per
// codebook (dequant_mm.py:264-277, 726-734).  Here each codebook n gets its
// own bf16 weight tile and the same x tile is multiplied against each, which
// is that contraction with the duplication done by reuse, not by copying x.
// The TPU's v2/v3 split exists only for its 16 MiB scoped VMEM; a Hopper
// block walks d_in in a loop and needs one kernel.
//
// What bounds it on the H100: at prefill widths (256+ rows) the tensor-core
// work, 2 * N * rows * d_in * d_out flops; the codes (G * d_out bytes) and x
// are read once per tile.  Dense W never touches HBM: each block rebuilds a
// (64 cols x 32 inputs) bf16 tile per codebook in shared memory from the
// uint8 codes and 16-byte codebook rows (d_subvec = 8 bf16), then runs
// mma.sync m16n8k16 (bf16 in, f32 accumulate).  Four warps, 64x64 output
// tile, no software pipelining yet: wgmma/TMA and a multi-stage ring are
// work for later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;                 // rows per block
constexpr int kBN = 64;                 // output columns per block
constexpr int kSub = 8;                 // d_subvec (bf16 per codebook row)
constexpr int kMSub = 4;                // subvectors per k-step
constexpr int kBK = kMSub * kSub;       // 32 inputs per k-step
constexpr int kLds = kBK + 8;           // padded smem row: conflict-free frags
constexpr int kNMax = 2;                // codebooks per subvector
constexpr int kThreads = 128;

// bf16 values travel as their 16-bit patterns (uint16_t): mma.sync reads
// them from 32-bit registers, nothing here does bf16 arithmetic.
__device__ __forceinline__ uint32_t ld_pair(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x:      (R, d_in) bf16, d_in = M * 8
// codes:  (G_pad, d_out_pad) uint8, row g = n*M + m
// cb:     (M_cb, N, K, 8) bf16; cb_m_stride = N*K*8 (per-subvector) or 0 (shared)
// scales: (d_out_pad,) f32 or null
// out:    (R, d_out) f32
__global__ void __launch_bounds__(kThreads)
dequant_mm_bf16x2(const uint16_t* __restrict__ x, const uint8_t* __restrict__ codes,
                  const uint16_t* __restrict__ cb, const float* __restrict__ scales,
                  float* __restrict__ out, int R, int M, int N, int K, long cb_m_stride,
                  int d_out, int d_out_pad) {
  __shared__ __align__(16) uint16_t xs[kBM][kLds];
  __shared__ __align__(16) uint16_t ws[kNMax][kBN][kLds];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;      // 2x2 warps, 32x32 each
  const int gid = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  const int d_in = M * kSub;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int m0 = 0; m0 < M; m0 += kMSub) {
    // x tile: kBM rows x kMSub subvectors, 16 bytes each
    for (int i = tid; i < kBM * kMSub; i += kThreads) {
      const int r = i / kMSub, ms = i - r * kMSub;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < R && m0 + ms < M)
        v = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(row0 + r) * d_in +
                                            (m0 + ms) * kSub);
      *reinterpret_cast<uint4*>(&xs[r][ms * kSub]) = v;
    }
    // weight tiles: column fastest, so a warp reads contiguous code bytes
    for (int i = tid; i < kNMax * kMSub * kBN; i += kThreads) {
      const int n = i / (kMSub * kBN);
      const int rem = i - n * (kMSub * kBN);
      const int ms = rem / kBN, j = rem - ms * kBN;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n < N && m0 + ms < M && col0 + j < d_out_pad) {
        const int g = n * M + m0 + ms;
        const int code = codes[static_cast<size_t>(g) * d_out_pad + col0 + j];
        v = *reinterpret_cast<const uint4*>(
            cb + (m0 + ms) * cb_m_stride + (static_cast<long>(n) * K + code) * kSub);
      }
      *reinterpret_cast<uint4*>(&ws[n][j][ms * kSub]) = v;
    }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < kNMax; ++n) {
      if (n >= N) break;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        uint32_t a[2][4], b[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int r = wm * 32 + mt * 16 + gid;
          a[mt][0] = ld_pair(&xs[r][kk + tig * 2]);
          a[mt][1] = ld_pair(&xs[r + 8][kk + tig * 2]);
          a[mt][2] = ld_pair(&xs[r][kk + tig * 2 + 8]);
          a[mt][3] = ld_pair(&xs[r + 8][kk + tig * 2 + 8]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int c = wn * 32 + nt * 8 + gid;
          b[nt][0] = ld_pair(&ws[n][c][kk + tig * 2]);
          b[nt][1] = ld_pair(&ws[n][c][kk + tig * 2 + 8]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + wm * 32 + mt * 16 + gid + (e >> 1) * 8;
        const int c = col0 + wn * 32 + nt * 8 + tig * 2 + (e & 1);
        if (r < R && c < d_out) {
          float v = acc[mt][nt][e];
          if (scales != nullptr) v *= scales[c];
          out[static_cast<size_t>(r) * d_out + c] = v;
        }
      }
}

}  // namespace

extern "C" int lutvq_dequant_mm(const void* x, const void* codes, const void* cb,
                                const void* scales, void* out, int R, int M, int N, int K,
                                int cb_shared, int d_out, int d_out_pad, void* stream_ptr) {
  if (N < 1 || N > kNMax) return static_cast<int>(cudaErrorInvalidValue);
  const long cb_m_stride = cb_shared ? 0L : static_cast<long>(N) * K * kSub;
  dim3 grid((d_out + kBN - 1) / kBN, (R + kBM - 1) / kBM);
  dequant_mm_bf16x2<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint8_t*>(codes),
      static_cast<const uint16_t*>(cb), static_cast<const float*>(scales),
      static_cast<float*>(out), R, M, N, K, cb_m_stride, d_out, d_out_pad);
  return static_cast<int>(cudaGetLastError());
}
