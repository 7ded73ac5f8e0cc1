// LUT-VQ lookup-accumulate GEMV for Hopper (sm_90a).
//
// Replaces tpu_lutvq/kernels/lut_gemv.py::_gemv_kernel_pair and
// ::_gemv_kernel_pair_fused ("pairf"), both at one token.  Both compute
//     y[j] = s[j] * sum_g bf16(lut[g, codes_t[g, j]])     (f32 sum)
// and differ only in how the TPU packs bf16 entries into 32-bit words for
// its 128-lane gather (pairf packs them inside the kernel; the B >= 2
// lookups, ::_gemv_kernel_bpair, are lut_bpair.cu's).  For
// pairf it reads the f32 table and rounds each entry to bf16 (round to
// nearest even, as torch's cast) while staging it in shared memory: the
// wrapper's separate cast pass and its bf16 copy in HBM go, and the
// staged table, the inner loop and the split order stay A's, so pairf
// gives A's output bit for bit.
//
// What bounds it on the H100: the uint8 codes, streamed once from HBM
// (G * d_out bytes: 4 MiB for a 4096x4096 layer, 11 MiB for 4096->11008).
// The LUT is small per group but too large per token to sit in one block's
// shared memory (G * 256 * 2 B = 512 KiB at d_in = 4096, 1.4 MiB at 11008),
// so the design splits G across blocks:
//   - grid (column tiles of 512, G splits); 128 threads, 4 columns each, so
//     one warp reads 128 contiguous code bytes per group;
//   - a block stages its G-slice of the table in shared memory;
//   - each split writes f32 partial sums to a workspace and a second kernel
//     adds the splits in a fixed order and applies the scale, so the result
//     is deterministic (no atomics).
// Left for later: double-buffered staging, wider column tiles at large d_out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 4;                         // output columns per thread
constexpr int kTileCols = kThreads * kCols;      // 512 columns per block
constexpr int kStageBytes = 32 * 1024;           // staged table per round

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// lut:     (G, KP) bf16 bits (Entry = uint16_t) or f32 (Entry = float,
//          rounded to bf16 as it is staged)
// codes:   (G_pad, d_out_pad) uint8, n-major groups
// partial: (n_splits, d_out_pad) f32
template <typename Entry>
__global__ void __launch_bounds__(kThreads)
lut_gemv_partial(const Entry* __restrict__ lut, const uint8_t* __restrict__ codes,
                 float* __restrict__ partial, int G, int KP, int d_out_pad,
                 int g_per_split) {
  __shared__ __align__(16) uint16_t tab[kStageBytes / 2];
  const int stage_groups = kStageBytes / (2 * KP);
  const int col0 = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  const bool active = col0 < d_out_pad;
  const int g_begin = blockIdx.y * g_per_split;
  const int g_end = min(G, g_begin + g_per_split);

  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;

  for (int s0 = g_begin; s0 < g_end; s0 += stage_groups) {
    const int ng = min(stage_groups, g_end - s0);
    if constexpr (sizeof(Entry) == 4) {
      const float4* src = reinterpret_cast<const float4*>(lut + static_cast<size_t>(s0) * KP);
      uint2* dst = reinterpret_cast<uint2*>(tab);
      const int n4 = ng * KP / 4;                   // 4 f32 in, 4 bf16 out
      for (int i = threadIdx.x; i < n4; i += kThreads) {
        const float4 v = src[i];
        dst[i] = make_uint2(bf16_pair(v.x, v.y), bf16_pair(v.z, v.w));
      }
    } else {
      const uint4* src = reinterpret_cast<const uint4*>(lut + static_cast<size_t>(s0) * KP);
      uint4* dst = reinterpret_cast<uint4*>(tab);
      const int n16 = ng * KP / 8;                  // 8 bf16 per 16 bytes
      for (int i = threadIdx.x; i < n16; i += kThreads) dst[i] = src[i];
    }
    __syncthreads();
    if (active) {
      const uint8_t* crow = codes + static_cast<size_t>(s0) * d_out_pad + col0;
      for (int gi = 0; gi < ng; ++gi) {
        const uint32_t c4 = *reinterpret_cast<const uint32_t*>(crow);
        crow += d_out_pad;
        const uint16_t* row = tab + gi * KP;
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[c] += __uint_as_float(static_cast<uint32_t>(row[(c4 >> (8 * c)) & 0xffu]) << 16);
      }
    }
    __syncthreads();
  }
  if (active)
    *reinterpret_cast<float4*>(partial + static_cast<size_t>(blockIdx.y) * d_out_pad + col0) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
}

// out[j] = scale[j] * sum_split partial[split, j], splits in order.
__global__ void lut_gemv_reduce(const float* __restrict__ partial,
                                const float* __restrict__ scales,
                                float* __restrict__ out, int n_splits, int d_out,
                                int d_out_pad) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= d_out) return;
  float s = 0.f;
  for (int sp = 0; sp < n_splits; ++sp) s += partial[static_cast<size_t>(sp) * d_out_pad + j];
  if (scales != nullptr) s *= scales[j];
  out[j] = s;
}

template <typename Entry>
void launch_partial(const void* lut, const void* codes, void* ws, int G, int KP,
                    int d_out_pad, int g_per_split, int n_splits, cudaStream_t stream) {
  dim3 grid((d_out_pad + kTileCols - 1) / kTileCols, n_splits);
  lut_gemv_partial<Entry><<<grid, kThreads, 0, stream>>>(
      static_cast<const Entry*>(lut), static_cast<const uint8_t*>(codes),
      static_cast<float*>(ws), G, KP, d_out_pad, g_per_split);
}

}  // namespace

// One token (B = BP = 1); f32_entries: the table is f32 (pairf), else bf16.
extern "C" int lutvq_lut_gemv(const void* lut, const void* codes, const void* scales,
                              void* ws, void* out, int B, int BP, int G, int KP,
                              int d_out, int d_out_pad, int g_per_split, int n_splits,
                              int f32_entries, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B != 1 || BP != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (f32_entries)
    launch_partial<float>(lut, codes, ws, G, KP, d_out_pad, g_per_split, n_splits, stream);
  else
    launch_partial<uint16_t>(lut, codes, ws, G, KP, d_out_pad, g_per_split, n_splits, stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  lut_gemv_reduce<<<(d_out + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const float*>(scales),
      static_cast<float*>(out), n_splits, d_out, d_out_pad);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lutvq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
