// LUT-VQ lookup-accumulate GEMV for Hopper (sm_90a).
//
// Replaces tpu_lutvq/kernels/lut_gemv.py::_gemv_kernel_pair (B = 1),
// ::_gemv_kernel_bpair (B >= 2) and ::_gemv_kernel_pair_fused ("pairf",
// B = 1).  All compute
//     y[b, j] = s[j] * sum_g bf16(lut[b, g, codes_t[g, j]])     (f32 sum)
// and differ only in how the TPU packs bf16 entries into 32-bit words for
// its 128-lane gather (pairf packs them inside the kernel).  Hopper gathers
// from shared memory at any width, so one kernel, templated on the padded
// token count BP in {1, 2, 4, 8}, serves every batch from 1 to 8.  For
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
//   - a block stages its G-slice of the table in shared memory, laid out
//     (g, k, token) so one 2..16-byte load fetches the entry for all BP
//     tokens at once (what the TPU's token-pair words do for two tokens);
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

// Adds the BP bf16 entries at p (one per token) to acc.
template <int BP>
__device__ __forceinline__ void add_entries(float (&acc)[BP], const uint16_t* p) {
  if constexpr (BP == 1) {
    acc[0] += __uint_as_float(static_cast<uint32_t>(p[0]) << 16);
  } else {
    constexpr int kWords = BP / 2;
    uint32_t w[kWords];
    if constexpr (kWords == 1) {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else if constexpr (kWords == 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x; w[1] = v.y;
    } else {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      acc[2 * i] += __uint_as_float(w[i] << 16);            // lower address
      acc[2 * i + 1] += __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// lut:     (G, KP, BP) token fastest: bf16 bits (Entry = uint16_t) or f32
//          (Entry = float, rounded to bf16 as it is staged)
// codes:   (G_pad, d_out_pad) uint8, n-major groups
// partial: (n_splits, BP, d_out_pad) f32
template <int BP, typename Entry>
__global__ void __launch_bounds__(kThreads)
lut_gemv_partial(const Entry* __restrict__ lut, const uint8_t* __restrict__ codes,
                 float* __restrict__ partial, int G, int KP, int d_out_pad,
                 int g_per_split) {
  __shared__ __align__(16) uint16_t tab[kStageBytes / 2];
  const int row_elems = KP * BP;                    // one group's table
  const int stage_groups = kStageBytes / (2 * row_elems);
  const int col0 = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  const bool active = col0 < d_out_pad;
  const int g_begin = blockIdx.y * g_per_split;
  const int g_end = min(G, g_begin + g_per_split);

  float acc[kCols][BP];
#pragma unroll
  for (int c = 0; c < kCols; ++c)
#pragma unroll
    for (int b = 0; b < BP; ++b) acc[c][b] = 0.f;

  for (int s0 = g_begin; s0 < g_end; s0 += stage_groups) {
    const int ng = min(stage_groups, g_end - s0);
    if constexpr (sizeof(Entry) == 4) {
      const float4* src =
          reinterpret_cast<const float4*>(lut + static_cast<size_t>(s0) * row_elems);
      uint2* dst = reinterpret_cast<uint2*>(tab);
      const int n4 = ng * row_elems / 4;            // 4 f32 in, 4 bf16 out
      for (int i = threadIdx.x; i < n4; i += kThreads) {
        const float4 v = src[i];
        dst[i] = make_uint2(bf16_pair(v.x, v.y), bf16_pair(v.z, v.w));
      }
    } else {
      const uint4* src =
          reinterpret_cast<const uint4*>(lut + static_cast<size_t>(s0) * row_elems);
      uint4* dst = reinterpret_cast<uint4*>(tab);
      const int n16 = ng * row_elems / 8;           // 8 bf16 per 16 bytes
      for (int i = threadIdx.x; i < n16; i += kThreads) dst[i] = src[i];
    }
    __syncthreads();
    if (active) {
      const uint8_t* crow = codes + static_cast<size_t>(s0) * d_out_pad + col0;
      for (int gi = 0; gi < ng; ++gi) {
        const uint32_t c4 = *reinterpret_cast<const uint32_t*>(crow);
        crow += d_out_pad;
        const uint16_t* row = tab + gi * row_elems;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          add_entries<BP>(acc[c], row + ((c4 >> (8 * c)) & 0xffu) * BP);
        }
      }
    }
    __syncthreads();
  }
  if (active) {
#pragma unroll
    for (int b = 0; b < BP; ++b) {
      float4 v = make_float4(acc[0][b], acc[1][b], acc[2][b], acc[3][b]);
      *reinterpret_cast<float4*>(
          partial + (static_cast<size_t>(blockIdx.y) * BP + b) * d_out_pad + col0) = v;
    }
  }
}

// out[b, j] = scale[j] * sum_split partial[split, b, j], splits in order.
__global__ void lut_gemv_reduce(const float* __restrict__ partial,
                                const float* __restrict__ scales,
                                float* __restrict__ out, int B, int BP,
                                int n_splits, int d_out, int d_out_pad) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * d_out) return;
  const int b = idx / d_out;
  const int j = idx - b * d_out;
  float s = 0.f;
  for (int sp = 0; sp < n_splits; ++sp)
    s += partial[(static_cast<size_t>(sp) * BP + b) * d_out_pad + j];
  if (scales != nullptr) s *= scales[j];
  out[idx] = s;
}

template <int BP, typename Entry = uint16_t>
void launch_partial(const void* lut, const void* codes, void* ws, int G, int KP,
                    int d_out_pad, int g_per_split, int n_splits, cudaStream_t stream) {
  dim3 grid((d_out_pad + kTileCols - 1) / kTileCols, n_splits);
  lut_gemv_partial<BP, Entry><<<grid, kThreads, 0, stream>>>(
      static_cast<const Entry*>(lut), static_cast<const uint8_t*>(codes),
      static_cast<float*>(ws), G, KP, d_out_pad, g_per_split);
}

}  // namespace

// f32_entries: the table is f32 (pairf, BP = 1 only), else bf16
extern "C" int lutvq_lut_gemv(const void* lut, const void* codes, const void* scales,
                              void* ws, void* out, int B, int BP, int G, int KP,
                              int d_out, int d_out_pad, int g_per_split, int n_splits,
                              int f32_entries, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (f32_entries && BP != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (f32_entries ? 0 : BP) {
    case 0: launch_partial<1, float>(lut, codes, ws, G, KP, d_out_pad, g_per_split, n_splits, stream); break;
    case 1: launch_partial<1>(lut, codes, ws, G, KP, d_out_pad, g_per_split, n_splits, stream); break;
    case 2: launch_partial<2>(lut, codes, ws, G, KP, d_out_pad, g_per_split, n_splits, stream); break;
    case 4: launch_partial<4>(lut, codes, ws, G, KP, d_out_pad, g_per_split, n_splits, stream); break;
    case 8: launch_partial<8>(lut, codes, ws, G, KP, d_out_pad, g_per_split, n_splits, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = B * d_out;
  lut_gemv_reduce<<<(n + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const float*>(scales),
      static_cast<float*>(out), B, BP, n_splits, d_out, d_out_pad);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lutvq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
