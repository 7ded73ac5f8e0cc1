// Lookup-accumulate over prebuilt f32, int8 or int16 tables for Hopper
// (sm_90a), over byte codes.
//
// Replaces three kernels of tpu_lutvq/kernels/lut_gemv.py, reached through
// _lut_gemv_packed (:689) with per-token tables:
//   ::_gemv_kernel     (:586)  f32 tables, f32 sum            (variant "f32")
//   ::_gemv_kernel_i8  (:487)  int8 tables, exact int32 sum   (variant "i8")
//   ::_gemv_kernel_i16 (:541)  int16 tables, exact int32 sum  (variant "i16")
// (nibble-packed codes, "nibbles" and "nibbles_bpair", have their own kernels
// in lut_nibbles.cu.)  All compute
//     y[b, j] = float(sum_g tab[b, g, codes_t[g, j]]) * s[j]
// and the wrapper multiplies the integer variants by each token's table
// scale afterwards, the JAX package's order (lut_gemv.py:522-526, 878-880).
// The TPU packs int8 entries four to a 32-bit gather word and int16 entries
// two to a word, low bytes offset-flipped so that both bytes sum on the int8
// MXU.  Hopper gathers from shared memory at any width, so one template over
// the entry type serves all three, and int16 entries are summed as they are:
// the int32 sums are exact, so the integer variants equal their plain
// versions bit for bit (and the JAX package's while |sum| < 2^24).
//
// What bounds it on the H100.  For an ANN scan (the n database codes are the
// output columns, G = M subquantizers, 8 queries a launch) it is the output
// write: (8, n) f32 is 32 MB at n = 1M against 16 MB of uint8 codes at PQ16,
// ~14 us at 3.35 TB/s.  The tables are small (G * K * 8 tokens: 128 KiB in
// f32 at G = 16, K = 256), so the design keeps them on chip and streams the
// codes once:
//   - a block stages its G-slice of the tables in dynamic shared memory, laid
//     out (g, k, token) so that one 1..32-byte load fetches the entry of all
//     BP tokens, and then walks column tiles of 1024 with a grid stride,
//     reusing the staged slice; only a slice above the stage budget is staged
//     again for each tile, in rounds;
//   - 256 threads, 4 columns each from one uint32 code load, so a warp reads
//     128 contiguous code bytes per group;
//   - G is split across blocks only when the column tiles alone do not fill
//     the SMs (a 4096-wide projection, G = 1024); each split then writes
//     partial sums (int32 for the integer variants, so they stay exact) to a
//     workspace that a second kernel adds in a fixed order.  With one split
//     the first kernel writes the result itself.
// Left for later: overlapping code loads with staging, and a table layout
// free of shared-memory bank conflicts for the 32-byte f32 entries.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;                       // output columns per thread
constexpr int kTileCols = kThreads * kCols;    // 1024 columns per tile

template <typename T> struct Acc { using type = int32_t; };
template <> struct Acc<float> { using type = float; };

template <typename A, typename T>
__device__ __forceinline__ A widen(T v) { return static_cast<A>(v); }

// N entries read by one aligned load of at most 16 bytes.
template <typename T, int N>
struct alignas(sizeof(T) * N) Entries { T v[N]; };

// Adds the BP entries of one (g, k), one per token, to acc: one load, or two
// 16-byte loads for eight f32 entries.
template <typename T, int BP>
__device__ __forceinline__ void add_entries(typename Acc<T>::type (&acc)[BP], const T* p) {
  constexpr int kPerLoad = sizeof(T) * BP > 16 ? 16 / static_cast<int>(sizeof(T)) : BP;
#pragma unroll
  for (int i = 0; i < BP; i += kPerLoad) {
    const Entries<T, kPerLoad> e = *reinterpret_cast<const Entries<T, kPerLoad>*>(p + i);
#pragma unroll
    for (int b = 0; b < kPerLoad; ++b)
      acc[i + b] += widen<typename Acc<T>::type>(e.v[b]);
  }
}

// tab:   (G, KP, BP) entries, token fastest
// codes: (G_pad, d_out_pad) uint8, n-major groups
// part:  (n_splits, BP, d_out_pad) partial sums, or null with one split
// out:   (B, d_out) f32, written here when part is null
template <typename T, int BP>
__global__ void __launch_bounds__(kThreads)
lut_scan_partial(const T* __restrict__ tab, const uint8_t* __restrict__ codes,
                 const float* __restrict__ scales, typename Acc<T>::type* __restrict__ part,
                 float* __restrict__ out, int B, int G, int KP, int d_out, int d_out_pad,
                 int g_per_split, int stage_groups) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(32) unsigned char smem[];
  const T* stage = reinterpret_cast<const T*>(smem);
  const int row_elems = KP * BP;                  // one group's tables
  const int g_begin = blockIdx.y * g_per_split;
  const int g_end = min(G, g_begin + g_per_split);
  const bool one_stage = g_end - g_begin <= stage_groups;
  const int n_tiles = (d_out_pad + kTileCols - 1) / kTileCols;
  bool staged = false;                            // uniform across the block

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int col0 = tile * kTileCols + threadIdx.x * kCols;
    const bool active = col0 < d_out_pad;         // d_out_pad % 128 == 0
    A acc[kCols][BP];
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
      for (int b = 0; b < BP; ++b) acc[c][b] = A(0);

    for (int s0 = g_begin; s0 < g_end; s0 += stage_groups) {
      const int ng = min(stage_groups, g_end - s0);
      if (!(one_stage && staged)) {
        __syncthreads();                          // earlier reads of the stage are done
        const uint4* src = reinterpret_cast<const uint4*>(tab + static_cast<size_t>(s0) * row_elems);
        uint4* dst = reinterpret_cast<uint4*>(smem);
        const int n16 = ng * row_elems * static_cast<int>(sizeof(T)) / 16;
        for (int i = threadIdx.x; i < n16; i += kThreads) dst[i] = src[i];
        __syncthreads();
        staged = true;
      }
      if (active) {
        const uint8_t* crow = codes + static_cast<size_t>(s0) * d_out_pad + col0;
        for (int gi = 0; gi < ng; ++gi) {
          const uint32_t c4 = __ldg(reinterpret_cast<const uint32_t*>(crow));
          crow += d_out_pad;
          const T* row = stage + gi * row_elems;
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const uint32_t code = (c4 >> (8 * c)) & 0xffu;
            add_entries<T, BP>(acc[c], row + code * BP);
          }
        }
      }
    }
    if (!active) continue;
    if (part == nullptr) {
      const bool vec = (d_out & 3) == 0 && col0 + kCols <= d_out;
#pragma unroll
      for (int b = 0; b < BP; ++b) {
        if (b >= B) break;                        // padded tokens
        float v[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          v[c] = static_cast<float>(acc[c][b]);
          if (scales != nullptr && col0 + c < d_out) v[c] *= scales[col0 + c];
        }
        float* o = out + static_cast<size_t>(b) * d_out + col0;
        if (vec) {
          *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            if (col0 + c < d_out) o[c] = v[c];
        }
      }
    } else {
#pragma unroll
      for (int b = 0; b < BP; ++b) {
        A* p = part + (static_cast<size_t>(blockIdx.y) * BP + b) * d_out_pad + col0;
#pragma unroll
        for (int c = 0; c < kCols; ++c) p[c] = acc[c][b];
      }
    }
  }
}

// out[b, j] = float(sum_split part[split, b, j]) * scale[j], splits in order.
template <typename A>
__global__ void lut_scan_reduce(const A* __restrict__ part, const float* __restrict__ scales,
                                float* __restrict__ out, int B, int BP, int n_splits,
                                int d_out, int d_out_pad) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * d_out) return;
  const int b = idx / d_out;
  const int j = idx - b * d_out;
  A s = A(0);
  for (int sp = 0; sp < n_splits; ++sp)
    s += part[(static_cast<size_t>(sp) * BP + b) * d_out_pad + j];
  float v = static_cast<float>(s);
  if (scales != nullptr) v *= scales[j];
  out[idx] = v;
}

template <typename T, int BP>
int launch(const void* tab, const void* codes, const void* scales, void* ws, void* out,
           int B, int G, int KP, int d_out, int d_out_pad, int g_per_split, int n_splits,
           int stage_groups, int grid_x, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  const int smem = stage_groups * KP * BP * static_cast<int>(sizeof(T));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lut_scan_partial<T, BP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  A* part = n_splits > 1 ? static_cast<A*>(ws) : nullptr;
  dim3 grid(grid_x, n_splits);
  lut_scan_partial<T, BP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(tab), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(scales), part, static_cast<float*>(out), B, G, KP, d_out,
      d_out_pad, g_per_split, stage_groups);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return static_cast<int>(err);
  const int n = B * d_out;
  lut_scan_reduce<A><<<(n + 255) / 256, 256, 0, stream>>>(
      part, static_cast<const float*>(scales), static_cast<float*>(out), B, BP, n_splits,
      d_out, d_out_pad);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bp(int BP, const void* tab, const void* codes, const void* scales, void* ws,
              void* out, int B, int G, int KP, int d_out, int d_out_pad, int g_per_split,
              int n_splits, int stage_groups, int grid_x, cudaStream_t stream) {
  switch (BP) {
    case 1: return launch<T, 1>(tab, codes, scales, ws, out, B, G, KP, d_out, d_out_pad,
                                g_per_split, n_splits, stage_groups, grid_x, stream);
    case 2: return launch<T, 2>(tab, codes, scales, ws, out, B, G, KP, d_out, d_out_pad,
                                g_per_split, n_splits, stage_groups, grid_x, stream);
    case 4: return launch<T, 4>(tab, codes, scales, ws, out, B, G, KP, d_out, d_out_pad,
                                g_per_split, n_splits, stage_groups, grid_x, stream);
    case 8: return launch<T, 8>(tab, codes, scales, ws, out, B, G, KP, d_out, d_out_pad,
                                g_per_split, n_splits, stage_groups, grid_x, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// kind: 0 = f32 tables (K), 1 = int8 (H), 2 = int16 (I).
extern "C" int lutvq_lut_scan(int kind, const void* tab, const void* codes,
                              const void* scales, void* ws, void* out, int B, int BP, int G,
                              int KP, int d_out, int d_out_pad, int g_per_split, int n_splits,
                              int stage_groups, int grid_x, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define LUTVQ_SCAN_ARGS BP, tab, codes, scales, ws, out, B, G, KP, d_out, d_out_pad, \
                        g_per_split, n_splits, stage_groups, grid_x, stream
  switch (kind) {
    case 0: return launch_bp<float>(LUTVQ_SCAN_ARGS);
    case 1: return launch_bp<int8_t>(LUTVQ_SCAN_ARGS);
    case 2: return launch_bp<int16_t>(LUTVQ_SCAN_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LUTVQ_SCAN_ARGS
}
