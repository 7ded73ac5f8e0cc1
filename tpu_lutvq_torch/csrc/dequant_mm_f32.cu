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
// d_out operations at 67 TFLOP/s; at decode widths the uint8 codes.  The
// first version sat 7.6x above that bound at 256 rows: 4x4 outputs a thread
// read with scalar shared loads (a load per FMA), and each 16-input step
// stalled on its loads, N code and N codebook gathers from device memory a
// weight, with no overlap.
//
// The design, a register-blocked f32 GEMM:
// - 256 threads own a 128x128 output tile (32x128 at <= 32 rows, split-K
//   filling the card), 8x8 (2x8) outputs each, read as float4 from shared
//   memory: 16 FMAs a loaded value.
// - Each 16-input step's weight tile is built in shared memory exactly as
//   the plain version builds W (n = 0 first, f32 adds in codebook order), so
//   W is bit-equal to dequant_weight(..., round_bf16=False) and only the
//   contraction order moves.  Fast path (D in {4, 8, 16}, N <= 2): a thread
//   reads one 4-byte code word (four columns) a codebook and 8-byte codebook
//   rows from shared memory: a shared codebook (N x K x D f32) is staged once
//   a block, per-subvector codebooks are streamed a step ahead with cp.async.
//   General path (any D, any N): the codes and codebook rows are gathered
//   from device memory, as before.
// - Double buffered: the next step's x values and code words are loaded
//   into registers (and its codebook slab copied) while the FMAs of the
//   current step run; one barrier a step.
// - Split-K across blocks (grid z) when the output tiles cannot fill the
//   card (kernels/dequant_mm.py::plan_f32); partials meet in a workspace that
//   a second kernel sums in split order, so the result is deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBN = 128;        // output columns a block
constexpr int kBK = 16;         // inputs a step
constexpr int kThreads = 256;   // 16 x 16
constexpr int kLd = kBN + 4;    // padded shared row (floats), float4-aligned
constexpr int kNFast = 2;       // codebooks of the fast path

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// kD: d_subvec of the fast path, 0 for the general one.  kTM rows a thread
// (2 or 8): the block has 16 * kTM rows.
template <int kD, bool kShared, int kTM>
struct F32Tile {
  static constexpr bool kFast = kD != 0;
  static constexpr int kBM = 16 * kTM;
  static constexpr int kRH = kTM < 4 ? kTM : 4;     // rows a thread holds per half
  static constexpr int kHalves = kTM / kRH;         // 2 at 8 rows, 1 at 2
  static constexpr int kXLd = kBM + 4;
  // codebook floats in shared memory: the whole shared one, or one step's
  // subvectors (kBK / kD of them) of a per-subvector one
  static constexpr int kCbFloats = !kFast ? 0 : kShared ? kNFast * 256 * kD : kBK * kNFast * 256;
  static constexpr int kSmem = (2 * kBK * kXLd + 2 * kBK * kLd + kCbFloats) * 4;
};

// x:      (R, d_in) f32, d_in = M * D
// codes:  (G_pad, d_out_pad) uint8, row g = n*M + m; d_out_pad % 16 == 0
// cb:     (M_cb, N, K, D) f32; cb_m_stride = N*K*D (per-subvector) or 0 (shared)
// scales: (d_out_pad,) f32 or null
// out:    (R, d_out) f32, written when gridDim.z == 1
// part:   (gridDim.z, R, d_out_pad) f32 partials when d_in is split
// Split z walks inputs [z * k_split, (z + 1) * k_split), k_split a multiple
// of kBK.
//
// Thread (tx, ty) = (tid % 16, tid / 16) owns rows h * kBM / kHalves + ty *
// kRH + i and columns tx * 4 + j, 64 + tx * 4 + j.  Building a weight tile,
// thread (q, p) = (tid % 32, tid / 32) writes elements 2p, 2p + 1 of the
// step for columns 4q .. 4q + 3.
template <int kD, bool kShared, int kTM>
__global__ void __launch_bounds__(kThreads, 2)
dequant_mm_f32(const float* __restrict__ x, const uint8_t* __restrict__ codes,
               const float* __restrict__ cb, const float* __restrict__ scales,
               float* __restrict__ out, float* __restrict__ part, int R, int M, int N, int K,
               int D, long cb_m_stride, int d_out, int d_out_pad, int k_split) {
  using T = F32Tile<kD, kShared, kTM>;
  extern __shared__ __align__(16) float sm[];
  float* xs = sm;                          // [2][kBK][kXLd]: x, transposed
  float* ws = xs + 2 * kBK * T::kXLd;      // [2][kBK][kLd]: W, (input, column)
  float* cbs = ws + 2 * kBK * kLd;         // fast path codebook
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q = tid & 31, p = tid >> 5;
  const int row0 = blockIdx.y * T::kBM, col0 = blockIdx.x * kBN;
  const int d_in = M * D;
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(d_in, k_begin + k_split);
  const int n_steps = (k_end - k_begin + kBK - 1) / kBK;
  const bool codes_in = col0 + 4 * q < d_out_pad;

  // x: thread reads kTM consecutive inputs of one row
  constexpr int kXThreadsPerRow = kBK / kTM;
  const int xr = tid / kXThreadsPerRow, xk = (tid % kXThreadsPerRow) * kTM;
  const bool x_vec = (d_in & 3) == 0;
  float xreg[kTM];
  uint32_t creg[kNFast];

  auto load_regs = [&](int k0) {
    const int r = row0 + xr;
    if (x_vec && k0 + xk + kTM <= k_end && r < R) {
      const float* src = x + static_cast<size_t>(r) * d_in + k0 + xk;
#pragma unroll
      for (int i = 0; i < kTM; i += 2) {
        if constexpr (kTM % 4 == 0) {
          if (i % 4 == 0) {
            const float4 v = *reinterpret_cast<const float4*>(src + i);
            xreg[i] = v.x; xreg[i + 1] = v.y; xreg[i + 2] = v.z; xreg[i + 3] = v.w;
          }
        } else {
          const float2 v = *reinterpret_cast<const float2*>(src + i);
          xreg[i] = v.x; xreg[i + 1] = v.y;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int c = k0 + xk + i;
        xreg[i] = (r < R && c < k_end) ? x[static_cast<size_t>(r) * d_in + c] : 0.f;
      }
    }
    if constexpr (T::kFast) {
      const int m = (k0 + 2 * p) / kD;
#pragma unroll
      for (int n = 0; n < kNFast; ++n)
        creg[n] = (n < N && m < M && codes_in)
                      ? *reinterpret_cast<const uint32_t*>(
                            codes + static_cast<size_t>(n * M + m) * d_out_pad + col0 + 4 * q)
                      : 0u;
    }
  };

  // one step's codebook slab (per-subvector fast path), a step ahead
  auto copy_slab = [&](int k0) {
    if constexpr (T::kFast && !kShared) {
      const int m0 = k0 / kD;
      const int rows = N * K * kD / 4;  // 16-byte chunks a subvector
      for (int i = tid; i < (kBK / kD) * rows; i += kThreads) {
        const bool ok = m0 + i / rows < M;
        cp_async16(cbs + 4 * i, ok ? cb + static_cast<size_t>(m0) * rows * 4 + 4 * i : cb, ok);
      }
      cp_async_commit();
    }
  };

  auto store_tiles = [&](int buf, int k0) {
    float* xb = xs + buf * kBK * T::kXLd;
#pragma unroll
    for (int i = 0; i < kTM; ++i) xb[(xk + i) * T::kXLd + xr] = xreg[i];
    float v[2][4];
    if constexpr (T::kFast) {
      const int c = k0 + 2 * p;
      const int m = c / kD, w = c - m * kD;
      const float* base = cbs + (kShared ? 0 : (m - k0 / kD) * N * K * kD) + w;
#pragma unroll
      for (int n = 0; n < kNFast; ++n) {
        if (n >= N) break;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t code = (creg[n] >> (8 * j)) & 0xffu;
          const float2 e = *reinterpret_cast<const float2*>(base + (n * K + code) * kD);
          v[0][j] = n == 0 ? e.x : v[0][j] + e.x;
          v[1][j] = n == 0 ? e.y : v[1][j] + e.y;
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = k0 + 2 * p + e;
        const int m = c / D, w = c - m * D;
#pragma unroll
        for (int j = 0; j < 4; ++j) v[e][j] = 0.f;
        if (c >= k_end || !codes_in) continue;
        const float* row = cb + m * cb_m_stride + w;
        for (int n = 0; n < N; ++n) {
          const uint32_t cw = __ldg(reinterpret_cast<const unsigned int*>(
              codes + static_cast<size_t>(n * M + m) * d_out_pad + col0 + 4 * q));
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float t = __ldg(row + (static_cast<long>(n) * K + ((cw >> (8 * j)) & 0xffu)) * D);
            v[e][j] = n == 0 ? t : v[e][j] + t;
          }
        }
      }
    }
    float* wb = ws + buf * kBK * kLd;
    *reinterpret_cast<float4*>(wb + (2 * p) * kLd + 4 * q) =
        make_float4(v[0][0], v[0][1], v[0][2], v[0][3]);
    *reinterpret_cast<float4*>(wb + (2 * p + 1) * kLd + 4 * q) =
        make_float4(v[1][0], v[1][1], v[1][2], v[1][3]);
  };

  if constexpr (T::kFast && kShared) {
    for (int i = tid; i < N * K * kD; i += kThreads) cbs[i] = cb[i];
  }
  load_regs(k_begin);
  if constexpr (T::kFast && !kShared) {
    copy_slab(k_begin);
    cp_async_wait_all();
  }
  __syncthreads();
  store_tiles(0, k_begin);
  __syncthreads();

  float acc[kTM][8];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < n_steps; ++t) {
    const int buf = t & 1;
    const int k_next = k_begin + (t + 1) * kBK;
    const bool more = t + 1 < n_steps;
    if (more) {
      load_regs(k_next);
      if constexpr (T::kFast && !kShared) copy_slab(k_next);
    }
    const float* xb = xs + buf * kBK * T::kXLd;
    const float* wb = ws + buf * kBK * kLd;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], b[8];
#pragma unroll
      for (int h = 0; h < T::kHalves; ++h) {
        const float* src = xb + kk * T::kXLd + h * (T::kBM / T::kHalves) + ty * T::kRH;
        if constexpr (T::kRH == 4) {
          const float4 v = *reinterpret_cast<const float4*>(src);
          a[4 * h] = v.x; a[4 * h + 1] = v.y; a[4 * h + 2] = v.z; a[4 * h + 3] = v.w;
        } else {
          const float2 v = *reinterpret_cast<const float2*>(src);
          a[2 * h] = v.x; a[2 * h + 1] = v.y;
        }
      }
      const float4 b0 = *reinterpret_cast<const float4*>(wb + kk * kLd + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(wb + kk * kLd + 64 + tx * 4);
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) {
      if constexpr (T::kFast && !kShared) {
        cp_async_wait_all();
        __syncthreads();
      }
      store_tiles(buf ^ 1, k_next);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + (i / T::kRH) * (T::kBM / T::kHalves) + ty * T::kRH + i % T::kRH;
    if (r >= R) continue;
#pragma unroll
    for (int hj = 0; hj < 2; ++hj) {
      const int c = col0 + 64 * hj + 4 * tx;
      float v[4] = {acc[i][4 * hj], acc[i][4 * hj + 1], acc[i][4 * hj + 2], acc[i][4 * hj + 3]};
      if (gridDim.z > 1) {
        if (c < d_out_pad)
          *reinterpret_cast<float4*>(
              part + (static_cast<size_t>(blockIdx.z) * R + r) * d_out_pad + c) =
              make_float4(v[0], v[1], v[2], v[3]);
        continue;
      }
      if (scales != nullptr)
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = v[j] * scales[min(c + j, d_out_pad - 1)];
      float* o = out + static_cast<size_t>(r) * d_out + c;
      if ((d_out & 3) == 0 && c + 3 < d_out) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < d_out) o[j] = v[j];
      }
    }
  }
}

// out[r, j] = (sum_split part[split, r, j]) * s[j], splits in order.
__global__ void dequant_mm_f32_reduce(const float* __restrict__ part,
                                      const float* __restrict__ scales,
                                      float* __restrict__ out, int R, int d_out, int d_out_pad,
                                      int n_splits) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(R) * d_out) return;
  const int r = static_cast<int>(idx / d_out);
  const int j = static_cast<int>(idx - static_cast<size_t>(r) * d_out);
  float s = 0.f;
  for (int sp = 0; sp < n_splits; ++sp)
    s += part[(static_cast<size_t>(sp) * R + r) * d_out_pad + j];
  if (scales != nullptr) s = s * scales[j];
  out[idx] = s;
}

template <int kD, bool kShared, int kTM>
int launch(const void* x, const void* codes, const void* cb, const void* scales, void* out,
           void* part, int R, int M, int N, int K, int D, long cb_m_stride, int d_out,
           int d_out_pad, int k_split, int n_splits, cudaStream_t stream) {
  using T = F32Tile<kD, kShared, kTM>;
  auto kernel = dequant_mm_f32<kD, kShared, kTM>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  dim3 grid((d_out + kBN - 1) / kBN, (R + T::kBM - 1) / T::kBM, n_splits);
  kernel<<<grid, kThreads, T::kSmem, stream>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(cb), static_cast<const float*>(scales),
      static_cast<float*>(out), static_cast<float*>(part), R, M, N, K, D, cb_m_stride, d_out,
      d_out_pad, k_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return static_cast<int>(err);
  const size_t n_out = static_cast<size_t>(R) * d_out;
  dequant_mm_f32_reduce<<<static_cast<unsigned>((n_out + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const float*>(scales),
      static_cast<float*>(out), R, d_out, d_out_pad, n_splits);
  return static_cast<int>(cudaGetLastError());
}

template <int kD, bool kShared>
int launch_tm(int tm, const void* x, const void* codes, const void* cb, const void* scales,
              void* out, void* part, int R, int M, int N, int K, int D, long cb_m_stride,
              int d_out, int d_out_pad, int k_split, int n_splits, cudaStream_t stream) {
  if (tm == 2)
    return launch<kD, kShared, 2>(x, codes, cb, scales, out, part, R, M, N, K, D, cb_m_stride,
                                  d_out, d_out_pad, k_split, n_splits, stream);
  return launch<kD, kShared, 8>(x, codes, cb, scales, out, part, R, M, N, K, D, cb_m_stride,
                                d_out, d_out_pad, k_split, n_splits, stream);
}

}  // namespace

// fast (kernels/dequant_mm.py::plan_f32): D in {4, 8, 16} and N <= 2, else
// the general path; tm 2 (32-row tiles) or 8 (128-row tiles).  n_splits > 1
// needs part, (n_splits, R, d_out_pad) f32; every split must hold an input.
extern "C" int lutvq_dequant_mm_f32(const void* x, const void* codes, const void* cb,
                                    const void* scales, void* out, void* part, int R, int M,
                                    int N, int K, int D, int cb_shared, int fast, int tm,
                                    int d_out, int d_out_pad, int k_split, int n_splits,
                                    void* stream_ptr) {
  const long d_in = static_cast<long>(M) * D;
  if (N < 1 || D < 1 || K < 1 || K > 256 || (tm != 2 && tm != 8) || d_out_pad % 16 != 0 ||
      d_out > d_out_pad || k_split < kBK || k_split % kBK != 0 || n_splits < 1 ||
      static_cast<long>(k_split) * n_splits < d_in ||
      static_cast<long>(k_split) * (n_splits - 1) >= d_in ||
      (n_splits > 1 && part == nullptr) ||
      (fast && ((D != 4 && D != 8 && D != 16) || N > kNFast)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long cb_m_stride = cb_shared ? 0L : static_cast<long>(N) * K * D;
#define LUTVQ_F32_ARGS tm, x, codes, cb, scales, out, part, R, M, N, K, D, cb_m_stride, d_out, \
                       d_out_pad, k_split, n_splits, stream
  if (!fast) return launch_tm<0, false>(LUTVQ_F32_ARGS);
  switch (D * 2 + (cb_shared ? 1 : 0)) {
    case 8: return launch_tm<4, false>(LUTVQ_F32_ARGS);
    case 9: return launch_tm<4, true>(LUTVQ_F32_ARGS);
    case 16: return launch_tm<8, false>(LUTVQ_F32_ARGS);
    case 17: return launch_tm<8, true>(LUTVQ_F32_ARGS);
    case 32: return launch_tm<16, false>(LUTVQ_F32_ARGS);
    case 33: return launch_tm<16, true>(LUTVQ_F32_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LUTVQ_F32_ARGS
}
