// W8A8 dequant-matmul (quality="fast") on Hopper (sm_90a), and the fold
// that prepares its int8 activations.
//
// Replaces tpu_lutvq/kernels/dequant_mm.py::_dequant_mm_i8_kernel and its
// VMEM-split twin ::_dequant_mm_i8_kernel_v3.  With the codebook words
// quantized to int8 per (word, group) and those row scales folded into the
// per-token int8 activations, it computes
//     acc[r, j] = sum_{n, m, w} x_i8[r, n, m, w] * q[m, n, code(n*M+m, j), w]
//     out[r, j] = float(acc) * xs[r] * s[j]
// The sum is exact in int32 (|acc| <= 127^2 * N * d_in = 3.6e8 at 7B
// w_down), so the kernel equals its plain version bit for bit in any order
// of addition.  It follows JAX's v2 kernel, one int32 sum and one cast; v3's
// f32 partials per quarter exist only for the TPU's 16 MiB VMEM.
//
// What bounds it on the H100: at decode widths (8 rows) the uint8 codes,
// G * d_out bytes streamed once (4 MiB at 4096x4096, 1.3 us at 3.35 TB/s);
// at prefill widths (256 rows) the int8 tensor cores, 2 * R * N * d_in *
// d_out operations at 1,979 TOPS.  The first version was latency-bound: a
// 64x64 tile of which 56 rows were padding at 8 rows, the weight tile
// rebuilt from two dependent global loads a step with two barriers, and
// split-K through a memset, atomics and a second kernel.
//
// The design (the bf16x2 kernel's, csrc/dequant_mm.cu, carried to int8):
// - Swap AB: mma.sync m16n8k32 (s8 x s8 -> s32) computes Y^T = W * X^T.  The
//   dequantized weight is the 16-row A operand (output columns), the batch
//   rows the n8 operand, so at 8 rows no MMA row is padding.  Tiles by rows:
//   8 or 16 rows with 4 warps (128 columns), 64 rows with 8 warps (256).
// - The int8 codebook lives in shared memory and the A fragments come
//   straight from it.  Inside an MMA the k order is permuted so that a
//   thread's eight A values of a row are eight consecutive inputs: one code
//   byte and one 64-bit ld.shared of a codebook row (two 32-bit ones at
//   d_subvec 4).  An output column permutation puts a thread's four columns
//   side by side, so one 32-bit load brings their codes.  A shared codebook
//   ((1, N, K, d) int8, 4 KiB at 2x8) is staged once a block; per-subvector
//   ones ride the ring with the codes and x, 32 inputs a stage.
// - A cp.async ring of 4 stages (3 with per-subvector codebooks) keeps the
//   next stages' codes and x in flight while the tensor cores work.
// - Split-K in one launch: the n_splits (<= 8) blocks of an output tile form
//   a thread-block cluster along grid z.  Each block parks its int32 sums in
//   shared memory and each sums a share of the tile over the cluster's
//   blocks (distributed shared memory), then applies the scales.  No
//   workspace, no memset, no second kernel; integer sums are exact, so two
//   calls are bit-equal.  kernels/dequant_mm.py::plan_i8 picks the split.
//
// fold_i8 (one block per token row) is the activation fold of the JAX
// package's dequant_matmul (dequant_mm.py:644-656, XLA, not Pallas):
// x4 = x * s (per codebook), xs = max(max|x4| / 127, 1e-12), x_i8 =
// clip(rint(x4 / xs), -127, 127), written padded with zeros to whole
// 128-input steps.  IEEE division and rintf (half to even): bit for bit
// kernels/dequant_mm.py::fold_activations_i8 (no --use_fast_math).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kNMax = 2;         // codebooks per subvector
constexpr int kKMax = 256;       // codebook rows
constexpr int kWarpCols = 32;    // output columns per warp: two m16 tiles
constexpr int kMaxSplits = 8;    // portable cluster size
constexpr int kPadInputs = 128;  // x_i8 rows are padded to whole 128-input steps

// A tile configuration: kWarps warps of 32 columns, kNT n8 tiles of rows,
// d_subvec D, the codebook shared (staged once) or per subvector (streamed).
template <int kWarps_, int kNT_, int D_, bool kSharedCb_>
struct Tile {
  static constexpr int kWarps = kWarps_, kNT = kNT_, D = D_;
  static constexpr bool kSharedCb = kSharedCb_;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kBN = kWarps * kWarpCols;           // output columns a block
  static constexpr int kBM = kNT * 8;                      // rows a block
  static constexpr int kBK = kSharedCb ? 128 : 32;         // inputs a stage
  static constexpr int kMS = kBK / D;                      // subvectors a stage
  static constexpr int kKK = kBK / 32;                     // k32 MMA steps a stage
  static constexpr int kStages = kSharedCb ? 4 : 3;
  // row strides (bytes) that make the 8-byte x fragment loads (4 rows x 4
  // threads a phase) and the 4-byte code loads conflict-free: 8 mod 32 words
  static constexpr int kXLd = kBK == 32 ? 32 : kBK + 32;
  static constexpr int kCLd = kBN + 32;
  static constexpr int kCodeBytes = kNMax * kMS * kCLd;
  static constexpr int kXBytes = kNMax * kBM * kXLd;
  static constexpr int kSlabBytes = kSharedCb ? 0 : kMS * kNMax * kKMax * D;
  static constexpr int kStageBytes = kCodeBytes + kXBytes + kSlabBytes;
  static constexpr int kCbBytes = kSharedCb ? kNMax * kKMax * D : 0;
  static constexpr int kRingBytes = kCbBytes + kStages * kStageBytes;
  static constexpr int kPartBytes = kBM * kBN * 4;         // int32 sums for the cluster reduce
  static constexpr int kSmem = kRingBytes > kPartBytes ? kRingBytes : kPartBytes;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint2 lds64(const int8_t* p) {
  return *reinterpret_cast<const uint2*>(p);
}

// out[r, c..c+3] = float(acc) * xs[r] * s[c..c+3], the plain version's order
__device__ __forceinline__ void store_out(float* __restrict__ out, const int (&v)[4],
                                          const float* __restrict__ xs,
                                          const float* __restrict__ scales, int r, int c,
                                          int d_out, int d_out_pad) {
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = __int2float_rn(v[i]) * xs[r];
    if (scales != nullptr) f[i] = f[i] * scales[min(c + i, d_out_pad - 1)];
  }
  float* o = out + static_cast<size_t>(r) * d_out + c;
  if ((d_out & 3) == 0 && c + 3 < d_out) {
    *reinterpret_cast<float4*>(o) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (c + i < d_out) o[i] = f[i];
  }
}

// x:      (R, N, Mp, D) int8, Mp * D a multiple of 128, zeros past M
// xs:     (R,) f32 per-token scales
// codes:  (G_pad, d_out_pad) uint8, row g = n*M + m; d_out_pad % 16 == 0
// q:      shared (1, N, K, D) or per subvector (M, N, K, D) int8
// scales: (d_out_pad,) f32 or null
// out:    (R, d_out) f32
// Block z of the cluster walks subvectors [z * m_split, (z + 1) * m_split),
// m_split a multiple of kMS.
//
// Thread (warp w, gid = lane / 4, tig = lane % 4) owns output columns
// 32w + 4gid + {0..3}: MMA tile mt's row gid is column 4gid + 2mt, row
// gid + 8 column 4gid + 2mt + 1.  In the k32 step over inputs [32kk, 32kk +
// 32) of a stage, MMA inputs {4tig..4tig+3} are the stage's inputs 32kk +
// 8tig + {0..3} and MMA inputs {16+4tig..} its inputs 32kk + 8tig + {4..7},
// in A (the weight) and B (x) alike.
template <class T>
__global__ void __launch_bounds__(T::kThreads)
dequant_mm_i8(const int8_t* __restrict__ x, const float* __restrict__ xs,
              const uint8_t* __restrict__ codes, const int8_t* __restrict__ q,
              const float* __restrict__ scales, float* __restrict__ out, int R, int M, int Mp,
              int N, int K, int d_out, int d_out_pad, int m_split) {
  constexpr int D = T::D;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* cbs = reinterpret_cast<int8_t*>(smem);
  unsigned char* ring = smem + T::kCbBytes;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int col0 = blockIdx.x * T::kBN, row0 = blockIdx.y * T::kBM;
  const int m_begin = blockIdx.z * m_split;
  const int m_end = min(M, m_begin + m_split);
  const int n_steps = (m_end - m_begin + T::kMS - 1) / T::kMS;
  const int cb_rows = N * K * D;  // bytes of one subvector's codebooks
  const bool slab16 = (cb_rows & 15) == 0;

  auto load_stage = [&](int slot, int t) {
    unsigned char* st = ring + slot * T::kStageBytes;
    const int m0 = m_begin + t * T::kMS;
    constexpr int kCChunks = T::kBN / 16;
    for (int i = tid; i < kNMax * T::kMS * kCChunks; i += T::kThreads) {
      const int row = i / kCChunks, c = i - row * kCChunks;
      const int n = row / T::kMS, m = m0 + row - n * T::kMS;
      const int col = col0 + c * 16;
      const bool ok = n < N && m < m_end && col < d_out_pad;
      cp_async16(st + row * T::kCLd + c * 16,
                 ok ? codes + static_cast<size_t>(n * M + m) * d_out_pad + col : codes, ok);
    }
    constexpr int kXChunks = T::kBK / 16;
    unsigned char* xt = st + T::kCodeBytes;
    for (int i = tid; i < kNMax * T::kBM * kXChunks; i += T::kThreads) {
      const int row = i / kXChunks, c = i - row * kXChunks;
      const int n = row / T::kBM, r = row - n * T::kBM;
      const bool ok = n < N && row0 + r < R;
      cp_async16(xt + row * T::kXLd + c * 16,
                 ok ? x + (static_cast<size_t>(row0 + r) * N + n) * Mp * D + m0 * D + c * 16 : x,
                 ok);
    }
    if constexpr (!T::kSharedCb) {
      unsigned char* slab = xt + T::kXBytes;
      const int8_t* src = q + static_cast<size_t>(m0) * cb_rows;
      const int n_valid = min(T::kMS, m_end - m0) * cb_rows;  // bytes of real subvectors
      if (slab16) {
        for (int i = tid; i < T::kMS * cb_rows / 16; i += T::kThreads)
          cp_async16(slab + i * 16, i * 16 < n_valid ? src + i * 16 : q, i * 16 < n_valid);
      } else {
        for (int i = tid; i < T::kMS * cb_rows / 4; i += T::kThreads)
          cp_async4(slab + i * 4, i * 4 < n_valid ? src + i * 4 : q, i * 4 < n_valid);
      }
    }
  };

  if constexpr (T::kSharedCb) {
    for (int i = tid; i < cb_rows / 4; i += T::kThreads)
      reinterpret_cast<uint32_t*>(cbs)[i] = reinterpret_cast<const uint32_t*>(q)[i];
  }
#pragma unroll
  for (int s = 0; s < T::kStages - 1; ++s) {
    if (s < n_steps) load_stage(s, s);
    cp_async_commit();
  }

  int acc[2][T::kNT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

  for (int t = 0; t < n_steps; ++t) {
    cp_async_wait<T::kStages - 2>();
    __syncthreads();
    const int tn = t + T::kStages - 1;
    if (tn < n_steps) load_stage(tn % T::kStages, tn);
    cp_async_commit();

    const unsigned char* st = ring + (t % T::kStages) * T::kStageBytes;
    const int8_t* xt = reinterpret_cast<const int8_t*>(st + T::kCodeBytes);
    const int8_t* slab = xt + T::kXBytes;
#pragma unroll
    for (int kk = 0; kk < T::kKK; ++kk) {
      const int e0 = 32 * kk + 8 * tig;  // this thread's first input in the stage
      const int ms = e0 / D;             // its subvector (the first of two at D = 4)
#pragma unroll
      for (int n = 0; n < kNMax; ++n) {
        if (n >= N) break;
        uint32_t b[T::kNT][2];
#pragma unroll
        for (int nt = 0; nt < T::kNT; ++nt) {
          const uint2 v = lds64(xt + (n * T::kBM + nt * 8 + gid) * T::kXLd + e0);
          b[nt][0] = v.x;
          b[nt][1] = v.y;
        }
        const unsigned char* crow = st + (n * T::kMS + ms) * T::kCLd + warp * kWarpCols + 4 * gid;
        const uint32_t cw = *reinterpret_cast<const uint32_t*>(crow);
        const int8_t* base =
            T::kSharedCb ? cbs + n * K * D : slab + (ms * N + n) * K * D;
        uint32_t cw1 = 0;
        const int8_t* base1 = base;
        if constexpr (D == 4) {
          cw1 = *reinterpret_cast<const uint32_t*>(crow + T::kCLd);
          base1 = T::kSharedCb ? base : slab + ((ms + 1) * N + n) * K * D;
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const uint32_t lo = (cw >> (16 * mt)) & 0xffu, hi = (cw >> (16 * mt + 8)) & 0xffu;
          uint32_t a[4];
          if constexpr (D == 4) {
            const uint32_t lo1 = (cw1 >> (16 * mt)) & 0xffu, hi1 = (cw1 >> (16 * mt + 8)) & 0xffu;
            a[0] = lds32(base + lo * 4);
            a[1] = lds32(base + hi * 4);
            a[2] = lds32(base1 + lo1 * 4);
            a[3] = lds32(base1 + hi1 * 4);
          } else {
            const int off = e0 % D;  // 0, or 8 in the second half of a 16-wide subvector
            const uint2 wl = lds64(base + lo * D + off);
            const uint2 wh = lds64(base + hi * D + off);
            a[0] = wl.x;
            a[1] = wh.x;
            a[2] = wl.y;
            a[3] = wh.y;
          }
#pragma unroll
          for (int nt = 0; nt < T::kNT; ++nt) mma_s8(acc[mt][nt], a, b[nt]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // Columns c .. c+3 of the tile; batch rows nt*8 + 2tig (even) and + 1 (odd).
  const int lc = warp * kWarpCols + 4 * gid;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_splits = static_cast<int>(cluster.num_blocks());
  if (n_splits == 1) {
#pragma unroll
    for (int nt = 0; nt < T::kNT; ++nt)
#pragma unroll
      for (int odd = 0; odd < 2; ++odd) {
        const int r = row0 + nt * 8 + 2 * tig + odd;
        if (r >= R || col0 + lc >= d_out) continue;
        const int v[4] = {acc[0][nt][odd], acc[0][nt][2 + odd], acc[1][nt][odd],
                          acc[1][nt][2 + odd]};
        store_out(out, v, xs, scales, r, col0 + lc, d_out, d_out_pad);
      }
    return;
  }

  // The cluster's blocks meet: each parks its sums, then sums a share of
  // the tile over the blocks in rank order.
  __syncthreads();  // the ring is free
  int* part = reinterpret_cast<int*>(smem);  // [kBM][kBN]
#pragma unroll
  for (int nt = 0; nt < T::kNT; ++nt)
#pragma unroll
    for (int odd = 0; odd < 2; ++odd)
      *reinterpret_cast<int4*>(part + (nt * 8 + 2 * tig + odd) * T::kBN + lc) =
          make_int4(acc[0][nt][odd], acc[0][nt][2 + odd], acc[1][nt][odd],
                    acc[1][nt][2 + odd]);
  cluster.sync();
  const int rank = static_cast<int>(cluster.block_rank());
  constexpr int kQuads = T::kBM * T::kBN / 4;
  for (int e = rank * T::kThreads + tid; e < kQuads; e += n_splits * T::kThreads) {
    const int r = e / (T::kBN / 4), c = (e % (T::kBN / 4)) * 4;
    int v[4] = {0, 0, 0, 0};
    for (int s = 0; s < n_splits; ++s) {
      const int4 p = *reinterpret_cast<const int4*>(cluster.map_shared_rank(part, s) + 4 * e);
      v[0] += p.x;
      v[1] += p.y;
      v[2] += p.z;
      v[3] += p.w;
    }
    if (row0 + r < R && col0 + c < d_out)
      store_out(out, v, xs, scales, row0 + r, col0 + c, d_out, d_out_pad);
  }
  cluster.sync();  // no block leaves while its sums are read
}

template <class T>
int launch(const void* x, const void* xs, const void* codes, const void* q, const void* scales,
           void* out, int R, int M, int Mp, int N, int K, int d_out, int d_out_pad,
           int m_split, int n_splits, cudaStream_t stream) {
  if (m_split % T::kMS != 0) return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        dequant_mm_i8<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3((d_out + T::kBN - 1) / T::kBN, (R + T::kBM - 1) / T::kBM, n_splits);
  cfg.blockDim = dim3(T::kThreads);
  cfg.dynamicSmemBytes = T::kSmem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = n_splits;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, dequant_mm_i8<T>, static_cast<const int8_t*>(x), static_cast<const float*>(xs),
      static_cast<const uint8_t*>(codes), static_cast<const int8_t*>(q),
      static_cast<const float*>(scales), static_cast<float*>(out), R, M, Mp, N, K, d_out,
      d_out_pad, m_split);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(int config, bool shared, const void* x, const void* xs, const void* codes,
             const void* q, const void* scales, void* out, int R, int M, int Mp, int N, int K,
             int d_out, int d_out_pad, int m_split, int n_splits, cudaStream_t stream) {
#define LUTVQ_I8_ARGS x, xs, codes, q, scales, out, R, M, Mp, N, K, d_out, d_out_pad, m_split, \
                      n_splits, stream
  switch (config * 2 + (shared ? 1 : 0)) {
    case 0: return launch<Tile<4, 1, D, false>>(LUTVQ_I8_ARGS);
    case 1: return launch<Tile<4, 1, D, true>>(LUTVQ_I8_ARGS);
    case 2: return launch<Tile<4, 2, D, false>>(LUTVQ_I8_ARGS);
    case 3: return launch<Tile<4, 2, D, true>>(LUTVQ_I8_ARGS);
    case 4: return launch<Tile<8, 8, D, false>>(LUTVQ_I8_ARGS);
    case 5: return launch<Tile<8, 8, D, true>>(LUTVQ_I8_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LUTVQ_I8_ARGS
}

constexpr int kFoldThreads = 512;

// x: (R, M*D) f32; s: (M_s, N, D) f32, s_m_stride = N*D (per subvector) or
// 0 (shared); xq: (R, N, Mp, D) int8; xs: (R,) f32.
__global__ void __launch_bounds__(kFoldThreads)
fold_i8(const float* __restrict__ x, const float* __restrict__ s, int8_t* __restrict__ xq,
        float* __restrict__ xs, int M, int Mp, int N, int D, int s_m_stride) {
  __shared__ float warp_max[kFoldThreads / 32];
  const int r = blockIdx.x, tid = threadIdx.x;
  const int quads = M * D / 4;  // four inputs of one codebook's copy
  const float4* xr = reinterpret_cast<const float4*>(x + static_cast<size_t>(r) * M * D);
  auto x4 = [&](int i) {
    const int n = i / quads, e = (i - n * quads) * 4;
    const int m = e / D, w = e - m * D;
    const float4 xv = xr[e / 4];
    const float4 sv = *reinterpret_cast<const float4*>(s + m * s_m_stride + n * D + w);
    return make_float4(xv.x * sv.x, xv.y * sv.y, xv.z * sv.z, xv.w * sv.w);
  };
  float amax = 0.f;
  for (int i = tid; i < N * quads; i += kFoldThreads) {
    const float4 v = x4(i);
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if ((tid & 31) == 0) warp_max[tid >> 5] = amax;
  __syncthreads();
  amax = warp_max[0];
#pragma unroll
  for (int w = 1; w < kFoldThreads / 32; ++w) amax = fmaxf(amax, warp_max[w]);
  const float scale = fmaxf(amax / 127.0f, 1e-12f);
  if (tid == 0) xs[r] = scale;
  auto q8 = [&](float v) {
    return static_cast<uint32_t>(static_cast<uint8_t>(
        static_cast<int8_t>(fminf(fmaxf(rintf(v / scale), -127.f), 127.f))));
  };
  int8_t* xo = xq + static_cast<size_t>(r) * N * Mp * D;
  for (int i = tid; i < N * quads; i += kFoldThreads) {
    const float4 v = x4(i);
    const int n = i / quads, e = (i - n * quads) * 4;
    *reinterpret_cast<uint32_t*>(xo + static_cast<size_t>(n) * Mp * D + e) =
        q8(v.x) | (q8(v.y) << 8) | (q8(v.z) << 16) | (q8(v.w) << 24);
  }
  const int pad = (Mp - M) * D / 4;  // zero quads past M in each copy
  for (int i = tid; i < N * pad; i += kFoldThreads) {
    const int n = i / pad;
    *reinterpret_cast<uint32_t*>(xo + static_cast<size_t>(n) * Mp * D + M * D +
                                 (i - n * pad) * 4) = 0u;
  }
}

}  // namespace

// config (kernels/dequant_mm.py::plan_i8): 0 = 8 rows a block, 1 = 16, 2 =
// 64 (8 warps, 256 columns).  n_splits (<= 8) blocks of m_split subvectors
// each form a cluster along grid z; every split must hold a subvector.
extern "C" int lutvq_dequant_mm_i8(const void* x, const void* xs, const void* codes,
                                   const void* q, const void* scales, void* out, int R, int M,
                                   int Mp, int N, int K, int D, int q_shared, int config,
                                   int d_out, int d_out_pad, int m_split, int n_splits,
                                   void* stream_ptr) {
  if ((D != 4 && D != 8 && D != 16) || N < 1 || N > kNMax || K < 1 || K > kKMax ||
      (Mp * D) % kPadInputs != 0 || Mp < M || d_out_pad % 16 != 0 || d_out > d_out_pad ||
      m_split < 1 || n_splits < 1 || n_splits > kMaxSplits ||
      static_cast<long>(m_split) * n_splits < M ||
      static_cast<long>(m_split) * (n_splits - 1) >= M)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0 || d_out == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool shared = q_shared != 0;
  switch (D) {
    case 4: return launch_d<4>(config, shared, x, xs, codes, q, scales, out, R, M, Mp, N, K, d_out, d_out_pad, m_split, n_splits, stream);
    case 8: return launch_d<8>(config, shared, x, xs, codes, q, scales, out, R, M, Mp, N, K, d_out, d_out_pad, m_split, n_splits, stream);
    default: return launch_d<16>(config, shared, x, xs, codes, q, scales, out, R, M, Mp, N, K, d_out, d_out_pad, m_split, n_splits, stream);
  }
}

// s_shared: s is (1, N, D), else (M, N, D).  x_i8 is written (R, N, Mp, D).
extern "C" int lutvq_fold_i8(const void* x, const void* s, void* xq, void* xs, int R, int M,
                             int Mp, int N, int D, int s_shared, void* stream_ptr) {
  if (D % 4 != 0 || N < 1 || Mp < M || (Mp * D) % kPadInputs != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  fold_i8<<<R, kFoldThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const float*>(x), static_cast<const float*>(s), static_cast<int8_t*>(xq),
      static_cast<float*>(xs), M, Mp, N, D, s_shared ? 0 : N * D);
  return static_cast<int>(cudaGetLastError());
}
