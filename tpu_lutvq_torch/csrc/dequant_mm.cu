// Fused dequant-matmul with bf16 tables (AQLM 2x8 and every other even
// d_subvec and codebook count) on Hopper (sm_90a).
//
// Replaces tpu_lutvq/kernels/dequant_mm.py::_dequant_mm_bf16x2_kernel and
// its VMEM-split twin ::_dequant_mm_bf16x2_kernel_v3.  Both compute
//     Y[r, j] = s[j] * sum_{n, m, w} bf16(x[r, m*d + w]) * bf16(cb[m, n, code(j, n*M+m), w])
// with f32 accumulation.  The codebook sum over n is NOT rounded to bf16:
// the reference contracts each bf16 codebook entry against x duplicated per
// codebook (dequant_mm.py:264-277, 726-734).  Here each codebook n gets its
// own tensor-core products, all accumulated in the same f32 registers.  The
// TPU's v2/v3 split exists only for its 16 MiB scoped VMEM.
//
// What bounds it on the H100.  At decode widths (the batcher's 8 rows) the
// uint8 codes, G * d_out bytes (4 MiB at 4096x4096, ~1.3 us at 3.35 TB/s);
// what held the first version 400x above that was latency: a 64x64 tile of
// which 56 rows were padding, 64 blocks for 132 SMs, each walking all of
// d_in with a dependent code-then-codebook gather from device memory and two
// barriers a 32-input step.  At prefill widths (256-1024 rows) the tensor
// cores: 2 * N * R * d_in * d_out operations (N contractions, since the sum
// over codebooks is kept in f32).
//
// The design:
// - Swap AB: the kernel computes Y^T = W * X^T with mma.sync m16n8k16 (bf16
//   in, f32 accumulate).  The dequantized weight is the 16-row A operand (16
//   output columns), the batch rows the n8 operand, so at 8 rows no MMA row
//   is padding.  A warp owns 32 output columns; the tile is chosen by rows:
//   8 or 16 rows with 4 warps (128 columns), 64 rows with 8 warps (256
//   columns) above 16, so each code tile is rebuilt once per 64 rows.
// - The codebook lives in shared memory and the A fragments come straight
//   from it: a shared codebook (N x K x 8 bf16, 8 KiB) is staged once per
//   block, rounded to bf16 as it is staged (round to nearest even, as
//   torch's cast), so the wrapper does not cast it; per-subvector codebooks
//   are streamed through the ring with the codes, two subvectors a stage.
//   Up to 16 rows x comes in f32 and is rounded in the fragment (no cast
//   launch at decode), above that as bf16 from the wrapper.  The
//   k index inside an MMA is permuted so that each thread's four A values of
//   a row are one 8-byte run of one codebook row: a fragment is a code byte
//   and one 64-bit ld.shared, and an output column permutation puts a
//   thread's four columns side by side, so one 32-bit load brings its codes.
//   No weight tile is written to shared memory.
// - A ring of 4 stages (3 when it also carries codebooks) of code and x
//   tiles, filled with cp.async: the next stages' loads are in flight while
//   the tensor cores work on the current one, one barrier a stage.
// - Split-K across blocks (grid z) when the output tiles cannot fill the
//   card; the wrapper's plan (kernels/dequant_mm.py::plan_bf16x2) picks the
//   split.  Each split writes f32 partials to a workspace and a second
//   kernel sums them in split order and applies the scales: two calls on the
//   same inputs give bit-equal outputs.
// mma.sync, not wgmma: its A operand may come from registers built per
// fragment, which is what a code-indexed weight is; wgmma with a register A
// and the x tile as its shared-memory B is the next step once this design's
// time is known.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSub = 8;         // d_subvec (bf16 per codebook row)
constexpr int kNMax = 2;        // codebooks per subvector
constexpr int kKMax = 256;      // codebook rows
constexpr int kWarpCols = 32;   // output columns per warp: two m16 tiles

// A tile configuration: kWarps warps of 32 columns, kNT n8 tiles of rows,
// x in f32 (rounded to bf16 in the fragment) or bf16 (rounded by the
// wrapper), the codebook shared (staged once) or per subvector (streamed).
template <int kWarps_, int kNT_, bool kXf32_, bool kSharedCb_>
struct Tile {
  static constexpr int kWarps = kWarps_, kNT = kNT_;
  static constexpr bool kXf32 = kXf32_, kSharedCb = kSharedCb_;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kBN = kWarps * kWarpCols;           // output columns a block
  static constexpr int kBM = kNT * 8;                      // rows a block
  static constexpr int kMS = kSharedCb ? 8 : 2;            // subvectors a stage
  static constexpr int kBK = kMS * kSub;                   // inputs a stage
  static constexpr int kStages = kSharedCb ? 4 : 3;
  static constexpr int kXElt = kXf32 ? 4 : 2;              // bytes an x value
  // x row stride (elements): conflict-free 16-byte (f32) / 8-byte (bf16)
  // fragment loads of 8 rows x 4 threads
  static constexpr int kXLd = kBK % 32 == 0 ? kBK + 16 : kBK;
  static constexpr int kCLd = kBN + 32;                    // code row stride (bytes)
  static constexpr int kCodeBytes = kNMax * kMS * kCLd;
  static constexpr int kXBytes = kBM * kXLd * kXElt;
  static constexpr int kSlabBytes = kSharedCb ? 0 : kMS * kNMax * kKMax * kSub * 2;
  static constexpr int kStageBytes = kCodeBytes + kXBytes + kSlabBytes;
  static constexpr int kCbBytes = kSharedCb ? kNMax * kKMax * kSub * 2 : 0;
  static constexpr int kSmem = kCbBytes + kStages * kStageBytes;
  static constexpr int kMinBlocks = kWarps == 4 ? 4 : 2;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two f32 values rounded to bf16 (nearest even), the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One 8-entry codebook row as bf16: stored f32 (0), fp16 (1) or bf16 (2).
__device__ __forceinline__ uint4 cb_row_bf16(const void* cb, int row, int dtype) {
  if (dtype == 2) return reinterpret_cast<const uint4*>(cb)[row];
  float f[8];
  if (dtype == 1) {
    const uint4 h = reinterpret_cast<const uint4*>(cb)[row];
    const __half2* p = reinterpret_cast<const __half2*>(&h);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __half22float2(p[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  } else {
    const float4 a = reinterpret_cast<const float4*>(cb)[2 * row];
    const float4 b = reinterpret_cast<const float4*>(cb)[2 * row + 1];
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                    pack_bf16(f[6], f[7]));
}

// x:      (R, d_in) f32 (kXf32) or bf16, d_in = M * 8
// codes:  (G_pad, d_out_pad) uint8, row g = n*M + m; d_out_pad % 16 == 0
// cb:     shared: (1, N, K, 8) in cb_dtype; per subvector: (M, N, K, 8) bf16
// scales: (d_out_pad,) f32 or null
// out:    (R, d_out) f32, written when gridDim.z == 1
// part:   (gridDim.z, R, d_out_pad) f32 partials when d_in is split
// Split z walks subvectors [z * m_split, (z + 1) * m_split), m_split a
// multiple of kMS.
//
// Thread (warp w, gid = lane / 4, tig = lane % 4) owns output columns
// 32w + 4gid + {0..3}: MMA tile mt's row gid is column 4gid + 2mt, row
// gid + 8 column 4gid + 2mt + 1.  In the k16 step over subvectors (s, s+1),
// MMA inputs {2tig, 2tig+1, 2tig+8, 2tig+9} are elements 4(tig%2) + {0..3}
// of subvector s + tig/2, in A (the weight) and B (x) alike.
template <class T>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
dequant_mm_bf16x2(const void* __restrict__ x, const uint8_t* __restrict__ codes,
                  const void* __restrict__ cb, int cb_dtype, const float* __restrict__ scales,
                  float* __restrict__ out, float* __restrict__ part, int R, int M, int N,
                  int K, int d_out, int d_out_pad, int m_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* cbs = reinterpret_cast<uint16_t*>(smem);
  unsigned char* ring = smem + T::kCbBytes;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int col0 = blockIdx.x * T::kBN, row0 = blockIdx.y * T::kBM;
  const int m_begin = blockIdx.z * m_split;
  const int m_end = min(M, m_begin + m_split);
  const int n_steps = (m_end - m_begin + T::kMS - 1) / T::kMS;
  const int d_in = M * kSub;
  const unsigned char* xb = static_cast<const unsigned char*>(x);

  // Stage t's codes, x and (per subvector) codebook slab into ring slot.
  auto load_stage = [&](int slot, int t) {
    unsigned char* st = ring + slot * T::kStageBytes;
    const int m0 = m_begin + t * T::kMS;
    constexpr int kCChunks = T::kBN / 16;
    for (int i = tid; i < N * T::kMS * kCChunks; i += T::kThreads) {
      const int row = i / kCChunks, c = i - row * kCChunks;
      const int n = row / T::kMS, m = m0 + row - n * T::kMS;
      const int col = col0 + c * 16;
      const bool ok = m < m_end && col < d_out_pad;
      cp_async16(st + row * T::kCLd + c * 16,
                 ok ? codes + static_cast<size_t>(n * M + m) * d_out_pad + col : codes, ok);
    }
    constexpr int kXChunks = T::kBK * T::kXElt / 16;
    constexpr int kPerChunk = 16 / T::kXElt;
    unsigned char* xs = st + T::kCodeBytes;
    for (int i = tid; i < T::kBM * kXChunks; i += T::kThreads) {
      const int r = i / kXChunks, c = i - r * kXChunks;
      const int e = m0 * kSub + c * kPerChunk;
      const bool ok = row0 + r < R && e < m_end * kSub;
      cp_async16(xs + (r * T::kXLd + c * kPerChunk) * T::kXElt,
                 ok ? xb + (static_cast<size_t>(row0 + r) * d_in + e) * T::kXElt : xb, ok);
    }
    if constexpr (!T::kSharedCb) {
      const int rows = N * K;  // 16-byte codebook rows a subvector
      unsigned char* slab = xs + T::kXBytes;
      const unsigned char* src = static_cast<const unsigned char*>(cb);
      for (int i = tid; i < T::kMS * rows; i += T::kThreads) {
        const int ms = i / rows;
        const bool ok = m0 + ms < m_end;
        cp_async16(slab + i * 16, ok ? src + (static_cast<size_t>(m0) * rows + i) * 16 : src,
                   ok);
      }
    }
  };

  if constexpr (T::kSharedCb) {
    for (int i = tid; i < N * K; i += T::kThreads)
      reinterpret_cast<uint4*>(cbs)[i] = cb_row_bf16(cb, i, cb_dtype);
  }
#pragma unroll
  for (int s = 0; s < T::kStages - 1; ++s) {
    if (s < n_steps) load_stage(s, s);
    cp_async_commit();
  }

  float acc[2][T::kNT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int half = tig & 1;
  for (int t = 0; t < n_steps; ++t) {
    cp_async_wait<T::kStages - 2>();
    __syncthreads();
    const int tn = t + T::kStages - 1;
    if (tn < n_steps) load_stage(tn % T::kStages, tn);
    cp_async_commit();

    const unsigned char* st = ring + (t % T::kStages) * T::kStageBytes;
    const unsigned char* xs = st + T::kCodeBytes;
    const uint16_t* cbp =
        T::kSharedCb ? cbs : reinterpret_cast<const uint16_t*>(xs + T::kXBytes);
#pragma unroll
    for (int kk = 0; kk < T::kMS / 2; ++kk) {
      const int ms = 2 * kk + (tig >> 1);
      const int xe = 16 * kk + 4 * tig;  // this thread's x elements in the stage
      uint32_t b[T::kNT][2];
#pragma unroll
      for (int nt = 0; nt < T::kNT; ++nt) {
        const int r = nt * 8 + gid;
        if constexpr (T::kXf32) {
          const float4 v = *reinterpret_cast<const float4*>(
              xs + (r * T::kXLd + xe) * 4);
          b[nt][0] = pack_bf16(v.x, v.y);
          b[nt][1] = pack_bf16(v.z, v.w);
        } else {
          const uint2 v = *reinterpret_cast<const uint2*>(xs + (r * T::kXLd + xe) * 2);
          b[nt][0] = v.x;
          b[nt][1] = v.y;
        }
      }
#pragma unroll
      for (int n = 0; n < kNMax; ++n) {
        if (n >= N) break;
        const uint32_t cw = *reinterpret_cast<const uint32_t*>(
            st + (n * T::kMS + ms) * T::kCLd + warp * kWarpCols + 4 * gid);
        const uint16_t* base =
            cbp + static_cast<size_t>(T::kSharedCb ? n * K : (ms * N + n) * K) * kSub + 4 * half;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const uint32_t lo = (cw >> (16 * mt)) & 0xffu, hi = (cw >> (16 * mt + 8)) & 0xffu;
          const uint2 wl = *reinterpret_cast<const uint2*>(base + lo * kSub);
          const uint2 wh = *reinterpret_cast<const uint2*>(base + hi * kSub);
          const uint32_t a[4] = {wl.x, wh.x, wl.y, wh.y};
#pragma unroll
          for (int nt = 0; nt < T::kNT; ++nt) mma_bf16(acc[mt][nt], a, b[nt]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // Columns c .. c+3; batch rows nt*8 + 2tig (even) and + 1 (odd).
  const int c = col0 + warp * kWarpCols + 4 * gid;
#pragma unroll
  for (int nt = 0; nt < T::kNT; ++nt)
#pragma unroll
    for (int odd = 0; odd < 2; ++odd) {
      const int r = row0 + nt * 8 + 2 * tig + odd;
      if (r >= R) continue;
      float v[4] = {acc[0][nt][odd], acc[0][nt][2 + odd], acc[1][nt][odd],
                    acc[1][nt][2 + odd]};
      if (gridDim.z > 1) {
        if (c < d_out_pad)
          *reinterpret_cast<float4*>(
              part + (static_cast<size_t>(blockIdx.z) * R + r) * d_out_pad + c) =
              make_float4(v[0], v[1], v[2], v[3]);
        continue;
      }
      if (scales != nullptr)
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] *= scales[min(c + i, d_out_pad - 1)];
      float* o = out + static_cast<size_t>(r) * d_out + c;
      if ((d_out & 3) == 0 && c + 3 < d_out) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (c + i < d_out) o[i] = v[i];
      }
    }
}

// out[r, j] = (sum_split part[split, r, j]) * s[j], splits in order.
__global__ void dequant_mm_reduce(const float* __restrict__ part,
                                  const float* __restrict__ scales, float* __restrict__ out,
                                  int R, int d_out, int d_out_pad, int n_splits) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(R) * d_out) return;
  const int r = static_cast<int>(idx / d_out);
  const int j = static_cast<int>(idx - static_cast<size_t>(r) * d_out);
  float s = 0.f;
  for (int sp = 0; sp < n_splits; ++sp)
    s += part[(static_cast<size_t>(sp) * R + r) * d_out_pad + j];
  if (scales != nullptr) s *= scales[j];
  out[idx] = s;
}

template <class T>
int launch(const void* x, const void* codes, const void* cb, int cb_dtype, const void* scales,
           void* out, void* part, int R, int M, int N, int K, int d_out, int d_out_pad,
           int m_split, int n_splits, cudaStream_t stream) {
  if (m_split % T::kMS != 0) return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        dequant_mm_bf16x2<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  dim3 grid((d_out + T::kBN - 1) / T::kBN, (R + T::kBM - 1) / T::kBM, n_splits);
  dequant_mm_bf16x2<T><<<grid, T::kThreads, T::kSmem, stream>>>(
      x, static_cast<const uint8_t*>(codes), cb, cb_dtype, static_cast<const float*>(scales),
      static_cast<float*>(out), static_cast<float*>(part), R, M, N, K, d_out, d_out_pad,
      m_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return static_cast<int>(err);
  const size_t n_out = static_cast<size_t>(R) * d_out;
  dequant_mm_reduce<<<static_cast<unsigned>((n_out + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const float*>(scales),
      static_cast<float*>(out), R, d_out, d_out_pad, n_splits);
  return static_cast<int>(cudaGetLastError());
}

// ---- every other even d_subvec and codebook count (the general instances) --
//
// The instances above are the 2x8 serving path (d_subvec 8, N <= 2).  Every
// other layer JAX's dequant_matmul takes with bf16x2 tables (even d_subvec,
// any N, K <= 256, shared or per-subvector codebooks: AQLM group 16, PQ,
// RQ, an unpacked T-MAC layer) runs this template, the same design with the
// stage's unit in INPUTS: one k16 step (16 inputs) and a group of up to kGrp
// codebooks a stage, so at d_subvec < 16 a stage spans 16/d subvectors and
// at d_subvec >= 16 a subvector spans d/16 stages that read the same code.
// - A thread's four MMA inputs are the step's inputs 4tig..4tig+3, as above.
//   At d % 4 == 0 they lie in one subvector: one code and one 8-byte load of
//   one codebook row.  At d % 4 == 2 (kPair) they fall on two subvectors:
//   two codes and two 4-byte loads.
// - A shared codebook of at most kStagedMax bytes (bf16) is staged once a
//   block, rounded as it is staged (kStaged).  A larger one (RQ: 4 x 256 x
//   128 bf16 = 256 KiB, over a block's 227 KB) and per-subvector ones ride
//   the ring: a stage carries its 16 inputs' d-chunk of every codebook row
//   of its group, [g][K][16] bf16 (8 KiB a codebook at K = 256), so no
//   codebook has to fit.
// - Codebook counts above kGrp loop over groups inside the ring (stage t is
//   k-step t / n_grp, group t % n_grp): N is a runtime loop, so one instance
//   serves every N, its stages sized for g = min(N, kGrp) codebooks (fewer
//   bytes a stage, more blocks an SM, at N = 1 or 2).
// - Split-K and the reduce are the instances' above; the plan
//   (plan_bf16x2) counts 16-input k-steps, and a split may start inside a
//   subvector (every stage loads the codes of the subvectors it touches).
// The inputs past the real ones of a step (d_in's or a split's end) read
// zero x; their A values come from a real input of the step, so a codebook
// row past K is never read and no NaN reaches the sum.

constexpr int kAnyBK = 16;             // inputs a stage: one k16 step
constexpr int kGrp = 4;                // codebooks a stage
constexpr int kSubRows = 9;            // subvectors 16 inputs can touch at even d
constexpr int kStagedMax = 64 * 1024;  // a shared codebook up to this is staged once
constexpr int kMaxSmem = 232448;       // a block's shared memory on the H100

template <int kWarps_, int kNT_, bool kXf32_, bool kStaged_, bool kPair_>
struct AnyTile {
  static constexpr int kWarps = kWarps_, kNT = kNT_;
  static constexpr bool kXf32 = kXf32_, kStaged = kStaged_, kPair = kPair_;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kBN = kWarps * kWarpCols;
  static constexpr int kBM = kNT * 8;
  static constexpr int kStages = kStaged ? 4 : 3;
  static constexpr int kXElt = kXf32 ? 4 : 2;
  static constexpr int kCLd = kBN + 32;
  static constexpr int kXBytes = kBM * kAnyBK * kXElt;
  // a stage holds g = min(N, kGrp) codebooks' code rows and slab
  __host__ __device__ static int code_bytes(int g) { return g * kSubRows * kCLd; }
  static int slab_bytes(int g, int K) { return kStaged ? 0 : g * K * kAnyBK * 2; }
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0));
}

// Element i of a codebook stored f32 (0), fp16 (1) or bf16 (2), as bf16 bits
// (round to nearest even, as torch's cast).
__device__ __forceinline__ uint16_t cb_elt_bf16(const void* cb, int i, int dtype) {
  if (dtype == 2) return static_cast<const uint16_t*>(cb)[i];
  const float f = dtype == 1 ? __half2float(static_cast<const __half*>(cb)[i])
                             : static_cast<const float*>(cb)[i];
  const __nv_bfloat16 b = __float2bfloat16_rn(f);
  return *reinterpret_cast<const uint16_t*>(&b);
}

// x: (R, d_in) f32 (kXf32) or bf16, d_in = M * D, D even
// cb: staged: (1, N, K, D) in cb_dtype; streamed: (1 or M, N, K, D) bf16
// Split z walks inputs [z * k_split, (z + 1) * k_split), k_split % 16 == 0.
template <class T>
__global__ void __launch_bounds__(T::kThreads)
dequant_mm_any(const void* __restrict__ x, const uint8_t* __restrict__ codes,
               const void* __restrict__ cb, int cb_dtype, int cb_shared,
               const float* __restrict__ scales, float* __restrict__ out,
               float* __restrict__ part, int R, int M, int N, int K, int D, int d_out,
               int d_out_pad, int k_split, int cb_bytes, int stage_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* cbs = reinterpret_cast<uint16_t*>(smem);
  unsigned char* ring = smem + cb_bytes;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int col0 = blockIdx.x * T::kBN, row0 = blockIdx.y * T::kBM;
  const int d_in = M * D;
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(d_in, k_begin + k_split);
  const int n_grp = (N + kGrp - 1) / kGrp;
  const int n_steps = (k_end - k_begin + kAnyBK - 1) / kAnyBK * n_grp;
  const int code_bytes = T::code_bytes(min(N, kGrp));
  const bool x16 = (d_in * T::kXElt) % 16 == 0;  // x rows start 16-byte aligned
  const unsigned char* xb = static_cast<const unsigned char*>(x);

  auto load_stage = [&](int slot, int t) {
    unsigned char* st = ring + slot * stage_bytes;
    const int kstep = t / n_grp, g = t - kstep * n_grp;
    const int k0 = k_begin + kstep * kAnyBK, kl = min(k_end, k0 + kAnyBK);
    const int n0 = g * kGrp, ng = min(kGrp, N - n0);
    const int m_lo = k0 / D, nsub = (kl - 1) / D + 1 - m_lo;
    constexpr int kCChunks = T::kBN / 16;
    for (int i = tid; i < ng * nsub * kCChunks; i += T::kThreads) {
      const int row = i / kCChunks, c = i - row * kCChunks;
      const int nl = row / nsub, j = row - nl * nsub;
      const int col = col0 + c * 16;
      const bool ok = col < d_out_pad;
      cp_async16(st + (nl * kSubRows + j) * T::kCLd + c * 16,
                 ok ? codes + static_cast<size_t>((n0 + nl) * M + m_lo + j) * d_out_pad + col
                    : codes,
                 ok);
    }
    unsigned char* xs = st + code_bytes;
    if (x16) {
      constexpr int kPer = 16 / T::kXElt, kChunks = kAnyBK / kPer;
      for (int i = tid; i < T::kBM * kChunks; i += T::kThreads) {
        const int r = i / kChunks, c = i - r * kChunks;
        const int e = k0 + c * kPer;
        const bool ok = row0 + r < R && e < kl;
        cp_async16(xs + (r * kAnyBK + c * kPer) * T::kXElt,
                   ok ? xb + (static_cast<size_t>(row0 + r) * d_in + e) * T::kXElt : xb, ok);
      }
    } else {
      constexpr int kPer = 4 / T::kXElt, kChunks = kAnyBK / kPer;
      for (int i = tid; i < T::kBM * kChunks; i += T::kThreads) {
        const int r = i / kChunks, c = i - r * kChunks;
        const int e = k0 + c * kPer;
        const bool ok = row0 + r < R && e < kl;
        cp_async4(xs + (r * kAnyBK + c * kPer) * T::kXElt,
                  ok ? xb + (static_cast<size_t>(row0 + r) * d_in + e) * T::kXElt : xb, ok);
      }
    }
    if constexpr (!T::kStaged) {
      uint16_t* slab = reinterpret_cast<uint16_t*>(xs + T::kXBytes);  // [g][K][16]
      const uint16_t* src = static_cast<const uint16_t*>(cb);
      // codebook element (m, n, k, w), m = 0 for a shared codebook
      auto at = [&](int e, int n, int k) {
        const int m = e / D;
        return (static_cast<size_t>((cb_shared ? 0 : m) * N + n) * K + k) * D + (e - m * D);
      };
      if (D % 8 == 0) {  // two 16-byte runs of 8 inputs a codebook row
        for (int i = tid; i < ng * K * 2; i += T::kThreads) {
          const int h = i & 1, row = i >> 1, nl = row / K;
          const int e = k0 + 8 * h;
          const bool ok = e < kl;
          cp_async16(slab + row * kAnyBK + 8 * h, ok ? src + at(e, n0 + nl, row - nl * K) : src,
                     ok);
        }
      } else {  // eight 4-byte runs of 2 inputs
        for (int i = tid; i < ng * K * 8; i += T::kThreads) {
          const int p = i & 7, row = i >> 3, nl = row / K;
          const int e = k0 + 2 * p;
          const bool ok = e < kl;
          cp_async4(slab + row * kAnyBK + 2 * p, ok ? src + at(e, n0 + nl, row - nl * K) : src,
                    ok);
        }
      }
    }
  };

  if constexpr (T::kStaged) {
    for (int i = tid; i < N * K * D; i += T::kThreads) cbs[i] = cb_elt_bf16(cb, i, cb_dtype);
  }
#pragma unroll
  for (int s = 0; s < T::kStages - 1; ++s) {
    if (s < n_steps) load_stage(s, s);
    cp_async_commit();
  }

  float acc[2][T::kNT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int t = 0; t < n_steps; ++t) {
    cp_async_wait<T::kStages - 2>();
    __syncthreads();
    const int tn = t + T::kStages - 1;
    if (tn < n_steps) load_stage(tn % T::kStages, tn);
    cp_async_commit();

    const unsigned char* st = ring + (t % T::kStages) * stage_bytes;
    const unsigned char* xs = st + code_bytes;
    const uint16_t* slab = reinterpret_cast<const uint16_t*>(xs + T::kXBytes);
    const int kstep = t / n_grp, g = t - kstep * n_grp;
    const int k0 = k_begin + kstep * kAnyBK, kl = min(k_end, k0 + kAnyBK);
    const int n0 = g * kGrp, ng = min(kGrp, N - n0);
    const int m_lo = k0 / D;
    uint32_t b[T::kNT][2];
#pragma unroll
    for (int nt = 0; nt < T::kNT; ++nt) {
      const int r = nt * 8 + gid;
      if constexpr (T::kXf32) {
        const float4 v = *reinterpret_cast<const float4*>(xs + (r * kAnyBK + 4 * tig) * 4);
        b[nt][0] = pack_bf16(v.x, v.y);
        b[nt][1] = pack_bf16(v.z, v.w);
      } else {
        const uint2 v = *reinterpret_cast<const uint2*>(xs + (r * kAnyBK + 4 * tig) * 2);
        b[nt][0] = v.x;
        b[nt][1] = v.y;
      }
    }
    const unsigned char* crow = st + warp * kWarpCols + 4 * gid;
    for (int nl = 0; nl < ng; ++nl) {
      const int n = n0 + nl;
      const uint16_t* cbn = T::kStaged ? cbs + static_cast<size_t>(n) * K * D
                                       : slab + nl * K * kAnyBK;
      const int stride = T::kStaged ? D : kAnyBK;
      if constexpr (!T::kPair) {
        const int i = min(k0 + 4 * tig, kl - 4);  // a real input of the step
        const int m = i / D;
        const uint32_t cw =
            *reinterpret_cast<const uint32_t*>(crow + (nl * kSubRows + m - m_lo) * T::kCLd);
        const uint16_t* base = cbn + (T::kStaged ? i - m * D : i - k0);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const uint32_t lo = (cw >> (16 * mt)) & 0xffu, hi = (cw >> (16 * mt + 8)) & 0xffu;
          const uint2 wl = *reinterpret_cast<const uint2*>(base + lo * stride);
          const uint2 wh = *reinterpret_cast<const uint2*>(base + hi * stride);
          const uint32_t a[4] = {wl.x, wh.x, wl.y, wh.y};
#pragma unroll
          for (int nt = 0; nt < T::kNT; ++nt) mma_bf16(acc[mt][nt], a, b[nt]);
        }
      } else {
        const int i0 = min(k0 + 4 * tig, kl - 2), i1 = min(k0 + 4 * tig + 2, kl - 2);
        const int m0 = i0 / D, m1 = i1 / D;
        const uint32_t cw0 =
            *reinterpret_cast<const uint32_t*>(crow + (nl * kSubRows + m0 - m_lo) * T::kCLd);
        const uint32_t cw1 =
            *reinterpret_cast<const uint32_t*>(crow + (nl * kSubRows + m1 - m_lo) * T::kCLd);
        const uint16_t* b0 = cbn + (T::kStaged ? i0 - m0 * D : i0 - k0);
        const uint16_t* b1 = cbn + (T::kStaged ? i1 - m1 * D : i1 - k0);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const uint32_t lo0 = (cw0 >> (16 * mt)) & 0xffu, hi0 = (cw0 >> (16 * mt + 8)) & 0xffu;
          const uint32_t lo1 = (cw1 >> (16 * mt)) & 0xffu, hi1 = (cw1 >> (16 * mt + 8)) & 0xffu;
          const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(b0 + lo0 * stride),
                                 *reinterpret_cast<const uint32_t*>(b0 + hi0 * stride),
                                 *reinterpret_cast<const uint32_t*>(b1 + lo1 * stride),
                                 *reinterpret_cast<const uint32_t*>(b1 + hi1 * stride)};
#pragma unroll
          for (int nt = 0; nt < T::kNT; ++nt) mma_bf16(acc[mt][nt], a, b[nt]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const int c = col0 + warp * kWarpCols + 4 * gid;
#pragma unroll
  for (int nt = 0; nt < T::kNT; ++nt)
#pragma unroll
    for (int odd = 0; odd < 2; ++odd) {
      const int r = row0 + nt * 8 + 2 * tig + odd;
      if (r >= R) continue;
      float v[4] = {acc[0][nt][odd], acc[0][nt][2 + odd], acc[1][nt][odd],
                    acc[1][nt][2 + odd]};
      if (gridDim.z > 1) {
        if (c < d_out_pad)
          *reinterpret_cast<float4*>(
              part + (static_cast<size_t>(blockIdx.z) * R + r) * d_out_pad + c) =
              make_float4(v[0], v[1], v[2], v[3]);
        continue;
      }
      if (scales != nullptr)
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] *= scales[min(c + i, d_out_pad - 1)];
      float* o = out + static_cast<size_t>(r) * d_out + c;
      if ((d_out & 3) == 0 && c + 3 < d_out) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (c + i < d_out) o[i] = v[i];
      }
    }
}

template <class T>
int launch_any(const void* x, const void* codes, const void* cb, int cb_dtype, int cb_shared,
               const void* scales, void* out, void* part, int R, int M, int N, int K, int D,
               int d_out, int d_out_pad, int k_split, int n_splits, cudaStream_t stream) {
  if (k_split % kAnyBK != 0 || (!T::kStaged && cb_dtype != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int cb_bytes = T::kStaged ? (N * K * D * 2 + 15) / 16 * 16 : 0;
  const int g = N < kGrp ? N : kGrp;
  const int stage_bytes = T::code_bytes(g) + T::kXBytes + T::slab_bytes(g, K);
  const int smem = cb_bytes + T::kStages * stage_bytes;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        dequant_mm_any<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  dim3 grid((d_out + T::kBN - 1) / T::kBN, (R + T::kBM - 1) / T::kBM, n_splits);
  dequant_mm_any<T><<<grid, T::kThreads, smem, stream>>>(
      x, static_cast<const uint8_t*>(codes), cb, cb_dtype, cb_shared,
      static_cast<const float*>(scales), static_cast<float*>(out), static_cast<float*>(part),
      R, M, N, K, D, d_out, d_out_pad, k_split, cb_bytes, stage_bytes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return static_cast<int>(err);
  const size_t n_out = static_cast<size_t>(R) * d_out;
  dequant_mm_reduce<<<static_cast<unsigned>((n_out + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const float*>(scales),
      static_cast<float*>(out), R, d_out, d_out_pad, n_splits);
  return static_cast<int>(cudaGetLastError());
}

template <bool kStaged, bool kPair>
int launch_any_config(int config, const void* x, const void* codes, const void* cb,
                      int cb_dtype, int cb_shared, const void* scales, void* out, void* part,
                      int R, int M, int N, int K, int D, int d_out, int d_out_pad, int k_split,
                      int n_splits, cudaStream_t stream) {
#define LUTVQ_DQA_ARGS x, codes, cb, cb_dtype, cb_shared, scales, out, part, R, M, N, K, D, \
                       d_out, d_out_pad, k_split, n_splits, stream
  switch (config) {
    case 0: return launch_any<AnyTile<4, 1, true, kStaged, kPair>>(LUTVQ_DQA_ARGS);
    case 1: return launch_any<AnyTile<4, 2, true, kStaged, kPair>>(LUTVQ_DQA_ARGS);
    case 2: return launch_any<AnyTile<8, 8, false, kStaged, kPair>>(LUTVQ_DQA_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LUTVQ_DQA_ARGS
}

}  // namespace

// config (kernels/dequant_mm.py::plan_bf16x2): 0 = 8 rows a block, 1 = 16
// rows (x f32, 4 warps), 2 = 64 rows (x bf16, 8 warps).  cb_dtype 0 f32, 1
// fp16, 2 bf16 (a streamed codebook, per-subvector or a shared one over
// kStagedMax bytes, must be bf16).  n_splits > 1 needs part, (n_splits, R,
// d_out_pad) f32; every split must hold an input.  Split z takes inputs
// [z * k_split, (z + 1) * k_split): d_subvec 8 with N <= 2 runs the 2x8
// instances (k_split a whole stage of subvectors), every other even
// d_subvec and N the general ones (k_split % 16 == 0).
extern "C" int lutvq_dequant_mm(const void* x, const void* codes, const void* cb,
                                const void* scales, void* out, void* part, int R, int M, int N,
                                int K, int D, int cb_shared, int cb_dtype, int config,
                                int d_out, int d_out_pad, int k_split, int n_splits,
                                void* stream_ptr) {
  const long d_in = static_cast<long>(M) * D;
  if (N < 1 || K < 1 || K > kKMax || D < 2 || D % 2 != 0 || cb_dtype < 0 || cb_dtype > 2 ||
      (!cb_shared && cb_dtype != 2) || d_out_pad % 16 != 0 || d_out > d_out_pad ||
      k_split < 1 || n_splits < 1 || static_cast<long>(k_split) * n_splits < d_in ||
      static_cast<long>(k_split) * (n_splits - 1) >= d_in || (n_splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (D != kSub || N > kNMax) {
    const bool staged = cb_shared && N * K * D * 2 <= kStagedMax;
#define LUTVQ_DQA_ARGS config, x, codes, cb, cb_dtype, cb_shared, scales, out, part, R, M, N, \
                       K, D, d_out, d_out_pad, k_split, n_splits, stream
    if (D % 4 == 0)
      return staged ? launch_any_config<true, false>(LUTVQ_DQA_ARGS)
                    : launch_any_config<false, false>(LUTVQ_DQA_ARGS);
    return staged ? launch_any_config<true, true>(LUTVQ_DQA_ARGS)
                  : launch_any_config<false, true>(LUTVQ_DQA_ARGS);
#undef LUTVQ_DQA_ARGS
  }
  if (k_split % kSub != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int m_split = k_split / kSub;
#define LUTVQ_DQ_ARGS x, codes, cb, cb_dtype, scales, out, part, R, M, N, K, d_out, d_out_pad, \
                      m_split, n_splits, stream
  switch (config * 2 + (cb_shared ? 1 : 0)) {
    case 0: return launch<Tile<4, 1, true, false>>(LUTVQ_DQ_ARGS);
    case 1: return launch<Tile<4, 1, true, true>>(LUTVQ_DQ_ARGS);
    case 2: return launch<Tile<4, 2, true, false>>(LUTVQ_DQ_ARGS);
    case 3: return launch<Tile<4, 2, true, true>>(LUTVQ_DQ_ARGS);
    case 4: return launch<Tile<8, 8, false, false>>(LUTVQ_DQ_ARGS);
    case 5: return launch<Tile<8, 8, false, true>>(LUTVQ_DQ_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LUTVQ_DQ_ARGS
}
