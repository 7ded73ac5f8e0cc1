// Lookup-accumulate over nibble-packed 4-bit codes with 2-8 tokens' bf16
// tables (T-MAC W4 projections at B >= 2), for Hopper (sm_90a).
//
// Replaces tpu_lutvq/kernels/lut_gemv.py::_gemv_kernel_nibbles_bpair (:658):
//     y[b, j] = s[j] * sum_r (tab[b, 2r, codes_t[r, j] & 15] + tab[b, 2r+1, codes_t[r, j] >> 4])
// with bf16 entries summed in f32.  (J1, the one-token f32 tables, stays in
// lut_scan.cu.)
//
// What bounds it on the H100.  The codes are the only large input: R * d_out
// bytes for R = G / 2 code rows (8 MiB at 4096 x 4096, 2.5 us at 3.35 TB/s).
// But every code byte and column reads two table entries of BP tokens from
// shared memory, 32 B at BP = 8, so the lookups move 16x the code bytes
// through the SMs' shared memory: at 128 B/clk an SM, 2048 x 4096 x 32 B
// take >= 8 us at 4096 x 4096 and >= 56 us at 4096 -> 28672 at 1980 MHz
// (the lookup formulation's floor; chip_smoke.py prints it beside the bytes
// bound).  Each entry also costs one integer op to widen bf16 to f32, and
// the integer pipe runs at half the f32 rate: ~14 us at 4096 x 4096.
// The design:
//   - the table is laid out (row, token quad, lo/hi group, k, 4 tokens), so a
//     group's 16 entries of one token quad are 128 B, one bank row: the lanes
//     of a warp all look up the same code row, and their 8-byte loads are
//     free of bank conflicts whatever the codes (the byte-code layout (g, k,
//     token) put entries k and k + 8 in one bank quad);
//   - a block owns a tile of TC output columns and one split of the code
//     rows; its 512 threads (16 warps: the stage fills the shared memory, so
//     one block runs on an SM and its warps hide the latency) take 4 columns
//     each (one 32-bit code load a row), in 2048 / TC row groups that
//     interleave the split's rows, the next 4 rows' codes loaded while
//     this 4's are looked up; the split's tables are staged through cp.async
//     in rounds of at most 128 KiB, the first code loads in flight meanwhile;
//   - the n_splits (<= 8) blocks of a column tile form one thread-block
//     cluster: each block sums its row groups in order, and then each sums
//     its share of the tile's outputs over the cluster's blocks in rank
//     order, reading their shared memory (distributed shared memory).  No
//     partial reaches device memory, there is no second launch, and two
//     calls are bit-equal.
// kernels/lut_gemv.py::plan_nibbles picks TC and the splits from (code rows,
// width, tokens, SMs) and how many clusters the card holds at once
// (lutvq_lut_nibbles_bf16_clusters: 15 of 8 such blocks on an H100, not 16,
// so 16 tiles of 8 splits would take two waves); rounds make any split fit,
// so every shape takes one cluster per column tile.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kCols = 4;                          // output columns a thread
constexpr int kSpan = kThreads * kCols;           // columns x row groups of a block
constexpr int kK = 16;                            // entries a group
constexpr int kMaxSplits = 8;                     // portable cluster size
constexpr int kPrefetch = 4;                      // code rows loaded ahead

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// TQ consecutive bf16 entries (2 or 4 tokens) added to acc in f32.
template <int TQ>
__device__ __forceinline__ void add_quad(float* acc, const uint16_t* p) {
  if constexpr (TQ == 4) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    acc[0] += __uint_as_float(w.x << 16);
    acc[1] += __uint_as_float(w.x & 0xffff0000u);
    acc[2] += __uint_as_float(w.y << 16);
    acc[3] += __uint_as_float(w.y & 0xffff0000u);
  } else {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    acc[0] += __uint_as_float(w << 16);
    acc[1] += __uint_as_float(w & 0xffff0000u);
  }
}

// tab:    (R, BP / TQ, 2, 16, TQ) bf16 bits: row r's low-nibble group 2r and
//         high-nibble group 2r+1, each token quad's 16 entries contiguous
// codes:  (R_pad, d_out_pad) uint8, row r holding groups 2r (low) and 2r+1
// out:    (B, d_out) f32
template <int BP>
__global__ void __launch_bounds__(kThreads)
lut_nibbles_bf16(const uint16_t* __restrict__ tab, const uint8_t* __restrict__ codes,
                 const float* __restrict__ scales, float* __restrict__ out, int B, int R,
                 int d_out, int d_out_pad, int tile_cols, int slice_rows, int stage_rows) {
  constexpr int TQ = BP < 4 ? BP : 4;
  constexpr int QN = BP / TQ;
  constexpr int kRowElems = 2 * kK * BP;          // bf16 entries of one code row
  extern __shared__ __align__(16) unsigned char smem[];
  const uint16_t* stage = reinterpret_cast<const uint16_t*>(smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_splits = static_cast<int>(cluster.num_blocks());
  const int groups = kSpan / tile_cols;           // row groups of the block
  const int rg = threadIdx.x / (tile_cols / kCols);
  const int col0 = blockIdx.x * tile_cols + (threadIdx.x % (tile_cols / kCols)) * kCols;
  const bool active = col0 < d_out_pad;           // d_out_pad % 128 == 0
  const int r_begin = min(R, rank * slice_rows);
  const int r_end = min(R, r_begin + slice_rows);
  const uint8_t* cbase = codes + col0;

  float acc[kCols][BP];
#pragma unroll
  for (int c = 0; c < kCols; ++c)
#pragma unroll
    for (int b = 0; b < BP; ++b) acc[c][b] = 0.f;

  for (int s0 = r_begin; s0 < r_end; s0 += stage_rows) {
    const int s1 = min(r_end, s0 + stage_rows);
    __syncthreads();                              // earlier reads of the stage are done
    {
      const unsigned char* src = reinterpret_cast<const unsigned char*>(tab) +
                                 static_cast<size_t>(s0) * kRowElems * 2;
      const int n16 = (s1 - s0) * kRowElems * 2 / 16;
      for (int i = threadIdx.x; i < n16; i += kThreads) cp_async16(smem + i * 16, src + i * 16);
      asm volatile("cp.async.commit_group;\n" ::);
    }
    // the first rows' codes while the tables arrive
    uint32_t next[kPrefetch];
    const int i0 = s0 + rg;
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      const int row = i0 + u * groups;
      next[u] = (active && row < s1)
                    ? __ldg(reinterpret_cast<const uint32_t*>(cbase + static_cast<size_t>(row) * d_out_pad))
                    : 0u;
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    if (!active) continue;
    for (int i = i0; i < s1; i += kPrefetch * groups) {
      uint32_t cur[kPrefetch];
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u) {
        cur[u] = next[u];
        const int row = i + (kPrefetch + u) * groups;
        next[u] = row < s1 ? __ldg(reinterpret_cast<const uint32_t*>(
                                 cbase + static_cast<size_t>(row) * d_out_pad))
                           : 0u;
      }
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u) {
        const int row = i + u * groups;
        if (row >= s1) break;
        const uint16_t* t = stage + (row - s0) * kRowElems;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const uint32_t code = (cur[u] >> (8 * c)) & 0xffu;
#pragma unroll
          for (int q = 0; q < QN; ++q) {
            add_quad<TQ>(acc[c] + q * TQ, t + (2 * q) * kK * TQ + (code & 0xfu) * TQ);
            add_quad<TQ>(acc[c] + q * TQ, t + (2 * q + 1) * kK * TQ + (code >> 4) * TQ);
          }
        }
      }
    }
  }

  // the row groups' sums in order, into this block's partial (token, column)
  __syncthreads();                                // the stage is free
  float* red = reinterpret_cast<float*>(smem);    // [groups][BP][tile_cols]
  const int stage_bytes = stage_rows * kRowElems * 2;
  const int red_bytes = kSpan * BP * 4;
  float* part = reinterpret_cast<float*>(smem + (stage_bytes > red_bytes ? stage_bytes : red_bytes));
  const int lc = col0 - blockIdx.x * tile_cols;
#pragma unroll
  for (int b = 0; b < BP; ++b)
#pragma unroll
    for (int c = 0; c < kCols; ++c) red[(rg * BP + b) * tile_cols + lc + c] = acc[c][b];
  __syncthreads();
  const int n = BP * tile_cols;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    float s = red[e];
    for (int g = 1; g < groups; ++g) s += red[g * n + e];
    part[e] = s;
  }

  // each block sums its share of the tile over the cluster, in rank order
  cluster.sync();
  for (int e = rank * kThreads + threadIdx.x; e < n; e += n_splits * kThreads) {
    const int b = e / tile_cols, j = blockIdx.x * tile_cols + e % tile_cols;
    float s = 0.f;
    for (int q = 0; q < n_splits; ++q) s += cluster.map_shared_rank(part, q)[e];
    if (b < B && j < d_out) out[static_cast<size_t>(b) * d_out + j] = scales ? s * scales[j] : s;
  }
  cluster.sync();                                 // no block leaves while its part is read
}

// The launch configuration of a (tile_cols, n_splits, stage_rows) plan, its
// shared memory granted; attr holds the cluster shape.
template <int BP>
cudaError_t configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int tiles,
                      int tile_cols, int n_splits, int stage_rows, cudaStream_t stream) {
  const int stage_bytes = stage_rows * 2 * kK * BP * 2;
  const int red_bytes = kSpan * BP * 4;
  const int smem = (stage_bytes > red_bytes ? stage_bytes : red_bytes) + tile_cols * BP * 4;
  *cfg = {};
  cfg->gridDim = dim3(tiles, n_splits);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = n_splits;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaFuncSetAttribute(lut_nibbles_bf16<BP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <int BP>
int launch(const void* tab, const void* codes, const void* scales, void* out, int B, int R,
           int d_out, int d_out_pad, int tile_cols, int n_splits, int slice_rows,
           int stage_rows, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure<BP>(&cfg, &attr, (d_out_pad + tile_cols - 1) / tile_cols, tile_cols,
                                n_splits, stage_rows, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaLaunchKernelEx(&cfg, lut_nibbles_bf16<BP>, static_cast<const uint16_t*>(tab),
                         static_cast<const uint8_t*>(codes), static_cast<const float*>(scales),
                         static_cast<float*>(out), B, R, d_out, d_out_pad, tile_cols,
                         slice_rows, stage_rows);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of the plan the card holds at once (or a negative error).
template <int BP>
int max_clusters(int tile_cols, int n_splits, int stage_rows) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure<BP>(&cfg, &attr, 1, tile_cols, n_splits, stage_rows, 0);
  int n = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&n, lut_nibbles_bf16<BP>, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

}  // namespace

// R code rows; the block's column tile tile_cols in {128, 256, 512, 1024};
// n_splits (<= 8) blocks of slice_rows code rows each form a cluster; the
// tables are staged stage_rows code rows at a time.
extern "C" int lutvq_lut_nibbles_bf16(const void* tab, const void* codes, const void* scales,
                                      void* out, int B, int BP, int R, int d_out,
                                      int d_out_pad, int tile_cols, int n_splits,
                                      int slice_rows, int stage_rows, void* stream_ptr) {
  if (tile_cols < 128 || tile_cols > kSpan || kSpan % tile_cols || n_splits < 1 ||
      n_splits > kMaxSplits || slice_rows < 1 || stage_rows < 1 || B > BP)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || d_out == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
#define LUTVQ_NIB_ARGS tab, codes, scales, out, B, R, d_out, d_out_pad, tile_cols, n_splits, \
                       slice_rows, stage_rows, st
  switch (BP) {
    case 2: return launch<2>(LUTVQ_NIB_ARGS);
    case 4: return launch<4>(LUTVQ_NIB_ARGS);
    case 8: return launch<8>(LUTVQ_NIB_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LUTVQ_NIB_ARGS
}

// Clusters of a (tile_cols, n_splits, stage_rows) plan that fit the card at
// once (cudaOccupancyMaxActiveClusters), or minus a CUDA error.
extern "C" int lutvq_lut_nibbles_bf16_clusters(int BP, int tile_cols, int n_splits,
                                               int stage_rows) {
  switch (BP) {
    case 2: return max_clusters<2>(tile_cols, n_splits, stage_rows);
    case 4: return max_clusters<4>(tile_cols, n_splits, stage_rows);
    case 8: return max_clusters<8>(tile_cols, n_splits, stage_rows);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}
