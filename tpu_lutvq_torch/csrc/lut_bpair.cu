// Lookup-accumulate over byte codes with 2-8 tokens' tables, the entries
// rounded to bf16 (the LUT-GEMV projections at B >= 2), for Hopper (sm_90a).
//
// Replaces tpu_lutvq/kernels/lut_gemv.py::_gemv_kernel_bpair (:376):
//     y[b, j] = s[j] * sum_g bf16(lut[b, g, codes_t[g, j]])     (f32 sum)
// (A and M, the one-token pair kernels, are lut_scan.cu's kind 0.)
//
// What bounds it on the H100.  The codes, G * d_out bytes (4 MiB at 4096 x
// 4096, 1.3 us at 3.35 TB/s), and the f32 tables, B * G * Kp * 4 bytes (8
// MiB at B = 8).  But every block stages its tables through its own SM
// (one SM pulls ~114 GB/s from the L2), and every code byte and column reads
// the block's tokens' bf16 entries from shared memory: 16 B at 8 tokens,
// 16x the code bytes (the lookup floor: G * d_out * 2 B a token at 128 B/clk
// an SM, ~2 us at 4096 x 4096 B = 8; chip_smoke.py prints it).  With K =
// 256 a group's table spans many bank rows and the codes are random, so a
// warp's lookups meet bank conflicts whatever the layout (unlike J2's K =
// 16 in lut_nibbles.cu).  The first version ran 128-thread blocks over
// 512-column tiles with no overlap and f32 partials in a workspace summed
// by a second kernel, after two host passes that cast the table to bf16
// and permuted it.
// The design (J2's skeleton):
//   - the kernel reads build_lut's (B, G, Kp) f32 tables as they are and
//     rounds each entry to bf16 (nearest even, as torch's cast) on its way
//     into shared memory, laid out (group, k, token), so one 8-byte load
//     gives a block's four tokens' entries (4 bytes for two); tokens past B
//     are zeros;
//   - tokens go in blocks of 4 (2 when B = 2) along grid z, so a block
//     stages only its tokens' tables;
//   - staging goes through registers: round t + 1's entries (32 floats a
//     thread) and code words are loaded while round t is looked up, then
//     rounded into the other of two bf16 tables, one barrier a round (a
//     cp.async staging ring in shared memory spent 6 B of shared memory an
//     entry on the conversion instead of 2, and was slower);
//   - a block owns a tile of TC output columns and one split of the groups;
//     its 256 threads take 4 columns each (one 32-bit code load a group), in
//     1024 / TC row groups that interleave the split's groups, U groups a
//     thread a round (a template constant: the lookups have no branch); two
//     blocks fit an SM, so twice as many clusters fit the card at once;
//   - the n_splits (<= 16) blocks of a column tile form one thread-block
//     cluster: each sums its row groups in order, then a share of the tile's
//     outputs over the cluster's blocks in rank order through distributed
//     shared memory.  No workspace, one launch, two calls bit-equal.
// kernels/lut_gemv.py::plan_bpair picks TC, the splits and the round size
// from (groups, width, tokens, Kp, SMs) and how many clusters the card holds
// at once (lutvq_lut_bpair_clusters).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;                          // output columns a thread
constexpr int kSpan = kThreads * kCols;           // columns x row groups of a block
constexpr int kMaxSplits = 16;                    // 8 portable, 16 where the card allows
constexpr int kStageEntries = 8192;               // table entries (groups x Kp x TB) a round
constexpr int kLoads = kStageEntries / (4 * kThreads);  // float4 loads a thread a round
constexpr int kMaxU = 8;                          // groups a thread looks up a round

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The TB consecutive bf16 entries at p (one per token) added to acc in f32.
template <int TB>
__device__ __forceinline__ void add_entries(float (&acc)[TB], const uint16_t* p) {
  uint32_t w[TB / 2];
  if constexpr (TB == 2) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  }
#pragma unroll
  for (int i = 0; i < TB / 2; ++i) {
    acc[2 * i] += __uint_as_float(w[i] << 16);               // lower address
    acc[2 * i + 1] += __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Shared memory of a (TB, tile_cols) launch: two bf16 tables (stage_groups,
// Kp, TB) and the block's partial (TB, tile_cols); the row-group sums of
// the reduce reuse the tables.
struct Layout {
  int part, total;
  __host__ __device__ Layout(int tb, int tile_cols) {
    part = 2 * kStageEntries * 2;
    const int red = kSpan * tb * 4;
    if (part < red) part = red;
    total = part + tile_cols * tb * 4;
  }
};

// lut:    (B, G, Kp) f32, as build_lut writes it
// codes:  (G_pad, d_out_pad) uint8, n-major groups
// out:    (B, d_out) f32
// Block (x, q, z) takes column tile x, tokens [TB z, TB z + TB) and groups
// [q * slice_groups, ...) of its cluster's split, in rounds of stage_groups
// = U * row groups, each thread looking up U of them a round
// (stage_groups * Kp * TB = kStageEntries, or fewer with a short split).
// Round t + 1's entries and codes are loaded into registers while round t
// is looked up; they are rounded into the other bf16 table, one barrier a
// round.  A short last round looks up zero rows (adding +0 leaves every sum
// as it is), so the lookup loop has no branch.
template <int TB, int U>
__global__ void __launch_bounds__(kThreads, 2)
lut_bpair(const float* __restrict__ lut, const uint8_t* __restrict__ codes,
          const float* __restrict__ scales, float* __restrict__ out, int B, int G, int Kp,
          int d_out, int d_out_pad, int tile_cols, int slice_groups, int stage_groups) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(TB, tile_cols);
  uint16_t* tabs = reinterpret_cast<uint16_t*>(smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_splits = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x;
  const int groups = kSpan / tile_cols;           // row groups of the block
  const int rg = tid / (tile_cols / kCols);
  const int lc = (tid % (tile_cols / kCols)) * kCols;
  const int tile0 = blockIdx.x * tile_cols;
  const bool active = tile0 + lc < d_out_pad;     // d_out_pad % 128 == 0
  const int b0 = blockIdx.z * TB;                 // this block's first token
  const int nb = min(TB, B - b0);
  const int g_begin = min(G, rank * slice_groups);
  const int g_end = min(G, g_begin + slice_groups);
  const int n_rounds = (g_end - g_begin + stage_groups - 1) / stage_groups;
  const int kq_n = Kp / 4;
  const int items = stage_groups * kq_n;          // (group, 4 k) pieces a round
  const uint8_t* cbase = codes + tile0 + lc;

  float4 pf[kLoads / TB][TB];                     // a round's entries: TB tokens x 4 k a piece
  uint32_t cw[U];
  // round t's f32 entries (this block's real tokens) and this thread's code
  // words into registers; zeros past B and past the split
  auto load = [&](int t) {
    const int g0 = g_begin + t * stage_groups;
#pragma unroll
    for (int it = 0; it < kLoads / TB; ++it) {
      const int idx = tid + it * kThreads;
      const int g = g0 + idx / kq_n, kq = idx % kq_n;
      const bool ok = idx < items && g < g_end;
#pragma unroll
      for (int b = 0; b < TB; ++b)
        pf[it][b] = ok && b < nb
                        ? __ldg(reinterpret_cast<const float4*>(
                                    lut + (static_cast<size_t>(b0 + b) * G + g) * Kp) + kq)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int g = g0 + rg + u * groups;
      cw[u] = active && g < g_end
                  ? __ldg(reinterpret_cast<const uint32_t*>(cbase + static_cast<size_t>(g) * d_out_pad))
                  : 0u;
    }
  };
  // the registers' entries rounded to bf16 (nearest even, as torch's cast)
  // into table tab, (group, k, token) order
  auto store = [&](uint16_t* tab) {
#pragma unroll
    for (int it = 0; it < kLoads / TB; ++it) {
      const int idx = tid + it * kThreads;
      if (idx < items) {
        uint4* dst = reinterpret_cast<uint4*>(tab + idx * 4 * TB);
        const float4* v = pf[it];
        if constexpr (TB == 4) {
          dst[0] = make_uint4(bf16x2(v[0].x, v[1].x), bf16x2(v[2].x, v[3].x),
                              bf16x2(v[0].y, v[1].y), bf16x2(v[2].y, v[3].y));
          dst[1] = make_uint4(bf16x2(v[0].z, v[1].z), bf16x2(v[2].z, v[3].z),
                              bf16x2(v[0].w, v[1].w), bf16x2(v[2].w, v[3].w));
        } else {
          dst[0] = make_uint4(bf16x2(v[0].x, v[1].x), bf16x2(v[0].y, v[1].y),
                              bf16x2(v[0].z, v[1].z), bf16x2(v[0].w, v[1].w));
        }
      }
    }
  };

  float acc[kCols][TB];
#pragma unroll
  for (int c = 0; c < kCols; ++c)
#pragma unroll
    for (int b = 0; b < TB; ++b) acc[c][b] = 0.f;

  if (n_rounds > 0) load(0);
  for (int t = 0; t < n_rounds; ++t) {
    uint16_t* tab = tabs + (t & 1) * kStageEntries;
    store(tab);  // this table's last reader finished before the previous barrier
    uint32_t cur[U];
#pragma unroll
    for (int u = 0; u < U; ++u) cur[u] = cw[u];
    __syncthreads();
    if (t + 1 < n_rounds) load(t + 1);  // in flight during the lookups
    if (active) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const uint16_t* row = tab + (rg + u * groups) * Kp * TB;
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          add_entries<TB>(acc[c], row + ((cur[u] >> (8 * c)) & 0xffu) * TB);
      }
    }
  }

  // the row groups' sums in order, into this block's partial (token, column)
  __syncthreads();                                // the tables are free
  float* red = reinterpret_cast<float*>(smem);    // [groups][TB][tile_cols]
  float* part = reinterpret_cast<float*>(smem + lay.part);
#pragma unroll
  for (int b = 0; b < TB; ++b)
    *reinterpret_cast<float4*>(red + (rg * TB + b) * tile_cols + lc) =
        make_float4(acc[0][b], acc[1][b], acc[2][b], acc[3][b]);
  __syncthreads();
  const int n = TB * tile_cols;
  for (int e = tid; e < n; e += kThreads) {
    float s = red[e];
    for (int g = 1; g < groups; ++g) s += red[g * n + e];
    part[e] = s;
  }

  // each block sums its share of the tile over the cluster, in rank order
  cluster.sync();
  for (int e = rank * kThreads + tid; e < n; e += n_splits * kThreads) {
    const int b = b0 + e / tile_cols, j = tile0 + e % tile_cols;
    float v[kMaxSplits];  // the remote loads issued together, then summed in rank order
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q) v[q] = q < n_splits ? cluster.map_shared_rank(part, q)[e] : 0.f;
    float s = v[0];
#pragma unroll
    for (int q = 1; q < kMaxSplits; ++q)
      if (q < n_splits) s += v[q];
    if (b < B && j < d_out) out[static_cast<size_t>(b) * d_out + j] = scales ? s * scales[j] : s;
  }
  cluster.sync();                                 // no block leaves while its part is read
}

// The launch configuration of a (tile_cols, n_splits) plan over token
// blocks of TB, its shared memory granted; attr holds the cluster shape.
template <int TB, int U>
cudaError_t configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int tiles, int zs,
                      int tile_cols, int n_splits, cudaStream_t stream) {
  const int smem = Layout(TB, tile_cols).total;
  *cfg = {};
  cfg->gridDim = dim3(tiles, n_splits, zs);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = n_splits;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  // the attributes are set once an instance (the shared memory when a
  // plan needs more than any before it): no CUDA runtime calls but the launch
  static bool non_portable = false;
  static int smem_granted = 0;
  if (n_splits > 8 && !non_portable) {
    const cudaError_t e =
        cudaFuncSetAttribute(lut_bpair<TB, U>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    non_portable = true;
  }
  if (smem > smem_granted) {
    const cudaError_t e =
        cudaFuncSetAttribute(lut_bpair<TB, U>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_granted = smem;
  }
  return cudaSuccess;
}

template <int TB, int U>
int launch(const void* lut, const void* codes, const void* scales, void* out, int B, int G,
           int Kp, int d_out, int d_out_pad, int tile_cols, int n_splits, int slice_groups,
           int stage_groups, cudaStream_t stream) {
  if (stage_groups * Kp * TB > kStageEntries) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure<TB, U>(&cfg, &attr, (d_out_pad + tile_cols - 1) / tile_cols,
                                   (B + TB - 1) / TB, tile_cols, n_splits, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaLaunchKernelEx(&cfg, lut_bpair<TB, U>, static_cast<const float*>(lut),
                         static_cast<const uint8_t*>(codes), static_cast<const float*>(scales),
                         static_cast<float*>(out), B, G, Kp, d_out, d_out_pad, tile_cols,
                         slice_groups, stage_groups);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of the plan the card holds at once (or a negative error).
template <int TB, int U>
int max_clusters(int tile_cols, int n_splits) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure<TB, U>(&cfg, &attr, 1, 1, tile_cols, n_splits, 0);
  int n = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&n, lut_bpair<TB, U>, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// The instance of (TB, U = stage_groups / row groups).
template <int TB>
int launch_u(int u, const void* lut, const void* codes, const void* scales, void* out, int B,
             int G, int Kp, int d_out, int d_out_pad, int tile_cols, int n_splits,
             int slice_groups, int stage_groups, cudaStream_t stream) {
#define LUTVQ_BPAIR_ARGS lut, codes, scales, out, B, G, Kp, d_out, d_out_pad, tile_cols, \
                         n_splits, slice_groups, stage_groups, stream
  switch (u) {
    case 1: return launch<TB, 1>(LUTVQ_BPAIR_ARGS);
    case 2: return launch<TB, 2>(LUTVQ_BPAIR_ARGS);
    case 4: return launch<TB, 4>(LUTVQ_BPAIR_ARGS);
    case 8: return launch<TB, 8>(LUTVQ_BPAIR_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LUTVQ_BPAIR_ARGS
}

template <int TB>
int max_clusters_u(int u, int tile_cols, int n_splits) {
  switch (u) {
    case 1: return max_clusters<TB, 1>(tile_cols, n_splits);
    case 2: return max_clusters<TB, 2>(tile_cols, n_splits);
    case 4: return max_clusters<TB, 4>(tile_cols, n_splits);
    case 8: return max_clusters<TB, 8>(tile_cols, n_splits);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// B (1-8) tokens' tables, in blocks of TB (2 or 4) tokens along grid z;
// tile_cols in {128, ..., 2048}; n_splits (<= 16; above 8 where the card
// allows) blocks of slice_groups groups each form a cluster; stage_groups
// groups a round, a multiple of 2048 / tile_cols and at most 8 times it,
// stage_groups * Kp * TB <= 8192.
extern "C" int lutvq_lut_bpair(const void* lut, const void* codes, const void* scales, void* out,
                               int B, int TB, int G, int Kp, int d_out, int d_out_pad,
                               int tile_cols, int n_splits, int slice_groups, int stage_groups,
                               void* stream_ptr) {
  if (tile_cols < 128 || tile_cols > kSpan || kSpan % tile_cols || n_splits < 1 ||
      n_splits > kMaxSplits || slice_groups < 1 || stage_groups < 1 ||
      stage_groups % (kSpan / tile_cols) || stage_groups / (kSpan / tile_cols) > kMaxU ||
      Kp % 4 || Kp > 256 || B < 1 || B > 8 || d_out_pad % 128 || d_out > d_out_pad)
    return static_cast<int>(cudaErrorInvalidValue);
  if (G == 0 || d_out == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  const int u = stage_groups / (kSpan / tile_cols);
#define LUTVQ_BPAIR_ARGS u, lut, codes, scales, out, B, G, Kp, d_out, d_out_pad, tile_cols, \
                         n_splits, slice_groups, stage_groups, st
  switch (TB) {
    case 2: return launch_u<2>(LUTVQ_BPAIR_ARGS);
    case 4: return launch_u<4>(LUTVQ_BPAIR_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LUTVQ_BPAIR_ARGS
}

// Clusters of a (TB, tile_cols, n_splits, stage_groups) plan that fit the
// card at once (cudaOccupancyMaxActiveClusters), or minus a CUDA error.
extern "C" int lutvq_lut_bpair_clusters(int TB, int tile_cols, int n_splits, int stage_groups) {
  if (tile_cols < 128 || tile_cols > kSpan || kSpan % tile_cols || stage_groups < 1)
    return -static_cast<int>(cudaErrorInvalidValue);
  const int u = stage_groups / (kSpan / tile_cols);
  switch (TB) {
    case 2: return max_clusters_u<2>(u, tile_cols, n_splits);
    case 4: return max_clusters_u<4>(u, tile_cols, n_splits);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}
