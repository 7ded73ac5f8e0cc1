// Lookup-accumulate over nibble-packed 4-bit codes (T-MAC W4 projections),
// for Hopper (sm_90a): one token's f32 tables (J1) and 2-8 tokens' bf16
// tables (J2), one template over the entry type.
//
// Replaces tpu_lutvq/kernels/lut_gemv.py::_gemv_kernel_nibbles (:628, J1) and
// ::_gemv_kernel_nibbles_bpair (:658, J2):
//     y[b, j] = s[j] * sum_r (tab[b, 2r, codes_t[r, j] & 15] + tab[b, 2r+1, codes_t[r, j] >> 4])
// with f32 (J1) or bf16 (J2) entries summed in f32.
//
// What bounds it on the H100.  The codes are the only large input: R * d_out
// bytes for R = G / 2 code rows (8 MiB at 4096 x 4096, 2.5 us at 3.35 TB/s).
// But every code byte and column reads two table entries of BP tokens from
// shared memory, 32 B at BP = 8 bf16 tokens and 8 B at J1's one f32 token,
// so the lookups move 16x (J2) or 8x (J1) the code bytes through the SMs'
// shared memory: at 128 B/clk an SM, 2048 x 4096 x 32 B take >= 8 us at
// 4096 x 4096 and >= 56 us at 4096 -> 28672 at 1980 MHz (the lookup
// formulation's floor; chip_smoke.py prints it beside the bytes bound), and
// J1's 2048 x 4096 x 8 B >= 2.0 us.  A bf16 entry also costs one integer op
// to widen it to f32, and the integer pipe runs at half the f32 rate: ~14 us
// at 4096 x 4096 for J2.  J1's f32 entries need no widening, so its floor is
// the shared-memory bytes, behind the code loads' latency and the launch.
// The design:
//   - J2's table is laid out (row, token quad, lo/hi group, k, 4 tokens), so
//     a group's 16 entries of one token quad are 128 B, one bank row: the
//     lanes of a warp all look up the same code row, and their 8-byte loads
//     are free of bank conflicts whatever the codes; J1's row is its two
//     groups' 16 f32 entries, 16 consecutive banks each, staged straight from
//     build_lut's (G, Kp) table (the 16 real entries of each group, a zero
//     group past an odd G): no copy before the launch;
//   - a block owns a tile of TC output columns and one split of the code
//     rows; its 512 threads take 4 columns each (one 32-bit code load a
//     row), in 2048 / TC row groups that interleave the split's rows, the
//     next 4 rows' codes loaded while this row's are
//     looked up; the first codes are requested before the split's tables,
//     which are staged through cp.async in rounds of at most 128 KiB;
//   - the n_splits (<= 8) blocks of a column tile form one thread-block
//     cluster: each block sums its row groups in order and writes each of
//     the tile's outputs' partial into the shared memory of the block that
//     owns that output (distributed shared memory); after one cluster
//     barrier each block sums its outputs' partials in rank order.  No
//     partial reaches device memory, there is no second launch, and two
//     calls are bit-equal.
// kernels/lut_gemv.py::plan_nibbles picks TC and the splits from (code rows,
// width, tokens, entry size, SMs) and how many clusters the card holds at
// once (lutvq_lut_nibbles_*_clusters: 15 of 8 J2 blocks on an H100, not 16,
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

// 16 bytes to shared memory; src_bytes 0 fills them with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes = 16) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

// The 4-bit field of w at bit `pos`.
__device__ __forceinline__ uint32_t bfe4(uint32_t w, int pos) {
  uint32_t r;
  asm("bfe.u32 %0, %1, %2, 4;\n" : "=r"(r) : "r"(w), "r"(pos));
  return r;
}

// An f32 from a 32-bit shared-memory address (ordered like the barriers).
__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// TQ consecutive bf16 entries (2 or 4 tokens) added to acc in f32.
template <typename T, int TQ>
__device__ __forceinline__ void add_quad(float* acc, const T* p) {
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

// Code rows [s0, s1) of the table into shared memory, one cp.async group.
// bf16: J2's layout, contiguous.  f32: row r is groups 2r and 2r+1 of the
// (G, kp) table, their first 16 entries each (four 16-byte chunks a group),
// zeros for a group past G.
template <typename T>
__device__ __forceinline__ void stage_tables(unsigned char* smem, const T* tab, int s0, int s1,
                                           int row_bytes, int G, int kp) {
  const int n16 = (s1 - s0) * row_bytes / 16;
  if constexpr (sizeof(T) == 4) {
    for (int i = threadIdx.x; i < n16; i += kThreads) {
      const int g = 2 * (s0 + (i >> 3)) + ((i >> 2) & 1);
      const bool live = g < G;
      cp_async16(smem + i * 16, live ? tab + static_cast<size_t>(g) * kp + (i & 3) * 4 : tab,
                 live ? 16 : 0);
    }
  } else {
    const unsigned char* src = reinterpret_cast<const unsigned char*>(tab) +
                               static_cast<size_t>(s0) * row_bytes;
    for (int i = threadIdx.x; i < n16; i += kThreads) cp_async16(smem + i * 16, src + i * 16);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// bf16 (uint16_t), BP in {2, 4, 8}:
//   tab:  (R, BP / TQ, 2, 16, TQ) bf16 bits: row r's low-nibble group 2r and
//         high-nibble group 2r+1, each token quad's 16 entries contiguous
// f32, BP = 1:
//   tab:  (G, kp) f32, build_lut's table of one token (kp >= 16, kp % 4 == 0)
// codes:  (R_pad, d_out_pad) uint8, row r holding groups 2r (low) and 2r+1
// out:    (B, d_out) f32
template <typename T, int BP>
__device__ __forceinline__ void nibbles_body(const T* __restrict__ tab,
                                             const uint8_t* __restrict__ codes,
                                             const float* __restrict__ scales,
                                             float* __restrict__ out, int B, int R, int d_out,
                                             int d_out_pad, int tile_cols, int slice_rows,
                                             int stage_rows, int G, int kp) {
  constexpr int TQ = BP < 4 ? BP : 4;
  constexpr int QN = BP / TQ;
  constexpr int kRowElems = 2 * kK * BP;          // entries of one code row
  constexpr int kRowBytes = kRowElems * static_cast<int>(sizeof(T));
  constexpr int kPrefetch = 4;                    // code rows loaded ahead
  extern __shared__ __align__(16) unsigned char smem[];
  const T* stage = reinterpret_cast<const T*>(smem);
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
  // arrive at the cluster barrier now; its wait below (before the first
  // write into another block's shared memory) then finds every block started
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  // the scale of the first output this thread finishes (of its block's
  // share of the tile), loaded now rather than after the barrier
  const int n = BP * tile_cols;
  const int share = (n + n_splits - 1) / n_splits;  // outputs a block finishes
  auto out_col = [&](int k) { return blockIdx.x * tile_cols + (rank * share + k) % tile_cols; };
  const bool first = threadIdx.x < share && rank * share + threadIdx.x < n &&
                     out_col(threadIdx.x) < d_out;
  const float first_scale = scales != nullptr && first ? __ldg(scales + out_col(threadIdx.x)) : 1.f;

  float acc[kCols][BP];
#pragma unroll
  for (int c = 0; c < kCols; ++c)
#pragma unroll
    for (int b = 0; b < BP; ++b) acc[c][b] = 0.f;

  for (int s0 = r_begin; s0 < r_end; s0 += stage_rows) {
    const int s1 = min(r_end, s0 + stage_rows);
    // the first rows' codes, then this round's tables, all in flight at once
    uint32_t next[kPrefetch];
    const int i0 = s0 + rg;
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      const int row = i0 + u * groups;
      next[u] = (active && row < s1)
                    ? __ldg(reinterpret_cast<const uint32_t*>(cbase + static_cast<size_t>(row) * d_out_pad))
                    : 0u;
    }
    if (s0 != r_begin) __syncthreads();           // earlier reads of the stage are done
    stage_tables<T>(smem, tab, s0, s1, kRowBytes, G, kp);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    if (!active) continue;
    if constexpr (sizeof(T) == 4) {
      // J1: byte offsets into 32-bit shared addresses and a pointer stepped
      // over the codes, so a lookup is a bitfield extract, an address, a
      // load and an add
      const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
      const size_t step = static_cast<size_t>(groups) * d_out_pad;  // a thread's row stride
      const uint8_t* p = cbase + static_cast<size_t>(i0) * d_out_pad + kPrefetch * step;
      for (int i = i0; i < s1; i += kPrefetch * groups) {
        uint32_t cur[kPrefetch];
#pragma unroll
        for (int u = 0; u < kPrefetch; ++u) {
          cur[u] = next[u];
          next[u] = i + (kPrefetch + u) * groups < s1
                        ? __ldg(reinterpret_cast<const uint32_t*>(p + u * step)) : 0u;
        }
        p += kPrefetch * step;
#pragma unroll
        for (int u = 0; u < kPrefetch; ++u) {
          const int row = i + u * groups;
          if (row >= s1) break;
          const uint32_t tb = sbase + (row - s0) * kRowBytes;
          float v[2 * kCols];
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            v[2 * c] = lds_f32(tb + bfe4(cur[u], 8 * c) * 4);
            v[2 * c + 1] = lds_f32(tb + kK * 4 + bfe4(cur[u], 8 * c + 4) * 4);
          }
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            acc[c][0] += v[2 * c];
            acc[c][0] += v[2 * c + 1];
          }
        }
      }
    } else {
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
          const T* t = stage + (row - s0) * kRowElems;
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const uint32_t code = (cur[u] >> (8 * c)) & 0xffu;
#pragma unroll
            for (int q = 0; q < QN; ++q) {
              add_quad<T, TQ>(acc[c] + q * TQ, t + (2 * q) * kK * TQ + (code & 0xfu) * TQ);
              add_quad<T, TQ>(acc[c] + q * TQ, t + (2 * q + 1) * kK * TQ + (code >> 4) * TQ);
            }
          }
        }
      }
    }
  }

  // the row groups' sums in order, this block's partial of each (token,
  // column) of the tile, go into the inbox of the block that owns it (a
  // contiguous share of the tile), in this block's slot
  __syncthreads();                                // the stage is free
  float* red = reinterpret_cast<float*>(smem);    // [groups][BP][tile_cols]
  const int stage_bytes = stage_rows * kRowBytes;
  const int red_bytes = kSpan * BP * 4;
  float* inbox = reinterpret_cast<float*>(smem + (stage_bytes > red_bytes ? stage_bytes : red_bytes));
  const int lc = col0 - blockIdx.x * tile_cols;
#pragma unroll
  for (int b = 0; b < BP; ++b)
#pragma unroll
    for (int c = 0; c < kCols; ++c) red[(rg * BP + b) * tile_cols + lc + c] = acc[c][b];
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int e = threadIdx.x; e < n; e += kThreads) {
    float s = red[e];
    for (int g = 1; g < groups; ++g) s += red[g * n + e];
    const int owner = e / share;
    cluster.map_shared_rank(inbox, owner)[rank * share + e - owner * share] = s;
  }
  cluster.sync();                                 // every inbox is full
  // this block's share of the tile, its slots summed in rank order
  for (int k = threadIdx.x; k < share; k += kThreads) {
    const int e = rank * share + k, b = e / tile_cols, j = out_col(k);
    if (e >= n || b >= B || j >= d_out) continue;
    float s = 0.f;
    for (int q = 0; q < n_splits; ++q) s += inbox[q * share + k];
    const float sc = k == threadIdx.x ? first_scale : (scales != nullptr ? scales[j] : 1.f);
    out[static_cast<size_t>(b) * d_out + j] = s * sc;
  }
}

// J2: 2-8 tokens' bf16 tables
template <int BP>
__global__ void __launch_bounds__(kThreads)
lut_nibbles_bf16(const uint16_t* __restrict__ tab, const uint8_t* __restrict__ codes,
                 const float* __restrict__ scales, float* __restrict__ out, int B, int R,
                 int d_out, int d_out_pad, int tile_cols, int slice_rows, int stage_rows,
                 int G, int kp) {
  nibbles_body<uint16_t, BP>(tab, codes, scales, out, B, R, d_out, d_out_pad, tile_cols,
                             slice_rows, stage_rows, G, kp);
}

// J1: one token's f32 table
__global__ void __launch_bounds__(kThreads)
lut_nibbles_f32(const float* __restrict__ tab, const uint8_t* __restrict__ codes,
                const float* __restrict__ scales, float* __restrict__ out, int B, int R,
                int d_out, int d_out_pad, int tile_cols, int slice_rows, int stage_rows, int G,
                int kp) {
  nibbles_body<float, 1>(tab, codes, scales, out, B, R, d_out, d_out_pad, tile_cols,
                         slice_rows, stage_rows, G, kp);
}

template <typename T> struct Kernel;
template <> struct Kernel<float> {
  template <int BP> static constexpr auto fn() { return lut_nibbles_f32; }
};
template <> struct Kernel<uint16_t> {
  template <int BP> static constexpr auto fn() { return lut_nibbles_bf16<BP>; }
};

// The launch configuration of a (tile_cols, n_splits, stage_rows) plan, its
// shared memory granted; attr holds the cluster shape.
template <typename T, int BP>
cudaError_t configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int tiles,
                      int tile_cols, int n_splits, int stage_rows, cudaStream_t stream) {
  const int stage_bytes = stage_rows * 2 * kK * BP * static_cast<int>(sizeof(T));
  const int red_bytes = kSpan * BP * 4;
  const int smem = (stage_bytes > red_bytes ? stage_bytes : red_bytes) +
                   (tile_cols * BP + kMaxSplits) * 4;  // the inbox
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
  return cudaFuncSetAttribute(Kernel<T>::template fn<BP>(),
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename T, int BP>
int launch(const void* tab, const void* codes, const void* scales, void* out, int B, int R,
           int d_out, int d_out_pad, int tile_cols, int n_splits, int slice_rows,
           int stage_rows, int G, int kp, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure<T, BP>(&cfg, &attr, (d_out_pad + tile_cols - 1) / tile_cols,
                                   tile_cols, n_splits, stage_rows, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaLaunchKernelEx(&cfg, Kernel<T>::template fn<BP>(), static_cast<const T*>(tab),
                         static_cast<const uint8_t*>(codes), static_cast<const float*>(scales),
                         static_cast<float*>(out), B, R, d_out, d_out_pad, tile_cols,
                         slice_rows, stage_rows, G, kp);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of the plan the card holds at once (or a negative error).
template <typename T, int BP>
int max_clusters(int tile_cols, int n_splits, int stage_rows) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure<T, BP>(&cfg, &attr, 1, tile_cols, n_splits, stage_rows, 0);
  int n = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&n, Kernel<T>::template fn<BP>(), &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

bool bad_plan(int tile_cols, int n_splits, int slice_rows, int stage_rows) {
  return tile_cols < 128 || tile_cols > kSpan || kSpan % tile_cols || n_splits < 1 ||
         n_splits > kMaxSplits || slice_rows < 1 || stage_rows < 1;
}

}  // namespace

// J2.  R code rows; the block's column tile tile_cols in {128, 256, 512,
// 1024}; n_splits (<= 8) blocks of slice_rows code rows each form a cluster;
// the tables are staged stage_rows code rows at a time.
extern "C" int lutvq_lut_nibbles_bf16(const void* tab, const void* codes, const void* scales,
                                      void* out, int B, int BP, int R, int d_out,
                                      int d_out_pad, int tile_cols, int n_splits,
                                      int slice_rows, int stage_rows, void* stream_ptr) {
  if (bad_plan(tile_cols, n_splits, slice_rows, stage_rows) || B > BP)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || d_out == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
#define LUTVQ_NIB_ARGS tab, codes, scales, out, B, R, d_out, d_out_pad, tile_cols, n_splits, \
                       slice_rows, stage_rows, 0, 0, st
  switch (BP) {
    case 2: return launch<uint16_t, 2>(LUTVQ_NIB_ARGS);
    case 4: return launch<uint16_t, 4>(LUTVQ_NIB_ARGS);
    case 8: return launch<uint16_t, 8>(LUTVQ_NIB_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LUTVQ_NIB_ARGS
}

// Clusters of a J2 (tile_cols, n_splits, stage_rows) plan that fit the card
// at once (cudaOccupancyMaxActiveClusters), or minus a CUDA error.
extern "C" int lutvq_lut_nibbles_bf16_clusters(int BP, int tile_cols, int n_splits,
                                               int stage_rows) {
  switch (BP) {
    case 2: return max_clusters<uint16_t, 2>(tile_cols, n_splits, stage_rows);
    case 4: return max_clusters<uint16_t, 4>(tile_cols, n_splits, stage_rows);
    case 8: return max_clusters<uint16_t, 8>(tile_cols, n_splits, stage_rows);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// J1.  tab: one token's (G, kp) f32 table, G groups paired into R = ceil(G
// / 2) code rows; the plan as for J2.
extern "C" int lutvq_lut_nibbles_f32(const void* tab, const void* codes, const void* scales,
                                     void* out, int G, int kp, int R, int d_out, int d_out_pad,
                                     int tile_cols, int n_splits, int slice_rows,
                                     int stage_rows, void* stream_ptr) {
  if (bad_plan(tile_cols, n_splits, slice_rows, stage_rows) || kp < kK || kp % 4 ||
      R < (G + 1) / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (d_out == 0) return 0;
  return launch<float, 1>(tab, codes, scales, out, 1, R, d_out, d_out_pad, tile_cols, n_splits,
                          slice_rows, stage_rows, G, kp, static_cast<cudaStream_t>(stream_ptr));
}

extern "C" int lutvq_lut_nibbles_f32_clusters(int tile_cols, int n_splits, int stage_rows) {
  return max_clusters<float, 1>(tile_cols, n_splits, stage_rows);
}
