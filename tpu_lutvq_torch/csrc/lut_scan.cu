// Lookup-accumulate over byte codes with one table per token, for Hopper
// (sm_90a): one template over the entry kind serves five kernels of
// tpu_lutvq/kernels/lut_gemv.py (reached through pallas_call :766, :861):
//   kind 0  ::_gemv_kernel_pair       (:344, A)  one token, f32 table rounded
//           ::_gemv_kernel_pair_fused (:309, M)  to bf16, f32 sum ("pair",
//                                                "pairf": one function)
//   kind 1  ::_gemv_kernel            (:586, K)  f32 entries, f32 sum
//   kind 2  ::_gemv_kernel_i8         (:487, H)  int8 entries, exact sum
//   kind 3  ::_gemv_kernel_i16        (:541, I)  int16 entries, exact sum
// All compute
//     y[b, j] = s[j] * sum_g tab[b, g, codes_t[g, j]]
// from build_lut's (B, G, Kp) tables as they are (int8/int16: as the
// wrapper's quantizer writes them).  A and M round each entry to bf16
// (nearest even, as torch's cast) as they stage it, the JAX pair packers'
// rounding point, so "pair" and "pairf" are one launch of one kernel and
// equal bit for bit.  H and I sum integers exactly; the wrapper multiplies
// by each token's table scale afterwards (lut_gemv.py:522-526, 878-880).
// The B >= 2 bf16 lookups (B) are lut_bpair.cu's, the nibble codes (J)
// lut_nibbles.cu's.
//
// What bounds it on the H100.
//   - At a projection (A at 4096 x 4096, one token): the codes, G * d_out
//     bytes (4 MiB, 1.3 us at 3.35 TB/s), and the 1 MiB f32 table.  But
//     every column tile stages its groups' table through its SM, so the
//     table crosses the L2 once per column tile, and every code byte reads
//     one entry from shared memory at a random row of the table (K = 256:
//     32 random codes of a warp meet ~3.15 distinct words on the busiest of
//     the 32 banks).
//   - At an ANN scan (8 queries over n = 1M PQ16 codes): the output, (8, n)
//     f32 = 32 MB against 16 MB of codes (~14 us at 3.35 TB/s), and the
//     lookups: 8 tokens' entries a code byte, 32 B in f32 (512 MiB at G =
//     16 through shared memory, ~16 us at 128 B/clk an SM and 1980 MHz
//     without conflicts).
// The design:
//   - one launch at every shape.  A block owns a tile of TC columns and one
//     split of the groups; where G must split (the projections), the
//     n_splits (<= 16) blocks of a tile form one thread-block cluster, and
//     each block's partial goes into the shared memory of the block that
//     owns that output (distributed shared memory), summed there in rank
//     order after one cluster barrier.  No workspace, no second kernel, two
//     calls bit-equal; integer sums stay exact.  With one split the launch
//     is a plain one and a block walks column tiles with a grid stride,
//     keeping its staged tables.
//   - the tables are staged through registers, transposed to (group, k,
//     token) rows, so that one 4-byte word holds one f32/bf16 entry, two
//     int16 or four int8 tokens' entries; a row is the words of all tokens
//     (padded to one word), and the lanes of a column chunk read consecutive
//     words.  At 8 tokens a warp's 32 lanes look up 4 (f32), 8 (int16) or
//     16 (int8) codes a load, each row on its own bank slots: ~2.1, ~2.5 and
//     ~2.9 distinct words on the busiest bank against random codes (16-byte
//     loads of 4 tokens would put a phase's 8 threads on 4 bank quads, ~3.4).
//     A and M store each entry rounded, as an f32 with a zero low half, so
//     their lookup is a load and an add.
//   - codes in flight: a segment's codes (a tile's round, stage_groups rows
//     of TC bytes) go into one of two shared buffers through cp.async, the
//     first requested before the tables, each next one while the current is
//     looked up; a lane reads its 16 (int8, int16: 8) columns' codes with one
//     shared load a group.  Round t + 1's tables are loaded into registers
//     while round t is looked up (two buffers, one barrier a round).
//   - H's int8 entries are staged biased by +128 as unsigned bytes; a word
//     of four tokens' bytes splits into two registers of two 16-bit lanes
//     (two byte permutes) summed with plain 32-bit adds, widened into int32
//     every 256 groups (255 * 256 < 65536: no lane carries), the bias (128
//     per group summed) removed at the end.  I's int16 entries leave no room
//     to pack: two sign-extending extracts a word.
// kernels/lut_gemv.py::plan_scan (plan_pair for A and M) picks the block
// size, TC, the splits and the rounds from (kind, tokens, groups, width,
// Kp, SMs) and how many clusters the card holds at once
// (lutvq_lut_scan_clusters); its cost model is fit to chip_smoke.py
// --plans, which times every candidate plan on the card.
// Left for later: replicated tables (conflict-free rows per lane position,
// 2-4x the shared memory), TMA multicast of a split's table to the column
// tiles of a two-dimensional cluster (the L2 traffic of A's table), and the
// fixed cost of a launch (PERF.md).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxSplits = 16;                    // 8 portable, 16 where the card allows
constexpr int kFlush = 256;                       // int8: groups a 16-bit lane may sum

// Entry kinds: the table's element type and the columns a lane takes.
template <int KIND> struct Kind;
template <> struct Kind<0> { using Src = float;   using Acc = float;   static constexpr int kCols = 16; };
template <> struct Kind<1> { using Src = float;   using Acc = float;   static constexpr int kCols = 16; };
template <> struct Kind<2> { using Src = int8_t;  using Acc = int32_t; static constexpr int kCols = 8; };
template <> struct Kind<3> { using Src = int16_t; using Acc = int32_t; static constexpr int kCols = 8; };

// The layout of a (kind, BP-token) instance.
template <int KIND, int BP>
struct Layout {
  static constexpr int kES = static_cast<int>(sizeof(typename Kind<KIND>::Src));
  static constexpr int kSlots = 4 / kES;                          // entries in a 4-byte word
  static constexpr int kLanes = BP * kES > 4 ? BP * kES / 4 : 1;  // words a (group, k) row
  static constexpr int kTokens = kLanes * kSlots;                 // token slots a row
  static constexpr int kCols = Kind<KIND>::kCols;
  static constexpr int kCodeWords = kCols / 4;
  static constexpr int kUsed = kSlots < BP ? kSlots : BP;         // slots of a word holding tokens
  static constexpr int kWordsPerTok = kES;                        // 4 entries of one token
  // (group, 4 k) items a thread stages a round: up to 64 bytes, at most 4
  static constexpr int kItems = 16 / (kES * BP) > 4 ? 4 : 16 / (kES * BP) > 0 ? 16 / (kES * BP) : 1;
  static constexpr int kRowShift = kLanes == 1 ? 2 : kLanes == 2 ? 3 : kLanes == 4 ? 4 : 5;
};

// Shared memory of a launch: nbuf round buffers of stage_groups groups' tables,
// two buffers of a round's codes (stage_groups x tile_cols bytes), the row
// groups' partials (with more than one row group or split) and the inbox of
// the cluster's partials (with more than one split).
struct Smem {
  int stage, codes, red, inbox, total;
  __host__ __device__ Smem(int lanes, int tokens, int kp, int threads, int tile_cols,
                           int cols, int n_splits, int stage_groups, int nbuf) {
    const int row_groups = threads / (lanes * (tile_cols / cols));
    stage = nbuf * stage_groups * kp * lanes * 4;
    codes = 2 * stage_groups * tile_cols;
    red = (row_groups > 1 || n_splits > 1) ? row_groups * tokens * tile_cols * 4 : 0;
    inbox = n_splits > 1 ? (tokens * tile_cols + kMaxSplits) * 4 : 0;
    total = stage + codes + red + inbox;
  }
};

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// 16 bytes to shared memory; src_bytes 0 fills them with zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

// N words (N = 2 or 4) from a shared-memory address.
template <int N>
__device__ __forceinline__ void lds_words(uint32_t (&w)[N], uint32_t addr) {
  if constexpr (N == 4) {
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3]) : "r"(addr));
  } else {
    asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n" : "=r"(w[0]), "=r"(w[1]) : "r"(addr));
  }
}

__device__ __forceinline__ void sts128(uint32_t addr, uint32_t a, uint32_t b, uint32_t c,
                                       uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(a), "r"(b), "r"(c),
               "r"(d)
               : "memory");
}

// N words from global memory (N = 1, 2 or 4; 4N-byte aligned).
template <int N>
__device__ __forceinline__ void ldg_words(uint32_t (&w)[N], const void* p) {
  if constexpr (N == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (N == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = __ldg(reinterpret_cast<const uint32_t*>(p));
  }
}

__device__ __forceinline__ uint32_t round_bf16_bits(uint32_t x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(__uint_as_float(x))))
         << 16;
}

// tab:    (B, G, Kp) entries (f32, int8 or int16), token-major as written
// codes:  (G_pad, d_out_pad) uint8, n-major groups
// out:    (B, d_out) f32
// Block (x, q) takes column tiles x, x + gridDim.x, ... (one with more than
// one split) and groups [q * slice_groups, ...) of its cluster's split, in
// rounds of stage_groups (a multiple of the row groups).  Thread t is lane
// word t % kLanes of column chunk (t / kLanes) % (tile_cols / kCols) in row
// group t / (kLanes * tile_cols / kCols); a row group looks up the groups
// of each round congruent to its index.
template <int KIND, int BP>
__global__ void __launch_bounds__(kMaxThreads, 1)
lut_scan(const typename Kind<KIND>::Src* __restrict__ tab, const uint8_t* __restrict__ codes,
         const float* __restrict__ scales, float* __restrict__ out, int B, int G, int Kp,
         int d_out, int d_out_pad, int tile_cols, int slice_groups, int stage_groups,
         int nbuf) {
  using L = Layout<KIND, BP>;
  using Acc = typename Kind<KIND>::Acc;
  constexpr int kCols = L::kCols, kLanes = L::kLanes, kSlots = L::kSlots, kCW = L::kCodeWords;
  constexpr int kUsed = L::kUsed;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_splits = static_cast<int>(cluster.num_blocks());
  const int nt = blockDim.x, tid = threadIdx.x;
  const int chunks = tile_cols / kCols;
  const int row_groups = nt / (kLanes * chunks);
  const int s = tid % kLanes;
  const int lcol = ((tid / kLanes) % chunks) * kCols;  // this lane's first column in a tile
  const int rg = tid / (kLanes * chunks);
  const int g_begin = min(G, rank * slice_groups);
  const int g_end = min(G, g_begin + slice_groups);
  const int n_rounds = (g_end - g_begin + stage_groups - 1) / stage_groups;
  const bool resident = n_rounds <= nbuf;         // the split's tables stay staged
  const int n_tiles = (d_out_pad + tile_cols - 1) / tile_cols;
  const int tc_shift = __ffs(tile_cols) - 1;      // tile_cols a power of 2
  const int kq_shift = __ffs(Kp) - 3;             // Kp / 4 items a group (Kp a power of 2)
  const int row_shift = __ffs(Kp) - 1 + L::kRowShift;  // bytes of one group's rows
  const Smem lay(kLanes, L::kTokens, Kp, nt, tile_cols, kCols, n_splits, stage_groups, nbuf);
  const int buf_bytes = stage_groups * Kp * kLanes * 4;
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  Acc* red = reinterpret_cast<Acc*>(smem + lay.stage + lay.codes);
  Acc* inbox = reinterpret_cast<Acc*>(smem + lay.stage + lay.codes + lay.red);
  if (n_splits > 1)  // arrive now; the wait before the first remote write finds all started
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  // with splits, the scale of the first output this thread finishes (of its
  // block's share of the tile), loaded now rather than after the barrier
  const int share = (BP * tile_cols + n_splits - 1) / n_splits;  // outputs a block finishes
  const int first_j = blockIdx.x * tile_cols + ((rank * share + tid) & (tile_cols - 1));
  const float first_scale = n_splits > 1 && scales != nullptr && tid < share &&
                                    rank * share + tid < BP * tile_cols && first_j < d_out
                                ? __ldg(scales + first_j)
                                : 1.f;

  // the codes of a segment (a tile's round: stage_groups rows of tile_cols
  // bytes) into one of two shared buffers through cp.async, the next
  // segment's requested while this one is looked up; chunks past the padded
  // width are zeros
  const uint32_t cbase = sbase + lay.stage;
  const int c16_shift = tc_shift - 4;             // 16-byte chunks a code row
  auto fetch_codes = [&](int tile, int t, int buf) {
    if (tile < n_tiles) {
      const int g0 = g_begin + t * stage_groups;
      const int n16 = min(stage_groups, g_end - g0) << c16_shift;
      const uint8_t* src = codes + static_cast<size_t>(g0) * d_out_pad +
                           static_cast<size_t>(tile) * tile_cols;
      const int live16 = (d_out_pad - tile * tile_cols) >> 4;  // chunks inside the width
      for (int i = tid; i < n16; i += nt) {
        const int row = i >> c16_shift, c = i & ((1 << c16_shift) - 1);
        cp_async16(cbase + buf * stage_groups * tile_cols + (i << 4),
                   src + static_cast<size_t>(row) * d_out_pad + (c << 4), c < live16 ? 16 : 0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  fetch_codes(blockIdx.x, 0, 0);

  // round t's entries of every (real) token into registers: item (group,
  // 4 k), kWordsPerTok words a token; zeros past B and past the split
  uint32_t pf[L::kItems][BP * L::kWordsPerTok];
  auto load = [&](int t) {
    const int g0 = g_begin + t * stage_groups;
    const int items = min(stage_groups, g_end - g0) << kq_shift;
#pragma unroll
    for (int it = 0; it < L::kItems; ++it) {
      const int idx = tid + it * nt;
      const int g = g0 + (idx >> kq_shift), kq = idx & ((Kp >> 2) - 1);
#pragma unroll
      for (int b = 0; b < BP; ++b) {
        uint32_t w[L::kWordsPerTok];
        if (idx < items && b < B) {
          ldg_words<L::kWordsPerTok>(w, tab + (static_cast<size_t>(b) * G + g) * Kp + 4 * kq);
        } else {
#pragma unroll
          for (int i = 0; i < L::kWordsPerTok; ++i) w[i] = 0u;
        }
#pragma unroll
        for (int i = 0; i < L::kWordsPerTok; ++i) pf[it][b * L::kWordsPerTok + i] = w[i];
      }
    }
  };
  // the registers' items into buffer buf, rows (group, k) of kLanes words
  auto store = [&](int buf, int t) {
    const int items = min(stage_groups, g_end - (g_begin + t * stage_groups)) << kq_shift;
#pragma unroll
    for (int it = 0; it < L::kItems; ++it) {
      const int idx = tid + it * nt;
      if (idx >= items) continue;
      uint32_t rows[4 * kLanes];                  // rows k..k+3 of this item, in order
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int w = 0; w < kLanes; ++w) {
          uint32_t x;
          if constexpr (kSlots == 1) {            // token w's entry j
            x = pf[it][w * 4 + j];
            if constexpr (KIND == 0) x = round_bf16_bits(x);
          } else if constexpr (kSlots == 2) {     // tokens 2w, 2w + 1: halfword j
            const uint32_t a = pf[it][(2 * w) * 2 + j / 2];
            const uint32_t b = 2 * w + 1 < BP ? pf[it][(2 * w + 1) * 2 + j / 2] : 0u;
            x = __byte_perm(a, b, (j & 1) ? 0x7632 : 0x5410);
          } else {                                // tokens 4w .. 4w + 3: byte j, biased
            uint32_t q[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) q[i] = 4 * w + i < BP ? pf[it][4 * w + i] : 0u;
            const uint32_t sel = ((4 + j) << 4) | j;
            x = __byte_perm(__byte_perm(q[0], q[1], sel), __byte_perm(q[2], q[3], sel), 0x5410) ^
                0x80808080u;
          }
          rows[j * kLanes + w] = x;
        }
      }
      const uint32_t dst = sbase + buf * buf_bytes +
                           ((((idx >> kq_shift) * Kp) + 4 * (idx & ((Kp >> 2) - 1))) * kLanes) * 4;
#pragma unroll
      for (int v = 0; v < kLanes; ++v)
        sts128(dst + 16 * v, rows[4 * v], rows[4 * v + 1], rows[4 * v + 2], rows[4 * v + 3]);
    }
  };

  // accumulators: f32 sums; int16 two int32 a column; int8 two words of
  // 16-bit lanes (slots 0/2 and 1/3) a column, widened every kFlush groups
  float accf[KIND <= 1 ? kCols : 1];
  int32_t acci[KIND >= 2 ? kCols : 1][KIND >= 2 ? kUsed : 1];
  uint32_t pk[KIND == 2 ? kCols : 1][2];
  int n_packed = 0, n_groups = 0;
  auto widen = [&]() {
    if constexpr (KIND == 2) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        acci[c][0] += static_cast<int32_t>(pk[c][0] & 0xffffu);
        if constexpr (kUsed > 2) acci[c][2] += static_cast<int32_t>(pk[c][0] >> 16);
        if constexpr (kUsed > 1) acci[c][1] += static_cast<int32_t>(pk[c][1] & 0xffffu);
        if constexpr (kUsed > 3) acci[c][3] += static_cast<int32_t>(pk[c][1] >> 16);
        pk[c][0] = pk[c][1] = 0u;
      }
      n_packed = 0;
    }
  };
  // this lane's value of column c, slot j of its word
  auto value = [&](int c, int j) -> Acc {
    if constexpr (KIND <= 1) return accf[c];
    else if constexpr (KIND == 3) return acci[c][j];
    else return acci[c][j] - 128 * n_groups;
  };

  bool staged = false;
  int seg = 0;                                    // segments (tile, round) looked up so far
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if constexpr (KIND <= 1) accf[c] = 0.f;
      if constexpr (KIND >= 2) {
#pragma unroll
        for (int j = 0; j < kUsed; ++j) acci[c][j] = 0;
      }
      if constexpr (KIND == 2) pk[c][0] = pk[c][1] = 0u;
    }
    n_packed = n_groups = 0;
    if (!resident && tile != static_cast<int>(blockIdx.x)) __syncthreads();  // the last tile's lookups are done
    for (int t = 0; t < n_rounds; ++t, ++seg) {
      const int buf = t % nbuf;
      if (!staged) {
        if (t == 0) load(0);
        store(buf, t);  // this buffer's last reader finished before the previous barrier
      }
      asm volatile("cp.async.wait_group 0;\n" ::);  // this segment's codes
      __syncthreads();
      // the next segment's codes, into the buffer whose last readers just passed the barrier
      if (t + 1 < n_rounds) fetch_codes(tile, t + 1, (seg + 1) & 1);
      else fetch_codes(tile + gridDim.x, 0, (seg + 1) & 1);
      if (!staged && t + 1 < n_rounds) load(t + 1);  // in flight during the lookups
      const int ng = min(stage_groups, g_end - (g_begin + t * stage_groups));
      const uint32_t tb = sbase + buf * buf_bytes + s * 4;
      const uint32_t cb = cbase + (seg & 1) * stage_groups * tile_cols + lcol;
      for (int gi = rg; gi < ng; gi += row_groups) {
        uint32_t cw[kCW];
        lds_words<kCW>(cw, cb + gi * tile_cols);
        const uint32_t row = tb + (static_cast<uint32_t>(gi) << row_shift);
        uint32_t v[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          v[c] = lds32(row + (((cw[c / 4] >> (8 * (c % 4))) & 0xffu) << L::kRowShift));
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          if constexpr (KIND <= 1) {
            accf[c] += __uint_as_float(v[c]);
          } else if constexpr (KIND == 3) {
            acci[c][0] += static_cast<int32_t>(v[c] << 16) >> 16;
            if constexpr (kUsed > 1) acci[c][1] += static_cast<int32_t>(v[c]) >> 16;
          } else {
            pk[c][0] += __byte_perm(v[c], 0u, 0x4240);
            if constexpr (kUsed > 1) pk[c][1] += __byte_perm(v[c], 0u, 0x4341);
          }
        }
        ++n_groups;
        if constexpr (KIND == 2) {
          if (++n_packed == kFlush) widen();
        }
      }
    }
    if (resident) staged = true;
    widen();

    const int tile0 = tile * tile_cols;
    const bool active = tile0 + lcol < d_out_pad;
    if (row_groups == 1 && n_splits == 1) {
      // each lane writes its own columns of its tokens
      if (!active) continue;
      const int col0 = tile0 + lcol;
      float sc[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        sc[c] = scales != nullptr && col0 + c < d_out ? __ldg(scales + col0 + c) : 1.f;
      const bool vec = (d_out & 3) == 0 && col0 + kCols <= d_out;
#pragma unroll
      for (int j = 0; j < kUsed; ++j) {
        const int b = s * kSlots + j;
        if (b >= B) break;
        float* o = out + static_cast<size_t>(b) * d_out + col0;
        if (vec) {
#pragma unroll
          for (int c = 0; c < kCols; c += 4)
            *reinterpret_cast<float4*>(o + c) = make_float4(
                static_cast<float>(value(c, j)) * sc[c], static_cast<float>(value(c + 1, j)) * sc[c + 1],
                static_cast<float>(value(c + 2, j)) * sc[c + 2], static_cast<float>(value(c + 3, j)) * sc[c + 3]);
        } else {
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            if (col0 + c < d_out) o[c] = static_cast<float>(value(c, j)) * sc[c];
        }
      }
      continue;
    }

    // the row groups' partials in order, then (with splits) the blocks' in
    // rank order in the owner's inbox
    constexpr int kTok = L::kTokens;
#pragma unroll
    for (int j = 0; j < kUsed; ++j)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        red[(rg * kTok + s * kSlots + j) * tile_cols + lcol + c] = value(c, j);
    __syncthreads();
    const int n = BP * tile_cols;                 // (token, column) outputs of the tile
    if (n_splits > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    for (int e = tid; e < n; e += nt) {
      Acc p = red[e];
      for (int q = 1; q < row_groups; ++q) p += red[q * kTok * tile_cols + e];
      if (n_splits > 1) {
        const int owner = e / share;
        cluster.map_shared_rank(inbox, owner)[rank * share + e - owner * share] = p;
      } else {
        const int b = e >> tc_shift, j = tile0 + (e & (tile_cols - 1));
        if (b < B && j < d_out)
          out[static_cast<size_t>(b) * d_out + j] =
              static_cast<float>(p) * (scales != nullptr ? __ldg(scales + j) : 1.f);
      }
    }
    if (n_splits > 1) {
      cluster.sync();                             // every inbox is full
      for (int k = tid; k < share; k += nt) {
        const int e = rank * share + k;
        const int b = e >> tc_shift, j = tile0 + (e & (tile_cols - 1));
        if (e >= n || b >= B || j >= d_out) continue;
        Acc p = inbox[k];
        for (int q = 1; q < n_splits; ++q) p += inbox[q * share + k];
        const float sc = k == tid ? first_scale : scales != nullptr ? __ldg(scales + j) : 1.f;
        out[static_cast<size_t>(b) * d_out + j] = static_cast<float>(p) * sc;
      }
    } else {
      __syncthreads();                            // the partials are read before the next tile's
    }
  }
}

// The launch configuration of a plan, its attributes set; attr holds the
// cluster shape.
template <int KIND, int BP>
cudaError_t configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int grid_x,
                      int threads, int n_splits, int smem, cudaStream_t stream,
                      bool query = false) {
  *cfg = {};
  cfg->gridDim = dim3(grid_x, n_splits);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = n_splits;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = n_splits > 1 || query ? 1 : 0;  // one split: a plain launch
  // set once an instance (the shared memory when a plan needs more than any
  // before it): no CUDA runtime calls but the launch on the serving path
  static bool non_portable = false;
  static int smem_granted = 0;
  if (n_splits > 8 && !non_portable) {
    const cudaError_t e = cudaFuncSetAttribute(
        lut_scan<KIND, BP>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    non_portable = true;
  }
  if (smem > smem_granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        lut_scan<KIND, BP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_granted = smem;
  }
  return cudaSuccess;
}

template <int KIND, int BP>
int smem_bytes(int Kp, int threads, int tile_cols, int n_splits, int stage_groups, int nbuf) {
  using L = Layout<KIND, BP>;
  return Smem(L::kLanes, L::kTokens, Kp, threads, tile_cols, L::kCols, n_splits, stage_groups,
              nbuf).total;
}

struct Plan {
  int threads, tile_cols, n_splits, slice_groups, stage_groups, nbuf, grid_x;
};

// The plan's shape rules (kernels/lut_gemv.py::plan_scan keeps them).
template <int KIND, int BP>
bool bad_plan(const Plan& p, int Kp) {
  using L = Layout<KIND, BP>;
  if (p.threads < 32 || p.threads > kMaxThreads || p.threads % 32 || p.tile_cols < L::kCols ||
      p.tile_cols % L::kCols || p.n_splits < 1 || p.n_splits > kMaxSplits ||
      p.slice_groups < 1 || p.stage_groups < 1 || p.nbuf < 1 || p.grid_x < 1 ||
      (Kp != 128 && Kp != 256))
    return true;
  const int lanes = L::kLanes * (p.tile_cols / L::kCols);
  if (p.threads % lanes) return true;
  const int row_groups = p.threads / lanes;
  return p.stage_groups % row_groups || p.stage_groups * Kp / 4 > p.threads * L::kItems;
}

template <int KIND, int BP>
int launch(const void* tab, const void* codes, const void* scales, void* out, int B, int G,
           int Kp, int d_out, int d_out_pad, const Plan& p, cudaStream_t stream) {
  if (bad_plan<KIND, BP>(p, Kp) || B > BP) return static_cast<int>(cudaErrorInvalidValue);
  if (p.n_splits > 1 && p.grid_x != (d_out_pad + p.tile_cols - 1) / p.tile_cols)
    return static_cast<int>(cudaErrorInvalidValue);  // a split block takes one tile
  const int smem = smem_bytes<KIND, BP>(Kp, p.threads, p.tile_cols, p.n_splits, p.stage_groups,
                                        p.nbuf);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure<KIND, BP>(&cfg, &attr, p.grid_x, p.threads, p.n_splits, smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  using Src = typename Kind<KIND>::Src;
  e = cudaLaunchKernelEx(&cfg, lut_scan<KIND, BP>, static_cast<const Src*>(tab),
                         static_cast<const uint8_t*>(codes), static_cast<const float*>(scales),
                         static_cast<float*>(out), B, G, Kp, d_out, d_out_pad, p.tile_cols,
                         p.slice_groups, p.stage_groups, p.nbuf);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of the plan the card holds at once (or minus an error).
template <int KIND, int BP>
int max_clusters(int Kp, const Plan& p) {
  if (bad_plan<KIND, BP>(p, Kp)) return -static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes<KIND, BP>(Kp, p.threads, p.tile_cols, p.n_splits, p.stage_groups,
                                        p.nbuf);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure<KIND, BP>(&cfg, &attr, 1, p.threads, p.n_splits, smem, 0, true);
  int n = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&n, lut_scan<KIND, BP>, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// The (kind, BP) instance: kind 0 at one token, kinds 1-3 at 1, 2, 4, 8.
template <typename F>
int dispatch(int kind, int BP, F&& f) {
#define LUTVQ_SCAN_BP(K)                                    \
  switch (BP) {                                             \
    case 1: return f(std::integral_constant<int, K>{}, std::integral_constant<int, 1>{}); \
    case 2: return f(std::integral_constant<int, K>{}, std::integral_constant<int, 2>{}); \
    case 4: return f(std::integral_constant<int, K>{}, std::integral_constant<int, 4>{}); \
    case 8: return f(std::integral_constant<int, K>{}, std::integral_constant<int, 8>{}); \
    default: return -static_cast<int>(cudaErrorInvalidValue);                            \
  }
  switch (kind) {
    case 0:
      if (BP != 1) return -static_cast<int>(cudaErrorInvalidValue);
      return f(std::integral_constant<int, 0>{}, std::integral_constant<int, 1>{});
    case 1: LUTVQ_SCAN_BP(1)
    case 2: LUTVQ_SCAN_BP(2)
    case 3: LUTVQ_SCAN_BP(3)
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
#undef LUTVQ_SCAN_BP
}

}  // namespace

// kind: 0 = one token's f32 table rounded to bf16 (A, M), 1 = f32 (K),
// 2 = int8 (H), 3 = int16 (I); BP token slots (>= B; 1 for kind 0); the
// plan as kernels/lut_gemv.py::plan_scan gives it.
extern "C" int lutvq_lut_scan(int kind, const void* tab, const void* codes, const void* scales,
                              void* out, int B, int BP, int G, int Kp, int d_out, int d_out_pad,
                              int threads, int tile_cols, int n_splits, int slice_groups,
                              int stage_groups, int nbuf, int grid_x, void* stream_ptr) {
  if (G == 0 || d_out == 0 || B == 0) return 0;
  const Plan p{threads, tile_cols, n_splits, slice_groups, stage_groups, nbuf, grid_x};
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  const int r = dispatch(kind, BP, [&](auto k, auto bp) {
    return launch<decltype(k)::value, decltype(bp)::value>(tab, codes, scales, out, B, G, Kp,
                                                           d_out, d_out_pad, p, st);
  });
  return r < 0 ? -r : r;
}

// Clusters of a plan that fit the card at once (cudaOccupancyMaxActiveClusters;
// with one split, blocks), or minus a CUDA error.
extern "C" int lutvq_lut_scan_clusters(int kind, int BP, int Kp, int threads, int tile_cols,
                                       int n_splits, int stage_groups, int nbuf) {
  const Plan p{threads, tile_cols, n_splits, 1, stage_groups, nbuf, 1};
  return dispatch(kind, BP, [&](auto k, auto bp) {
    return max_clusters<decltype(k)::value, decltype(bp)::value>(Kp, p);
  });
}

extern "C" const char* lutvq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
