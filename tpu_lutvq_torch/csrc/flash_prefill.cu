// Flash-prefill attention over the int8 (or bf16) KV cache on Hopper (sm_90a).
//
// Replaces tpu_lutvq/kernels/flash_prefill.py::_kernel (flash_prefill_attention).
// Query t of sequence b sits at position t_off[b] + t and attends to cache rows
// s <= t_off[b] + t.  Rounding points of the reference (flash_prefill.py:82-113),
// which differ from decode's:
//     qb  = bf16(q)                                    (unscaled)
//     s   = ((qb . K_s) * sm_scale) * ks_s            (f32 dot, then the scales)
//     per block of block_s KV rows: m' = max(m, max s); alpha = exp(m - m')
//     p   = exp(s - m');  l = l*alpha + sum p;  acc = acc*alpha + bf16(p*vs) . V
//     out = acc / l
// The running max moves once per block_s rows.  Query rows are independent
// and a KV block wholly above a row's diagonal leaves its state unchanged,
// so the query tiling does not change the function: the reference's block_q
// is a TPU tiling, and this kernel tiles queries by 64.
//
// What bounds it on the H100: at chunked-admission sizes (T = 256 queries
// over a window of up to a few thousand rows) not the bytes (0.0044 ms at
// B=1, 32/32 heads, T = 256 at offset 512) but each block's chain of 64-row
// KV sub-tiles: a warp's 64 mma.sync a sub-tile come with ~300 other
// instructions (scaling, masking, exp, the int8 conversion), every warp
// reads the whole sub-tile from shared memory (ldmatrix), and one or two
// blocks of 4 warps an SM hide little latency.  So the design shortens the
// chain of the slowest block and keeps the card's blocks in one wave
// (kernels/flash_prefill.py::plan_prefill picks the split from the shapes
// and the card's cluster occupancy):
//   - a (query tile of 64, head, sequence) is served by one thread-block
//     cluster of n_split <= 8 blocks.  The window is cut into chunks of
//     `chunk` rows (a KV block, or a half or quarter of one); chunk c goes
//     to rank c % n_split in round c / n_split, and n_split is a multiple
//     of a block's chunks, so every KV block lies within one round.  A rank
//     whose first chunk lies above the tile's last query position exits at
//     once (no other block reads it);
//   - 4 warps, 16 query rows each; a warp keeps its bf16 Q fragments in
//     registers.  Each KV sub-tile of 64 rows (with its 64 row scales) is
//     one cp.async group of a 3-slot ring, issued two sub-tiles ahead; int8
//     sub-tiles are converted exactly to bf16 in one row-major pass (a byte
//     permute and an add per value, padded rows), bf16 ones land padded; K
//     and V B-fragments come from ldmatrix (.x4; .trans for V), so V is
//     never transposed by hand.  Two barriers a sub-tile;
//   - one pass per chunk: Q.K^T runs once, and the chunk's scaled, masked
//     f32 scores (up to 256 columns, a thread's own C fragments, 64 KiB)
//     stay in shared memory.  Each round, every rank publishes its chunk's
//     row maxima in its shared memory and, after cluster.sync(), reads the
//     others' through distributed shared memory: the chunks of earlier
//     rounds, and this round's chunks of its own KV block and the blocks
//     before it, make the reference's own prefix max m_s = max(block maxima
//     0..s) of its block s.  So p is exp(s - m_s) and bf16(p*vs) rounds
//     where the reference rounds it (the exact-prefix-max rule of
//     flash_decode.cu); a split at each chunk's own max would move that
//     rounding point.  Round-robin chunks keep every rank's scores to one
//     chunk: no Q.K^T runs twice;
//   - the ranks' (m, l, acc) meet in rank order through distributed shared
//     memory: out = sum_q acc_q e^(m_q - M) / sum_q l_q e^(m_q - M), M the
//     largest m_q (one live rank writes its own outputs).  One launch, no
//     workspace, and two calls are bit-equal.
// p is exp2((s - m') * log2 e) on the SFU (relative error ~2^-22, where
// expf differs from torch.exp by an ulp): it moves no rounding point.
// Kernel and plain version differ only in f32 arithmetic order (the
// tensor-core dot products, sum p, the rescaling by e^(m_q - M) instead of
// a product of alphas) and that last bit of p.
// Left for later: wgmma; 32 query rows a warp (each ldmatrix feeding twice
// the mma); one block per kv head for all rep query heads (the 64/8 layout
// reads each K/V sub-tile once per query head, from L2).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;       // query rows a block (16 a warp)
constexpr int kSub = 64;      // KV rows a sub-tile (one ring slot)
constexpr int kMaxBlock = 256;  // rows of a KV block: its scores stay in shared memory
constexpr int kRing = 3;        // ring slots
constexpr int kMaxSplit = 8;    // portable cluster size
constexpr int kMaxRounds = 16;  // chunks (rounds) a rank may take
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// bf16(lo) | bf16(hi) << 16, each rounded to nearest even (one instruction)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// 2^x, the SFU's approximation (relative error ~2^-22.5)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

struct Args {
  const float* q;     // (B, T, H, DH) f32, post-RoPE
  const void* k;      // (B, Hkv, S, DH) int8 or bf16
  const void* v;
  const float* ks;    // (B, Hkv, S) f32
  const float* vs;
  const int* t_off;   // (B,)
  float* out;         // (B, T, H, DH) f32
  int T, H, Hkv, S, nblk, block_s, chunk;
  float sm_scale;
};

// Shared-memory layout of a block, in bytes.
template <int DH, bool INT8>
struct Layout {
  static constexpr int kRow = DH + 8;  // bf16 elements of a padded row
  static constexpr int kRows = kSub * kRow * 2;  // a sub-tile's padded bf16 rows
  static constexpr int kData = INT8 ? kSub * DH : kRows;
  static constexpr int kSlot = kData + kSub * 4;  // the rows, then their scales
  // int8: the converted rows of the sub-tile being computed, and its scales
  static constexpr int kConv = INT8 ? kRows + kSub * 4 : 0;
  // a chunk's scores (float4 per n-tile and thread), later the (64, DH)
  // f32 partials
  static __host__ __device__ int region(int chunk) {
    return (chunk > DH ? chunk : DH) * kThreads * 2;
  }
  static __host__ __device__ int bytes(int chunk) {
    return region(chunk) + kRing * kSlot + kConv;
  }
};

// Sub-tile rows [row0, row0 + 64) (and their row scales) into a slot.
template <int DH, bool INT8>
__device__ __forceinline__ void load_sub(unsigned char* slot, const void* src,
                                         const float* scale, size_t row0) {
  using L = Layout<DH, INT8>;
  constexpr int kEsz = INT8 ? 1 : 2;
  constexpr int kChunks = DH * kEsz / 16;  // 16-byte chunks a row
  constexpr int kDst = INT8 ? DH : L::kRow * 2;
  const unsigned char* g = static_cast<const unsigned char*>(src) + row0 * DH * kEsz;
#pragma unroll
  for (int u = 0; u < kSub * kChunks / kThreads; ++u) {
    const int i = u * kThreads + threadIdx.x;
    const int r = i / kChunks, c = i - r * kChunks;
    cp_async16(slot + r * kDst + c * 16, g + (r * DH * kEsz + c * 16));
  }
  if (threadIdx.x < kSub)
    cp_async4(slot + L::kData + threadIdx.x * 4, scale + row0 + threadIdx.x);
}

// Four int8 values of a word as two bf16x2 words, exactly: each biased byte
// becomes the low mantissa byte of 2^23 (an exact f32 after the bias is
// taken off), and a small integer's f32 is its bf16 in the upper half.
__device__ __forceinline__ uint2 i8x4_bf16(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
  return make_uint2(__byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632),
                    __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632));
}

// An int8 slot's rows as padded bf16 rows, and its scales, into the
// conversion buffer: every thread's loads first, then the conversions.
template <int DH>
__device__ __forceinline__ void convert(unsigned char* dst, const unsigned char* slot) {
  using L = Layout<DH, true>;
  constexpr int kPer = kSub * DH / 8 / kThreads;  // 8-byte chunks a thread
  uint2 w[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u)
    w[u] = *reinterpret_cast<const uint2*>(slot + (u * kThreads + threadIdx.x) * 8);
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = u * kThreads + threadIdx.x;
    const int r = i / (DH / 8), c = i - r * (DH / 8);
    const uint2 lo = i8x4_bf16(w[u].x), hi = i8x4_bf16(w[u].y);
    *reinterpret_cast<uint4*>(dst + (r * L::kRow + c * 8) * 2) = make_uint4(lo.x, lo.y, hi.x, hi.y);
  }
  if (threadIdx.x < kSub / 4)
    reinterpret_cast<float4*>(dst + L::kRows)[threadIdx.x] =
        reinterpret_cast<const float4*>(slot + L::kData)[threadIdx.x];
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// grid (n_split * query tiles, H, B), clusters of n_split blocks along x.
template <int DH, bool INT8>
__global__ void __launch_bounds__(kThreads)
flash_prefill_cluster(Args a) {
  using L = Layout<DH, INT8>;
  constexpr int KS = DH / 16;           // k-steps of Q.K^T
  constexpr int DT = DH / 8;            // output n-tiles
  constexpr int kAhead = kRing - 1;     // sub-tiles issued ahead of the one computed
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float cmax[kMaxRounds][kBQ];  // each round's chunk row maxima
  __shared__ float mfin[kBQ], lfin[kBQ];
  float4* sc = reinterpret_cast<float4*>(smem);  // [n-tile of the chunk][thread]
  unsigned char* ring = smem + L::region(a.chunk);
  unsigned char* conv = ring + kRing * L::kSlot;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_split = static_cast<int>(cluster.num_blocks());
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.Hkv);
  const int q0 = (blockIdx.x / n_split) * kBQ;
  const int pos_b = a.t_off[b];
  const int qlast = pos_b + min(q0 + kBQ, a.T) - 1;  // the tile's last query position
  const int cpb = a.block_s / a.chunk;                   // chunks a KV block
  // the last chunk with a row at or below it
  const int last = min(a.nblk * cpb - 1, qlast / a.chunk);
  if (rank > last) return;  // uniform: all this rank's chunks lie above the diagonal
  const int n_live = min(n_split, last + 1);             // ranks that did not exit
  const int rounds = last / n_split + 1;                 // rounds with a live chunk
  const int own = (last - rank) / n_split + 1;           // this rank's live chunks
  const int full = a.chunk / kSub;                       // sub-tiles of a chunk
  // sub-tiles of this rank's last live chunk with a row at or below qlast
  const int tail = min(full, (qlast - ((own - 1) * n_split + rank) * a.chunk) / kSub + 1);
  const int n_items = 2 * full * (own - 1) + 2 * tail;
  const size_t plane = (static_cast<size_t>(b) * a.Hkv + g) * a.S;

  // item i of the ring: round r, V?, sub-tile j; each round its K sub-tiles
  // and then its V sub-tiles
  auto item = [&](int i, int* r, bool* is_v) -> int {
    *r = i / (2 * full);
    const int ns = *r == own - 1 ? tail : full;
    const int k = i - *r * 2 * full;
    *is_v = k >= ns;
    return *is_v ? k - ns : k;
  };
  // one cp.async group per item, empty past the last, so that the counts of
  // the waits below hold to the end
  auto issue = [&](int i) {
    if (i < n_items) {
      int r;
      bool is_v;
      const int j = item(i, &r, &is_v);
      load_sub<DH, INT8>(ring + (i % kRing) * L::kSlot, is_v ? a.v : a.k, is_v ? a.vs : a.ks,
                         plane + static_cast<size_t>(r * n_split + rank) * a.chunk + j * kSub);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
#pragma unroll
  for (int i = 0; i < kAhead; ++i) issue(i);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int r_lo = warp * 16 + gid, r_hi = r_lo + 8;  // this thread's rows of the tile
  const int t_lo = q0 + r_lo, t_hi = q0 + r_hi;
  const int qpos_lo = pos_b + t_lo, qpos_hi = pos_b + t_hi;

  uint32_t qa[KS][4];  // bf16(q), A fragments, for the whole run
  {
    const float* ql = a.q + ((static_cast<size_t>(b) * a.T + t_lo) * a.H + h) * DH;
    const float* qh = a.q + ((static_cast<size_t>(b) * a.T + t_hi) * a.H + h) * DH;
    const float2 zero = make_float2(0.f, 0.f);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int c = kk * 16 + tig * 2;
      const float2 l0 = t_lo < a.T ? *reinterpret_cast<const float2*>(ql + c) : zero;
      const float2 l1 = t_lo < a.T ? *reinterpret_cast<const float2*>(ql + c + 8) : zero;
      const float2 h0 = t_hi < a.T ? *reinterpret_cast<const float2*>(qh + c) : zero;
      const float2 h1 = t_hi < a.T ? *reinterpret_cast<const float2*>(qh + c + 8) : zero;
      qa[kk][0] = pack_bf16(l0.x, l0.y);
      qa[kk][1] = pack_bf16(h0.x, h0.y);
      qa[kk][2] = pack_bf16(l1.x, l1.y);
      qa[kk][3] = pack_bf16(h1.x, h1.y);
    }
  }
  // item 0's rows ready (int8: converted)
  cp_async_wait<kAhead - 1>();
  __syncthreads();
  if constexpr (INT8) {
    convert<DH>(conv, ring);
    __syncthreads();
  }

  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float mx[2] = {kNegInf, kNegInf};   // phase 1: this round's chunk row max
  float m[2] = {kNegInf, kNegInf};    // the running max: this round's prefix max
  float seen[2] = {kNegInf, kNegInf};  // max over every chunk of the rounds read
  float pm[2];                         // phase 2: this round's prefix max
  float l[2] = {0.f, 0.f};             // this thread's columns of sum p

  // Two barriers an item.  At the top of iteration i item i's rows are
  // ready (int8: converted, so its raw slot is free), and item i + 2 goes
  // to slot (i + 2) % 3, which held item i - 1.
  for (int i = 0; i < n_items; ++i) {
    issue(i + kAhead);
    int r;
    bool is_v;
    const int j = item(i, &r, &is_v);
    const unsigned char* buf = INT8 ? conv : ring + (i % kRing) * L::kSlot;
    const uint16_t* rows = reinterpret_cast<const uint16_t*>(buf);
    const float* scale = reinterpret_cast<const float*>(buf + L::kRows);
    const int col0 = j * (kSub / 8);  // the sub-tile's first n-tile of the chunk

    if (!is_v) {
      // scores of the sub-tile: Q.K^T, sm_scale, k row-scale, causal mask
      float s[kSub / 8][4];
#pragma unroll
      for (int nt = 0; nt < kSub / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk2 = 0; kk2 < KS / 2; ++kk2)
#pragma unroll
        for (int nt = 0; nt < kSub / 8; ++nt) {
          uint32_t bb[4];
          ldmatrix_x4(bb, rows + (nt * 8 + (lane & 7)) * L::kRow + kk2 * 32 + (lane >> 3) * 8);
          mma_bf16(s[nt], qa[2 * kk2], bb[0], bb[1]);
          mma_bf16(s[nt], qa[2 * kk2 + 1], bb[2], bb[3]);
        }
      const int c0 = (r * n_split + rank) * a.chunk + j * kSub;  // first cache row
#pragma unroll
      for (int nt = 0; nt < kSub / 8; ++nt) {
        const float2 ks = INT8 ? *reinterpret_cast<const float2*>(scale + nt * 8 + tig * 2)
                               : make_float2(1.f, 1.f);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[nt][e] * a.sm_scale;
          if (INT8) x *= (e & 1) ? ks.y : ks.x;
          s[nt][e] = x;
        }
      }
      if (c0 + kSub - 1 > pos_b + q0) {  // the diagonal crosses the sub-tile
#pragma unroll
        for (int nt = 0; nt < kSub / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (c0 + nt * 8 + tig * 2 + (e & 1) > (e < 2 ? qpos_lo : qpos_hi)) s[nt][e] = kNegInf;
      }
#pragma unroll
      for (int nt = 0; nt < kSub / 8; ++nt) {
        sc[(col0 + nt) * kThreads + threadIdx.x] = make_float4(s[nt][0], s[nt][1], s[nt][2],
                                                               s[nt][3]);
        mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
      }
      if (j == (r == own - 1 ? tail : full) - 1) {
        // the chunk's row maxima: publish them, and read this round's
        // chunks of every live rank (the earlier rounds' are in `seen`):
        // those of ranks below `upto` lie in this chunk's KV block or before
        // it, and make its prefix max
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 1));
          mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 2));
        }
        if (tig == 0) {
          cmax[r][r_lo] = mx[0];
          cmax[r][r_hi] = mx[1];
        }
        mx[0] = mx[1] = kNegInf;
        cluster.sync();
        pm[0] = seen[0];
        pm[1] = seen[1];
        const int live = min(n_split, last + 1 - r * n_split);  // ranks with a chunk this round
        const int upto = ((r * n_split + rank) / cpb + 1) * cpb - r * n_split;
        for (int q = 0; q < live; ++q) {
          const float* other = cluster.map_shared_rank(&cmax[r][0], q);
          const float x0 = other[r_lo], x1 = other[r_hi];
          if (q < upto) {
            pm[0] = fmaxf(pm[0], x0);
            pm[1] = fmaxf(pm[1], x1);
          }
          seen[0] = fmaxf(seen[0], x0);
          seen[1] = fmaxf(seen[1], x1);
        }
      }
    } else {
      if (j == 0) {
        // this round's chunk: its KV block's prefix max, and the state
        // rescaled to it
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float alpha = ex2((m[u] - pm[u]) * kLog2e);
          m[u] = pm[u];
          l[u] *= alpha;
#pragma unroll
          for (int dt = 0; dt < DT; ++dt) {
            o[dt][2 * u] *= alpha;
            o[dt][2 * u + 1] *= alpha;
          }
        }
      }
      // p, its sum, bf16(p * vs), and p.V
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
        float p[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float4 x = sc[(col0 + 2 * kk + u) * kThreads + threadIdx.x];
          const float2 vs = INT8 ? *reinterpret_cast<const float2*>(
                                       scale + (2 * kk + u) * 8 + tig * 2)
                                 : make_float2(1.f, 1.f);
          p[u][0] = ex2((x.x - m[0]) * kLog2e);
          p[u][1] = ex2((x.y - m[0]) * kLog2e);
          p[u][2] = ex2((x.z - m[1]) * kLog2e);
          p[u][3] = ex2((x.w - m[1]) * kLog2e);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            l[e >> 1] += p[u][e];
            if (INT8) p[u][e] *= (e & 1) ? vs.y : vs.x;
          }
        }
        const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                                pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
#pragma unroll
        for (int dt2 = 0; dt2 < DT / 2; ++dt2) {
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, rows + (kk * 16 + (lane & 15)) * L::kRow + dt2 * 16 +
                                    (lane >> 4) * 8);
          mma_bf16(o[2 * dt2], pa, bb[0], bb[1]);
          mma_bf16(o[2 * dt2 + 1], pa, bb[2], bb[3]);
        }
      }
    }
    cp_async_wait<kAhead - 1>();  // item i + 1 landed
    __syncthreads();  // every thread is done with item i's rows
    if constexpr (INT8) {
      if (i + 1 < n_items) convert<DH>(conv, ring + ((i + 1) % kRing) * L::kSlot);
      __syncthreads();
    }
  }
  cp_async_wait<0>();
  for (int r = own; r < rounds; ++r) cluster.sync();  // the rounds this rank has no chunk in

  // this block's (m, l, acc); alone, it writes the tile's outputs itself
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    l[u] += __shfl_xor_sync(0xffffffffu, l[u], 1);
    l[u] += __shfl_xor_sync(0xffffffffu, l[u], 2);
  }
  if (n_live == 1) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int t = u == 0 ? t_lo : t_hi;
      if (t >= a.T) continue;
      float* dst = a.out + ((static_cast<size_t>(b) * a.T + t) * a.H + h) * DH;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
        *reinterpret_cast<float2*>(dst + dt * 8 + tig * 2) =
            make_float2(o[dt][2 * u] / l[u], o[dt][2 * u + 1] / l[u]);
    }
    return;  // every other rank has exited: no one reads this block
  }
  float* acc = reinterpret_cast<float*>(smem);  // [kBQ][DH], over the scores
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = dt * 8 + tig * 2;
    *reinterpret_cast<float2*>(acc + r_lo * DH + c) = make_float2(o[dt][0], o[dt][1]);
    *reinterpret_cast<float2*>(acc + r_hi * DH + c) = make_float2(o[dt][2], o[dt][3]);
  }
  if (tig == 0) {
    mfin[r_lo] = m[0];
    mfin[r_hi] = m[1];
    lfin[r_lo] = l[0];
    lfin[r_hi] = l[1];
  }
  cluster.sync();
  // each row's weights e^(m_q - M), M the largest m_q, and the denominator
  // sum_q l_q e^(m_q - M) in rank order (over the ring, which is idle now)
  float* wgt = reinterpret_cast<float*>(ring);  // [kMaxSplit][kBQ]
  float* den = wgt + kMaxSplit * kBQ;           // [kBQ]
  if (threadIdx.x < kBQ) {
    const int row = threadIdx.x;
    float mq[kMaxSplit], lq[kMaxSplit];
    float mm = kNegInf;
#pragma unroll
    for (int q = 0; q < kMaxSplit; ++q)
      if (q < n_live) {
        mq[q] = cluster.map_shared_rank(mfin, q)[row];
        lq[q] = cluster.map_shared_rank(lfin, q)[row];
        mm = fmaxf(mm, mq[q]);
      }
    float d = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxSplit; ++q)
      if (q < n_live) {
        const float w = ex2((mq[q] - mm) * kLog2e);
        wgt[q * kBQ + row] = w;
        d = fmaf(lq[q], w, d);
      }
    den[row] = d;
  }
  __syncthreads();
  // this rank's share of the tile's outputs (float4 e4 = rank * 128 +
  // thread, strided by the live ranks), the ranks' partials in rank order,
  // each rank's read for all of a thread's outputs at once
  constexpr int kVec = kBQ * DH / 4;                // float4s of the tile
  constexpr int kPer = kVec / (2 * kThreads);       // a thread's, two ranks or more
  const int stride = n_live * kThreads;
  float4 num[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) num[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int q = 0; q < n_live; ++q) {
    const float4* src = reinterpret_cast<const float4*>(
        q == rank ? acc : cluster.map_shared_rank(acc, q));
    float4 x[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e4 = rank * kThreads + threadIdx.x + k * stride;
      if (e4 < kVec) x[k] = src[e4];
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e4 = rank * kThreads + threadIdx.x + k * stride;
      if (e4 >= kVec) break;
      const float w = wgt[q * kBQ + e4 / (DH / 4)];
      num[k].x = fmaf(x[k].x, w, num[k].x);
      num[k].y = fmaf(x[k].y, w, num[k].y);
      num[k].z = fmaf(x[k].z, w, num[k].z);
      num[k].w = fmaf(x[k].w, w, num[k].w);
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e4 = rank * kThreads + threadIdx.x + k * stride;
    const int row = e4 / (DH / 4), t = q0 + row;
    if (e4 >= kVec) break;
    if (t >= a.T) continue;
    const float d = den[row];
    reinterpret_cast<float4*>(a.out + ((static_cast<size_t>(b) * a.T + t) * a.H + h) * DH)
        [e4 % (DH / 4)] = make_float4(num[k].x / d, num[k].y / d, num[k].z / d, num[k].w / d);
  }
  cluster.sync();  // no block leaves while its partials are read
}

template <int DH, bool INT8>
cudaError_t configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, dim3 grid,
                      int n_split, int chunk, cudaStream_t st) {
  const int smem = Layout<DH, INT8>::bytes(chunk);
  *cfg = {};
  cfg->gridDim = grid;
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = n_split;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaFuncSetAttribute(flash_prefill_cluster<DH, INT8>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int DH, bool INT8>
int launch(const Args& a, int B, int n_split, cudaStream_t st) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const dim3 grid(n_split * ((a.T + kBQ - 1) / kBQ), a.H, B);
  cudaError_t e = configure<DH, INT8>(&cfg, &attr, grid, n_split, a.chunk, st);
  if (e == cudaSuccess) e = cudaLaunchKernelEx(&cfg, flash_prefill_cluster<DH, INT8>, a);
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}

template <int DH, bool INT8>
int max_clusters(int n_split, int chunk) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure<DH, INT8>(&cfg, &attr, dim3(n_split), n_split, chunk, 0);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveClusters(&n, flash_prefill_cluster<DH, INT8>, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// A split the kernel takes: chunks of whole sub-tiles that divide the KV
// block, and clusters of whole KV blocks' chunks.
bool bad_split(int block_s, int chunk, int n_split) {
  return chunk < kSub || chunk % kSub || block_s > kMaxBlock || block_s % chunk ||
         n_split < 1 || n_split > kMaxSplit || n_split % (block_s / chunk);
}

}  // namespace

// nblk KV blocks of block_s rows (a multiple of 64, at most 256) over the
// first nblk * block_s rows of each (b, g) plane of S rows, in chunks of
// `chunk` rows; clusters of n_split blocks, chunk c taken by rank
// c % n_split in round c / n_split.
extern "C" int lutvq_flash_prefill(const void* q, const void* k, const void* v,
                                   const void* ks, const void* vs, const void* t_off,
                                   void* out, int B, int T, int H, int Hkv, int Dh, int S,
                                   int nblk, int block_s, int chunk, int n_split, int kv_int8,
                                   float sm_scale, void* stream_ptr) {
  if (Hkv < 1 || H % Hkv || bad_split(block_s, chunk, n_split) ||
      nblk * (block_s / chunk) < n_split || nblk * (block_s / chunk) > n_split * kMaxRounds ||
      nblk * block_s > S || (Dh != 64 && Dh != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || T == 0) return 0;
  Args a;
  a.q = static_cast<const float*>(q);
  a.k = k;
  a.v = v;
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.t_off = static_cast<const int*>(t_off);
  a.out = static_cast<float*>(out);
  a.T = T;
  a.H = H;
  a.Hkv = Hkv;
  a.S = S;
  a.nblk = nblk;
  a.block_s = block_s;
  a.chunk = chunk;
  a.sm_scale = sm_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  if (Dh == 128)
    return kv_int8 ? launch<128, true>(a, B, n_split, st) : launch<128, false>(a, B, n_split, st);
  return kv_int8 ? launch<64, true>(a, B, n_split, st) : launch<64, false>(a, B, n_split, st);
}

// Clusters of n_split blocks over chunks of `chunk` rows that fit the card
// at once (cudaOccupancyMaxActiveClusters), or minus a CUDA error.
extern "C" int lutvq_flash_prefill_clusters(int Dh, int kv_int8, int n_split, int chunk) {
  if (chunk < kSub || chunk > kMaxBlock || chunk % kSub || n_split < 1 || n_split > kMaxSplit)
    return -static_cast<int>(cudaErrorInvalidValue);
  if (Dh == 128)
    return kv_int8 ? max_clusters<128, true>(n_split, chunk)
                   : max_clusters<128, false>(n_split, chunk);
  if (Dh == 64)
    return kv_int8 ? max_clusters<64, true>(n_split, chunk)
                   : max_clusters<64, false>(n_split, chunk);
  return -static_cast<int>(cudaErrorInvalidValue);
}
