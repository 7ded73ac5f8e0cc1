// Flash-decode attention over the int8 (or bf16) KV cache, slab and paged,
// on Hopper (sm_90a).
//
// Replaces tpu_lutvq/kernels/flash_decode.py::_kernel (flash_decode_attention)
// and ::_kernel_paged (flash_decode_paged).  Both compute, per sequence b and
// query head h = g*rep + r over kv head g, with the rounding points of the
// reference (flash_decode.py:108-143, _prep_q :156-165):
//     qb    = bf16(q * sm_scale)                       (f32 product, then bf16)
//     s_j   = (qb . K_j) * ks_j    (f32 sum; int8/bf16 K exact)  masked if j > pos[b]
//     per block of block_s rows:  m' = max(m, max_j s_j);  alpha = exp(m - m')
//     p_j   = exp(s_j - m');  l = l*alpha + sum_j p_j
//     acc   = acc*alpha + sum_j bf16(p_j * vs_j) * V_j      (f32)
//     out   = acc / l
// The running max moves once per block: block_s rows of the slab, or one
// pool block (its BS rows, through block_tables[b, s]) for the paged cache.
// One template serves both; the paged form reads the table inside the
// kernel, with no gather copy.
//
// What bounds it on the H100: the K/V bytes, rows * H_kv * (2 Dh + 8) for
// int8, read once (47.6 MB at B=8, 32 kv heads, the ragged positions of
// chip_smoke.py: 14 us at 3.35 TB/s).  So the card has to be filled with
// loads, and one block per (kv head, sequence) walking its whole window (the
// first port: 32 blocks at B=1, ~190 ns a row of latency) cannot.
//
// The design splits the window into chunks of C rows across blocks without
// moving a rounding point.  The m' that rounds bf16(p * vs) in block s is the
// prefix max of the block maxima of blocks 0..s (blocks wholly past pos[b]
// skipped), and that is known before any p is formed:
//   pass 1 (grid chunks x H_kv x B): each chunk's masked scores of its rep
//     query rows into an f32 workspace, and each chunk's max;
//   pass 2 (same grid): each chunk takes the prefix max m_s of its reference
//     block (the max over the chunk maxima of blocks 0..s), forms p =
//     exp(s - m_s), rounds bf16(p * vs) where the reference does, and writes
//     its partials sum_j bf16(p vs) V_j and sum_j p (f32) with m_s;
//   combine (grid H x B): out = sum_c acc_c e^(m_c - m) / sum_c l_c e^(m_c - m)
//     over the valid chunks in chunk order, m the last chunk's (the largest)
//     prefix max: deterministic, two calls are bit-equal.
// A chunk lies inside one reference block (C divides block_s;
// kernels/flash_decode.py::plan_decode picks C and the grid from (B, H_kv,
// window, block_s) only, so pos stays on the device: chunks wholly past
// pos[b] exit at once).  Kernel and plain version then differ only in f32
// summation order (the dot products, sum p, the rescaling by e^(m_c - m)
// instead of a product of alphas), as before the split.  A split that
// rounded p against each chunk's own max (flash-decoding as usually written)
// was rejected: it moves the rounding point that the p_f32 control moves,
// and would read at the control's error, not under the limit.
// Inside a chunk the K (pass 1) or V (pass 2) rows, one contiguous span of
// the cache, stream into shared memory through cp.async, one group per 32
// rows, all in flight at once; compute on tile t waits for group t only.
// Pass 1 reduces a row's dot products over LPR = Dh / VPL lanes (8 at the
// 7B layout), so every warp has 4 rows in flight and q stays in registers
// (VPL * rep <= 32 values a lane); pass 2 forms p over all 128 threads and
// then each warp adds bf16(p vs) V over its rows, a lane owning Dh / 32
// output columns of every query row.  int8 converts to f32 by a byte
// permute into a float's mantissa (exact).
// Left for later: tensor cores for rep >= 4 (the 70B 64/8 layout).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRep = 8;
constexpr int kMaxBlock = 512;
constexpr int kMaxChunk = 128;  // rows a chunk (plan_decode's KERNEL_MAX_CHUNK)
constexpr int kTileRows = 32;   // rows a cp.async group
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float bf16_round(float x) {
  // round to nearest even on the upper 16 bits (inputs are finite)
  uint32_t u = __float_as_uint(x);
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}

// Four int8 values of a word, exactly, as f32: each biased byte becomes the
// low mantissa byte of 2^23, and the bias is subtracted.
__device__ __forceinline__ void int8x4(uint32_t w, float* x) {
  const uint32_t u = w ^ 0x80808080u;
  x[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  x[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  x[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  x[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
}

__device__ __forceinline__ void bf16x2(uint32_t w, float* x) {
  x[0] = __uint_as_float(w << 16);
  x[1] = __uint_as_float(w & 0xffff0000u);
}

// N consecutive values of a row in shared memory as f32 (N = 2, 4, 8 or 16).
template <int N, bool INT8>
__device__ __forceinline__ void load_vals(const unsigned char* p, float (&x)[N]) {
  if constexpr (INT8 && N == 2) {
    const uint32_t w = *reinterpret_cast<const uint16_t*>(p);
    float t[4];
    int8x4(w, t);
    x[0] = t[0];
    x[1] = t[1];
  } else if constexpr (INT8 && N == 4) {
    int8x4(*reinterpret_cast<const uint32_t*>(p), x);
  } else if constexpr (INT8 && N == 8) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    int8x4(w.x, x); int8x4(w.y, x + 4);
  } else if constexpr (INT8) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    int8x4(w.x, x); int8x4(w.y, x + 4); int8x4(w.z, x + 8); int8x4(w.w, x + 12);
  } else if constexpr (N == 2) {
    bf16x2(*reinterpret_cast<const uint32_t*>(p), x);
  } else if constexpr (N == 4) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    bf16x2(w.x, x); bf16x2(w.y, x + 2);
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      const uint4 w = *reinterpret_cast<const uint4*>(p + 2 * i);
      bf16x2(w.x, x + i); bf16x2(w.y, x + i + 2); bf16x2(w.z, x + i + 4);
      bf16x2(w.w, x + i + 6);
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Waits until at most `pending` (0..3) of this thread's groups are in flight,
// then for every thread's copies.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::); break;
  }
  __syncthreads();
}

// The problem, as both passes see it.
struct Args {
  const float* q;       // (B, H, DH) f32, post-RoPE
  const void* k;        // slab (B, Hkv, S, DH) or pool (N, Hkv, block_s, DH)
  const void* v;
  const float* ks;      // slab (B, Hkv, S) or pool (N, Hkv, block_s)
  const float* vs;
  const int* pos;       // (B,)
  const int* tables;    // (B, max_blocks), or null for the slab
  float* out;           // (B, H, DH)
  float* scores;        // (B, H, W) workspace, W = n_chunks * chunk
  float* cmax;          // (B, H, n_chunks): each chunk's max (pass 1)
  float* acc;           // (B, H, n_chunks, DH): pass 2's partials
  float* lsum;          // (B, H, n_chunks)
  float* msum;          // (B, H, n_chunks): the prefix max each chunk used
  int H, Hkv, S, block_s, max_blocks, chunk, n_chunks;
  float sm_scale;
};

// The chunk's first row in the cache, in rows, and its valid rows (0 when it
// lies wholly past pos[b]).
__device__ __forceinline__ int chunk_rows(const Args& a, int c, int g, int b, size_t* row0) {
  const int start = c * a.chunk;
  const int pos_b = a.pos[b];
  if (start > pos_b) return 0;
  if (a.tables != nullptr) {
    const int blk = start / a.block_s;
    *row0 = (static_cast<size_t>(a.tables[b * a.max_blocks + blk]) * a.Hkv + g) * a.block_s +
            (start - blk * a.block_s);
  } else {
    *row0 = (static_cast<size_t>(b) * a.Hkv + g) * a.S + start;
  }
  return min(a.chunk, pos_b - start + 1);
}

// Issues the chunk's `valid` rows of `src` into `dst`, one group per tile;
// returns the number of tiles.
template <int DH, bool INT8>
__device__ __forceinline__ int stream_rows(unsigned char* dst, const void* src, size_t row0,
                                           int valid) {
  constexpr int kRowBytes = DH * (INT8 ? 1 : 2);
  const unsigned char* g = static_cast<const unsigned char*>(src) + row0 * kRowBytes;
  const int tiles = (valid + kTileRows - 1) / kTileRows;
  for (int t = 0; t < tiles; ++t) {
    const int n16 = min(kTileRows, valid - t * kTileRows) * kRowBytes / 16;
    const size_t base = static_cast<size_t>(t) * kTileRows * kRowBytes;
    for (int i = threadIdx.x; i < n16; i += kThreads)
      cp_async16(dst + base + i * 16, g + base + i * 16);
    cp_async_commit();
  }
  return tiles;
}

// Pass 1: scores of one chunk's rows for the rep query rows of kv head g.
template <int DH, bool INT8, int REPC>
__global__ void __launch_bounds__(kThreads)
decode_scores(Args a) {
  // values a lane holds of a row: q stays in registers (rep * VPL <= 32
  // floats), and a row is reduced over LPR = DH / VPL lanes
  constexpr int VPL = REPC <= 2 ? 16 : 32 / REPC;
  constexpr int LPR = DH / VPL;          // lanes a row
  constexpr int RPS = kThreads / LPR;    // rows a step of the block
  constexpr int kRowBytes = DH * (INT8 ? 1 : 2);
  static_assert(LPR <= 32 && kTileRows % RPS == 0, "row split");
  extern __shared__ __align__(16) unsigned char smem[];
  float* sc = reinterpret_cast<float*>(smem + kMaxChunk * kRowBytes);  // [rep][chunk]
  __shared__ float red[kWarps][kMaxRep];
  const int c = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int rep = a.H / a.Hkv;
  size_t row0 = 0;
  const int valid = chunk_rows(a, c, g, b, &row0);
  if (valid == 0) return;  // uniform: the whole chunk is past pos[b]
  const int tiles = stream_rows<DH, INT8>(smem, a.k, row0, valid);

  const int sub = threadIdx.x % LPR;  // this lane's VPL values of a row
  float qv[REPC][VPL];
#pragma unroll
  for (int r = 0; r < REPC; ++r)
#pragma unroll
    for (int i = 0; i < VPL; ++i)
      qv[r][i] = r < rep ? bf16_round(a.q[(static_cast<size_t>(b) * a.H + g * rep + r) * DH +
                                          sub * VPL + i] * a.sm_scale)
                         : 0.f;

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait(tiles - 1 - t);
    const int end = min(valid, (t + 1) * kTileRows);
    for (int j0 = t * kTileRows; j0 < end; j0 += RPS) {  // uniform across the block
      const int j = j0 + threadIdx.x / LPR;
      float kx[VPL];
      load_vals<VPL, INT8>(smem + j * kRowBytes + sub * VPL * (INT8 ? 1 : 2), kx);
      const float kscale = (INT8 && j < valid) ? a.ks[row0 + j] : 1.f;
#pragma unroll
      for (int r = 0; r < REPC; ++r) {
        if (r >= rep) break;
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < VPL; ++i) d = fmaf(qv[r][i], kx[i], d);
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        if (sub == 0 && j < valid) sc[r * a.chunk + j] = INT8 ? d * kscale : d;
      }
    }
  }
  __syncthreads();

  // the scores out, and the chunk's max of each query row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t bh = static_cast<size_t>(b) * a.H + g * rep;
  const int W = a.n_chunks * a.chunk;
#pragma unroll
  for (int r = 0; r < REPC; ++r) {
    if (r >= rep) break;
    float mx = kNegInf;
    for (int j = threadIdx.x; j < valid; j += kThreads) {
      const float s = sc[r * a.chunk + j];
      a.scores[(bh + r) * W + c * a.chunk + j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    if (lane == 0) red[warp][r] = mx;
  }
  __syncthreads();
  if (threadIdx.x < rep) {
    float mx = red[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, red[w][threadIdx.x]);
    a.cmax[(bh + threadIdx.x) * a.n_chunks + c] = mx;
  }
}

// Pass 2: one chunk's partials at its reference block's prefix max.
template <int DH, bool INT8, int REPC>
__global__ void __launch_bounds__(kThreads)
decode_values(Args a) {
  constexpr int DPL = DH / 32;           // output columns a lane
  constexpr int kRowBytes = DH * (INT8 ? 1 : 2);
  extern __shared__ __align__(16) unsigned char smem[];
  // [rows][DH] V; after the sums, [kWarps][rep][DH] f32 partials over it
  float* pv = reinterpret_cast<float*>(smem + max(kMaxChunk * kRowBytes,
                                                  kWarps * kMaxRep * DH * 4));  // [rep][chunk]
  __shared__ float m_s[kMaxRep], red[kWarps][kMaxRep];
  const int c = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int rep = a.H / a.Hkv;
  size_t row0 = 0;
  const int valid = chunk_rows(a, c, g, b, &row0);
  if (valid == 0) return;
  const int tiles = stream_rows<DH, INT8>(smem, a.v, row0, valid);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t bh = static_cast<size_t>(b) * a.H + g * rep;

  // the prefix max of the chunk maxima over the reference blocks 0..s
  // (chunks past pos[b] never wrote theirs)
  const int per_block = a.block_s / a.chunk;
  const int upto = min((c / per_block + 1) * per_block, a.pos[b] / a.chunk + 1);
  for (int r = warp; r < rep; r += kWarps) {
    float mx = kNegInf;
    for (int i = lane; i < upto; i += 32) mx = fmaxf(mx, a.cmax[(bh + r) * a.n_chunks + i]);
    mx = warp_max(mx);
    if (lane == 0) m_s[r] = mx;
  }
  __syncthreads();

  // p, its sum, and bf16(p * vs) where the reference rounds it
  const int W = a.n_chunks * a.chunk;
#pragma unroll
  for (int r = 0; r < REPC; ++r) {
    if (r >= rep) break;
    float ps = 0.f;
    for (int j = threadIdx.x; j < valid; j += kThreads) {
      float p = expf(a.scores[(bh + r) * W + c * a.chunk + j] - m_s[r]);
      ps += p;
      if (INT8) p *= a.vs[row0 + j];
      pv[r * a.chunk + j] = bf16_round(p);
    }
    ps = warp_sum(ps);
    if (lane == 0) red[warp][r] = ps;
  }

  // acc[r] = sum_j pv[r][j] * V_j over this warp's rows
  float acc[REPC][DPL];
#pragma unroll
  for (int r = 0; r < REPC; ++r)
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait(tiles - 1 - t);  // its barrier also publishes pv
    const int end = min(valid, (t + 1) * kTileRows);
#pragma unroll 4
    for (int j = t * kTileRows + warp; j < end; j += kWarps) {
      float vx[DPL];
      load_vals<DPL, INT8>(smem + j * kRowBytes + lane * DPL * (INT8 ? 1 : 2), vx);
#pragma unroll
      for (int r = 0; r < REPC; ++r) {
        if (r >= rep) break;
        const float p = pv[r * a.chunk + j];
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(p, vx[i], acc[r][i]);
      }
    }
  }
  __syncthreads();  // every warp is done with the V rows: reuse them

  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int r = 0; r < REPC; ++r) {
    if (r >= rep) break;
#pragma unroll
    for (int i = 0; i < DPL; ++i) part[(warp * rep + r) * DH + lane * DPL + i] = acc[r][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rep * DH; idx += kThreads) {
    const int r = idx / DH, d = idx - r * DH;
    float s = part[r * DH + d];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += part[(w * rep + r) * DH + d];
    a.acc[((bh + r) * a.n_chunks + c) * DH + d] = s;
  }
  if (threadIdx.x < rep) {
    float l = red[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) l += red[w][threadIdx.x];
    a.lsum[(bh + threadIdx.x) * a.n_chunks + c] = l;
    a.msum[(bh + threadIdx.x) * a.n_chunks + c] = m_s[threadIdx.x];
  }
}

// The chunks' partials of query head h, rescaled to the last valid chunk's
// prefix max (the largest) and summed in chunk order.  DH threads: thread d
// sums column d.
__global__ void __launch_bounds__(128)
decode_combine(Args a, int DH) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const size_t bh = static_cast<size_t>(b) * a.H + h;
  const int n = min(a.pos[b] / a.chunk + 1, a.n_chunks);  // valid chunks
  const float m = a.msum[bh * a.n_chunks + n - 1];
  float num = 0.f, den = 0.f;
  for (int c = 0; c < n; ++c) {
    const float w = expf(a.msum[bh * a.n_chunks + c] - m);
    num = fmaf(a.acc[(bh * a.n_chunks + c) * DH + d], w, num);
    den = fmaf(a.lsum[bh * a.n_chunks + c], w, den);
  }
  a.out[bh * DH + d] = num / den;
}

template <int DH, bool INT8, int REPC>
cudaError_t launch(const Args& a, int B, cudaStream_t st) {
  constexpr int kRowBytes = DH * (INT8 ? 1 : 2);
  const int rep = a.H / a.Hkv;
  const dim3 grid(a.n_chunks, a.Hkv, B);
  const size_t sc = sizeof(float) * static_cast<size_t>(rep) * a.chunk;
  decode_scores<DH, INT8, REPC><<<grid, kThreads, kMaxChunk * kRowBytes + sc, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t vbytes = kMaxChunk * kRowBytes > kWarps * kMaxRep * DH * 4
                            ? kMaxChunk * kRowBytes : kWarps * kMaxRep * DH * 4;
  decode_values<DH, INT8, REPC><<<grid, kThreads, vbytes + sc, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine<<<dim3(a.H, B), DH, 0, st>>>(a, DH);
  return cudaGetLastError();
}

template <int DH, bool INT8>
cudaError_t launch_rep(const Args& a, int B, cudaStream_t st) {
  const int rep = a.H / a.Hkv;
  if (rep <= 1) return launch<DH, INT8, 1>(a, B, st);
  if (rep <= 2) return launch<DH, INT8, 2>(a, B, st);
  if (rep <= 4) return launch<DH, INT8, 4>(a, B, st);
  return launch<DH, INT8, 8>(a, B, st);
}

}  // namespace

// tables == nullptr: slab cache with S rows per (b, g) plane and blocks of
// block_s rows; otherwise the pool, blocks of block_s (= BS) rows.  The
// window is nblk * block_s rows, in chunks of `chunk` rows (a divisor of
// block_s, at most 128).  ws: B * H * (W + n_chunks * (DH + 3)) floats.
extern "C" int lutvq_flash_decode(const void* q, const void* k, const void* v,
                                  const void* ks, const void* vs, const void* pos,
                                  const void* tables, void* out, void* ws, int B, int H,
                                  int Hkv, int Dh, int S, int nblk, int block_s, int max_blocks,
                                  int chunk, int kv_int8, float sm_scale, void* stream_ptr) {
  if (Hkv < 1 || H % Hkv || H / Hkv > kMaxRep || block_s < 1 || block_s > kMaxBlock ||
      chunk < 1 || chunk > kMaxChunk || block_s % chunk || (Dh != 64 && Dh != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || nblk == 0) return 0;
  Args a;
  a.q = static_cast<const float*>(q);
  a.k = k;
  a.v = v;
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.pos = static_cast<const int*>(pos);
  a.tables = static_cast<const int*>(tables);
  a.out = static_cast<float*>(out);
  a.H = H;
  a.Hkv = Hkv;
  a.S = S;
  a.block_s = block_s;
  a.max_blocks = max_blocks;
  a.chunk = chunk;
  a.n_chunks = nblk * (block_s / chunk);
  a.sm_scale = sm_scale;
  const size_t bh = static_cast<size_t>(B) * H;
  a.scores = static_cast<float*>(ws);
  a.cmax = a.scores + bh * a.n_chunks * chunk;
  a.acc = a.cmax + bh * a.n_chunks;
  a.lsum = a.acc + bh * a.n_chunks * Dh;
  a.msum = a.lsum + bh * a.n_chunks;
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  if (Dh == 128)
    err = kv_int8 ? launch_rep<128, true>(a, B, st) : launch_rep<128, false>(a, B, st);
  else
    err = kv_int8 ? launch_rep<64, true>(a, B, st) : launch_rep<64, false>(a, B, st);
  return static_cast<int>(err);
}
