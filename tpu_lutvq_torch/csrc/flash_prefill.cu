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
// over a window of up to a few thousand rows) the tensor-core work,
// 4 * T * window * Dh flops per head; K/V (int8) are read once per query
// tile and per query head of a kv group (the repeats hit L2).  Design:
//   - grid (query tiles of 64, H, B), 4 warps, 16 query rows each; the
//     warp keeps its bf16 Q fragments in registers for the whole run;
//   - KV sub-tiles of 64 rows are converted int8 -> bf16 into shared memory
//     (K row-major, V transposed, so both B fragments are 32-bit loads) and
//     multiplied with mma.sync m16n8k16 (bf16 in, f32 accumulate);
//   - the block max is needed before any p of the block is rounded, so each
//     block_s block runs two passes over its sub-tiles: the first finds the
//     row max, the second recomputes the scores and accumulates p*V.  The
//     doubled Q.K^T is cheap next to holding block_s scores per row;
//   - causal skip (flash_prefill.py:79) at block and sub-tile granularity:
//     KV rows past the tile's last query position are never loaded.
// Left for later: cp.async/TMA double buffering, wgmma, one block per kv
// head for all rep query heads (K/V read once per group).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;  // query rows per block (16 per warp)
constexpr int kBK = 64;  // KV rows per sub-tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  // round to nearest even (inputs are finite)
  uint32_t u = __float_as_uint(x);
  u += 0x7fffu + ((u >> 16) & 1u);
  return u >> 16;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}

__device__ __forceinline__ uint32_t ld_pair(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// int8 values are exact in bf16: the f32 bit pattern's upper half.
__device__ __forceinline__ uint32_t i8_bf16(int8_t x) {
  return __float_as_uint(static_cast<float>(x)) >> 16;
}

template <int DH>
struct Tile {
  uint16_t k[kBK][DH + 8];   // K rows, bf16 (padded rows: conflict-free fragments)
  uint16_t vt[DH][kBK + 8];  // V transposed, bf16
  float ks[kBK], vs[kBK];
};

// Sub-tile rows [row0, row0 + 64) of one (b, g) plane into shared memory.
template <int DH, bool INT8>
__device__ __forceinline__ void load_tile(Tile<DH>& t, const void* k, const void* v,
                                          const float* ks, const float* vs, size_t row0,
                                          bool with_v) {
  const int tid = threadIdx.x;
  if constexpr (INT8) {
    constexpr int CH = DH / 16;  // 16-byte chunks per row
    for (int i = tid; i < kBK * CH; i += kThreads) {
      const int r = i / CH, c = i - r * CH;
      const size_t off = (row0 + r) * DH + c * 16;
      const uint4 wk = *reinterpret_cast<const uint4*>(static_cast<const int8_t*>(k) + off);
      const int8_t* bk = reinterpret_cast<const int8_t*>(&wk);
      uint32_t pk[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) pk[e] = i8_bf16(bk[2 * e]) | (i8_bf16(bk[2 * e + 1]) << 16);
      uint4* dst = reinterpret_cast<uint4*>(&t.k[r][c * 16]);
      dst[0] = make_uint4(pk[0], pk[1], pk[2], pk[3]);
      dst[1] = make_uint4(pk[4], pk[5], pk[6], pk[7]);
      if (with_v) {
        const uint4 wv = *reinterpret_cast<const uint4*>(static_cast<const int8_t*>(v) + off);
        const int8_t* bv = reinterpret_cast<const int8_t*>(&wv);
#pragma unroll
        for (int e = 0; e < 16; ++e) t.vt[c * 16 + e][r] = static_cast<uint16_t>(i8_bf16(bv[e]));
      }
    }
  } else {
    constexpr int CH = DH / 8;  // 16-byte chunks (8 bf16) per row
    for (int i = tid; i < kBK * CH; i += kThreads) {
      const int r = i / CH, c = i - r * CH;
      const size_t off = (row0 + r) * DH + c * 8;
      *reinterpret_cast<uint4*>(&t.k[r][c * 8]) =
          *reinterpret_cast<const uint4*>(static_cast<const uint16_t*>(k) + off);
      if (with_v) {
        const uint4 wv = *reinterpret_cast<const uint4*>(static_cast<const uint16_t*>(v) + off);
        const uint16_t* hv = reinterpret_cast<const uint16_t*>(&wv);
#pragma unroll
        for (int e = 0; e < 8; ++e) t.vt[c * 8 + e][r] = hv[e];
      }
    }
  }
  if (INT8) {
    if (tid < kBK) t.ks[tid] = ks[row0 + tid];
    else if (with_v && tid < 2 * kBK) t.vs[tid - kBK] = vs[row0 + tid - kBK];
  }
}

// Scaled, masked scores of this warp's 16 query rows against the sub-tile's
// 64 KV rows starting at position c0: sc[n-tile][e], C-fragment layout.
template <int DH, bool INT8>
__device__ __forceinline__ void scores(const Tile<DH>& t, const uint32_t (&qa)[DH / 16][4],
                                       float (&sc)[kBK / 8][4], int c0, int qpos_lo,
                                       int qpos_hi, float sm_scale) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kBK / 8; ++nt) {
    sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t bb[2];
      bb[0] = ld_pair(&t.k[nt * 8 + gid][kk * 16 + tig * 2]);
      bb[1] = ld_pair(&t.k[nt * 8 + gid][kk * 16 + tig * 2 + 8]);
      mma_bf16(sc[nt], qa[kk], bb);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = nt * 8 + tig * 2 + (e & 1);
      float s = sc[nt][e] * sm_scale;
      if (INT8) s *= t.ks[col];
      sc[nt][e] = c0 + col <= (e < 2 ? qpos_lo : qpos_hi) ? s : kNegInf;
    }
  }
}

// q:      (B, T, H, DH) f32, post-RoPE
// k, v:   (B, Hkv, S, DH) int8 or bf16;  ks, vs: (B, Hkv, S) f32
// t_off:  (B,) int32;  out: (B, T, H, DH) f32
template <int DH, bool INT8>
__global__ void __launch_bounds__(kThreads)
flash_prefill(const float* __restrict__ q, const void* __restrict__ k,
              const void* __restrict__ v, const float* __restrict__ ks,
              const float* __restrict__ vs, const int* __restrict__ t_off,
              float* __restrict__ out, int T, int H, int Hkv, int S, int nblk, int block_s,
              float sm_scale) {
  constexpr int KS = DH / 16;  // k-steps of Q.K^T
  constexpr int NT = kBK / 8;  // score n-tiles per sub-tile
  constexpr int DT = DH / 8;   // output n-tiles
  __shared__ __align__(16) Tile<DH> tile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * kBQ;
  const int pos_b = t_off[b];
  const int t_lo = q0 + warp * 16 + gid, t_hi = t_lo + 8;  // this thread's query rows
  const int qpos_lo = pos_b + t_lo, qpos_hi = pos_b + t_hi;

  uint32_t qa[KS][4];  // bf16(q), A fragments, for the whole run
  {
    const float* ql = q + ((static_cast<size_t>(b) * T + t_lo) * H + h) * DH;
    const float* qh = q + ((static_cast<size_t>(b) * T + t_hi) * H + h) * DH;
    const float2 zero = make_float2(0.f, 0.f);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int c = kk * 16 + tig * 2;
      const float2 l0 = t_lo < T ? *reinterpret_cast<const float2*>(ql + c) : zero;
      const float2 l1 = t_lo < T ? *reinterpret_cast<const float2*>(ql + c + 8) : zero;
      const float2 h0 = t_hi < T ? *reinterpret_cast<const float2*>(qh + c) : zero;
      const float2 h1 = t_hi < T ? *reinterpret_cast<const float2*>(qh + c + 8) : zero;
      qa[kk][0] = pack_bf16(l0.x, l0.y);
      qa[kk][1] = pack_bf16(h0.x, h0.y);
      qa[kk][2] = pack_bf16(l1.x, l1.y);
      qa[kk][3] = pack_bf16(h1.x, h1.y);
    }
  }

  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this thread's columns
  const int qlast = pos_b + q0 + kBQ - 1;  // last query position of the tile
  const size_t plane = (static_cast<size_t>(b) * Hkv + g) * S;

  for (int sb = 0; sb < nblk; ++sb) {
    const int sstart = sb * block_s;
    if (sstart > qlast) break;  // this and later blocks are above every row's diagonal
    const int nsub = min(block_s / kBK, (qlast - sstart) / kBK + 1);

    // pass 1: the block's row max
    float mx[2] = {kNegInf, kNegInf};
    for (int sub = 0; sub < nsub; ++sub) {
      const int c0 = sstart + sub * kBK;
      __syncthreads();
      load_tile<DH, INT8>(tile, k, v, ks, vs, plane + c0, false);
      __syncthreads();
      float sc[NT][4];
      scores<DH, INT8>(tile, qa, sc, c0, qpos_lo, qpos_hi, sm_scale);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mx[0] = fmaxf(mx[0], fmaxf(sc[nt][0], sc[nt][1]));
        mx[1] = fmaxf(mx[1], fmaxf(sc[nt][2], sc[nt][3]));
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        o[dt][2 * i] *= alpha;
        o[dt][2 * i + 1] *= alpha;
      }
    }

    // pass 2: p, l and p*V
    for (int sub = 0; sub < nsub; ++sub) {
      const int c0 = sstart + sub * kBK;
      __syncthreads();
      load_tile<DH, INT8>(tile, k, v, ks, vs, plane + c0, true);
      __syncthreads();
      float sc[NT][4];
      scores<DH, INT8>(tile, qa, sc, c0, qpos_lo, qpos_hi, sm_scale);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = expf(sc[nt][e] - m[e >> 1]);
          l[e >> 1] += p;
          if (INT8) p *= tile.vs[nt * 8 + tig * 2 + (e & 1)];
          sc[nt][e] = p;
        }
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
            pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
            pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
            pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]),
        };
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          uint32_t bb[2];
          bb[0] = ld_pair(&tile.vt[dt * 8 + gid][kk * 16 + tig * 2]);
          bb[1] = ld_pair(&tile.vt[dt * 8 + gid][kk * 16 + tig * 2 + 8]);
          mma_bf16(o[dt], pa, bb);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = i == 0 ? t_lo : t_hi;
    if (t >= T) continue;
    float* dst = out + ((static_cast<size_t>(b) * T + t) * H + h) * DH;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<float2*>(dst + dt * 8 + tig * 2) =
          make_float2(o[dt][2 * i] / l[i], o[dt][2 * i + 1] / l[i]);
  }
}

template <int DH>
cudaError_t launch(bool int8, const void* q, const void* k, const void* v, const void* ks,
                   const void* vs, const void* t_off, void* out, int B, int T, int H,
                   int Hkv, int S, int nblk, int block_s, float sm_scale, cudaStream_t st) {
  const dim3 grid((T + kBQ - 1) / kBQ, H, B);
  const float* qf = static_cast<const float*>(q);
  const float* ksf = static_cast<const float*>(ks);
  const float* vsf = static_cast<const float*>(vs);
  const int* to = static_cast<const int*>(t_off);
  float* o = static_cast<float*>(out);
  if (int8)
    flash_prefill<DH, true><<<grid, kThreads, 0, st>>>(qf, k, v, ksf, vsf, to, o, T, H, Hkv,
                                                       S, nblk, block_s, sm_scale);
  else
    flash_prefill<DH, false><<<grid, kThreads, 0, st>>>(qf, k, v, ksf, vsf, to, o, T, H, Hkv,
                                                        S, nblk, block_s, sm_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int lutvq_flash_prefill(const void* q, const void* k, const void* v,
                                   const void* ks, const void* vs, const void* t_off,
                                   void* out, int B, int T, int H, int Hkv, int Dh, int S,
                                   int nblk, int block_s, int kv_int8, float sm_scale,
                                   void* stream_ptr) {
  if (Hkv < 1 || H % Hkv || block_s < kBK || block_s % kBK)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || T == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  if (Dh == 128)
    return static_cast<int>(launch<128>(kv_int8, q, k, v, ks, vs, t_off, out, B, T, H, Hkv,
                                         S, nblk, block_s, sm_scale, st));
  if (Dh == 64)
    return static_cast<int>(launch<64>(kv_int8, q, k, v, ks, vs, t_off, out, B, T, H, Hkv,
                                        S, nblk, block_s, sm_scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
