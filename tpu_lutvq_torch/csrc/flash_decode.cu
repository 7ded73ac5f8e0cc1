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
// The TPU's "all-heads" cross-term matmul (flash_decode.py:16-32) is a TPU
// layout trick.  Here one block per (kv head g, sequence b) holds its rep
// query rows (rep <= 8) in registers and computes no junk terms.
//
// What bounds it on the H100: the K/V bytes, window * H_kv * Dh * 2 per
// sequence (int8), read once.  128 threads; a block walks its sequence's
// blocks in order: (A) each warp takes rows j = warp, warp+4, ..., a lane
// holds Dh/32 values of a row, so a warp reads one contiguous row, and the
// rep dot products are reduced across the warp; (B) one warp per query row
// takes the block max, exp, l, and writes bf16(p*vs) over the scores in
// shared memory; (C) each warp adds p*V for its rows into per-warp partial
// accumulators, summed once at the end.  Rows past pos[b] are not read:
// their scores are -1e30 and p is exactly 0.  Blocks wholly past pos[b] are
// skipped (flash_decode.py:103).
//
// Left for the PR that makes it fast: at B=1 only H_kv blocks run, far from
// filling 132 SMs.  Splitting S across blocks (flash-decoding) would fill
// the card, but it moves the rounding points (each split would round p
// against its own max), so it needs a re-derived tolerance; also cp.async
// double buffering of the rows, and tensor cores for rep >= 4.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRep = 8;
constexpr int kMaxBlock = 512;
constexpr int kUnroll = 4;  // rows in flight per warp in phases A and C
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float bf16_round(float x) {
  // round to nearest even on the upper 16 bits (inputs are finite)
  uint32_t u = __float_as_uint(x);
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}

// Dh/32 consecutive values of one row, exactly converted to f32.
template <int DPL, bool INT8>
__device__ __forceinline__ void load_row(const void* base, size_t off, float (&x)[DPL]) {
  if constexpr (INT8) {
    const int8_t* p = static_cast<const int8_t*>(base) + off;
    if constexpr (DPL == 4) {
      const char4 c = *reinterpret_cast<const char4*>(p);
      x[0] = c.x; x[1] = c.y; x[2] = c.z; x[3] = c.w;
    } else {
      const char2 c = *reinterpret_cast<const char2*>(p);
      x[0] = c.x; x[1] = c.y;
    }
  } else {
    const uint16_t* p = static_cast<const uint16_t*>(base) + off;
    if constexpr (DPL == 4) {
      const uint2 w = *reinterpret_cast<const uint2*>(p);
      x[0] = __uint_as_float(w.x << 16); x[1] = __uint_as_float(w.x & 0xffff0000u);
      x[2] = __uint_as_float(w.y << 16); x[3] = __uint_as_float(w.y & 0xffff0000u);
    } else {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
      x[0] = __uint_as_float(w << 16); x[1] = __uint_as_float(w & 0xffff0000u);
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

// q:      (B, H, DH) f32, post-RoPE
// k, v:   slab (B, Hkv, S, DH) or pool (N, Hkv, block_s, DH), int8 or bf16
// ks, vs: slab (B, Hkv, S) or pool (N, Hkv, block_s) f32
// pos:    (B,) int32;  tables: (B, max_blocks) int32 (PAGED only)
// out:    (B, H, DH) f32
template <int DH, bool INT8, bool PAGED>
__global__ void __launch_bounds__(kThreads)
flash_decode(const float* __restrict__ q, const void* __restrict__ k,
             const void* __restrict__ v, const float* __restrict__ ks,
             const float* __restrict__ vs, const int* __restrict__ pos,
             const int* __restrict__ tables, float* __restrict__ out, int H, int Hkv,
             int S, int nblk, int block_s, int max_blocks, float sm_scale) {
  constexpr int DPL = DH / 32;
  extern __shared__ float smem[];
  float* sc = smem;                        // [rep][block_s]: scores, then bf16(p*vs)
  __shared__ float m_s[kMaxRep], l_s[kMaxRep], alpha_s[kMaxRep];
  const int g = blockIdx.x, b = blockIdx.y;
  const int rep = H / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* red = smem + rep * block_s;       // [kWarps][rep][DH], after the loop

  float qv[kMaxRep][DPL], acc[kMaxRep][DPL];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r)
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      acc[r][i] = 0.f;
      qv[r][i] = r < rep ? bf16_round(q[(static_cast<size_t>(b) * H + g * rep + r) * DH +
                                        lane * DPL + i] * sm_scale)
                         : 0.f;
    }
  if (threadIdx.x < kMaxRep) {
    m_s[threadIdx.x] = kNegInf;
    l_s[threadIdx.x] = 0.f;
  }
  const int pos_b = pos[b];
  __syncthreads();

  for (int sb = 0; sb < nblk; ++sb) {
    const int start = sb * block_s;
    if (start > pos_b) break;  // this and every later block is past pos[b]
    size_t row0;               // index of the block's first row, in rows
    if constexpr (PAGED) {
      row0 = (static_cast<size_t>(tables[b * max_blocks + sb]) * Hkv + g) * block_s;
    } else {
      row0 = (static_cast<size_t>(b) * Hkv + g) * S + start;
    }
    const int valid = min(block_s, pos_b - start + 1);  // rows j < valid are unmasked

    // (A) scores
    for (int j0 = warp; j0 < block_s; j0 += kWarps * kUnroll) {
      float kx[kUnroll][DPL];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * kWarps;
        if (j < valid) load_row<DPL, INT8>(k, (row0 + j) * DH + lane * DPL, kx[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * kWarps;
        if (j >= block_s) break;
        if (j >= valid) {
          if (lane < rep) sc[lane * block_s + j] = kNegInf;
          continue;
        }
        const float kscale = INT8 ? ks[row0 + j] : 1.f;
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r) {
          if (r >= rep) break;
          float d = 0.f;
#pragma unroll
          for (int i = 0; i < DPL; ++i) d = fmaf(qv[r][i], kx[u][i], d);
          d = warp_sum(d);
          if (lane == 0) sc[r * block_s + j] = INT8 ? d * kscale : d;
        }
      }
    }
    __syncthreads();

    // (B) block max, exp, l; p*vs rounded to bf16 in place of the scores
    for (int r = warp; r < rep; r += kWarps) {
      float* row = sc + r * block_s;
      float mx = kNegInf;
      for (int j = lane; j < block_s; j += 32) mx = fmaxf(mx, row[j]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float ps = 0.f;
      for (int j = lane; j < block_s; j += 32) {
        float p = expf(row[j] - m_new);
        ps += p;
        if (INT8) p *= vs[row0 + j];
        row[j] = bf16_round(p);
      }
      ps = warp_sum(ps);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + ps;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // (C) acc = acc*alpha + p*V over this warp's rows
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r >= rep) break;
      const float a = alpha_s[r];
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= a;
    }
    for (int j0 = warp; j0 < valid; j0 += kWarps * kUnroll) {
      float vx[kUnroll][DPL];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * kWarps;
        if (j < valid) load_row<DPL, INT8>(v, (row0 + j) * DH + lane * DPL, vx[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * kWarps;
        if (j >= valid) break;
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r) {
          if (r >= rep) break;
          const float p = sc[r * block_s + j];
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(p, vx[u][i], acc[r][i]);
        }
      }
    }
    __syncthreads();
  }

  // sum the per-warp partial accumulators, divide by l
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    if (r >= rep) break;
#pragma unroll
    for (int i = 0; i < DPL; ++i) red[(warp * rep + r) * DH + lane * DPL + i] = acc[r][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rep * DH; idx += kThreads) {
    const int r = idx / DH, d = idx - r * DH;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[(w * rep + r) * DH + d];
    out[(static_cast<size_t>(b) * H + g * rep + r) * DH + d] = sum / l_s[r];
  }
}

template <int DH, bool INT8, bool PAGED>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ks,
                   const void* vs, const void* pos, const void* tables, void* out, int B,
                   int H, int Hkv, int S, int nblk, int block_s, int max_blocks,
                   float sm_scale, cudaStream_t stream) {
  const int rep = H / Hkv;
  const size_t smem = sizeof(float) * (static_cast<size_t>(rep) * block_s +
                                       static_cast<size_t>(kWarps) * rep * DH);
  flash_decode<DH, INT8, PAGED><<<dim3(Hkv, B), kThreads, smem, stream>>>(
      static_cast<const float*>(q), k, v, static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(pos),
      static_cast<const int*>(tables), static_cast<float*>(out), H, Hkv, S, nblk, block_s,
      max_blocks, sm_scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t dispatch(bool int8, bool paged, const void* q, const void* k, const void* v,
                     const void* ks, const void* vs, const void* pos, const void* tables,
                     void* out, int B, int H, int Hkv, int S, int nblk, int block_s,
                     int max_blocks, float sm_scale, cudaStream_t st) {
  if (int8 && paged)
    return launch<DH, true, true>(q, k, v, ks, vs, pos, tables, out, B, H, Hkv, S, nblk,
                                  block_s, max_blocks, sm_scale, st);
  if (int8)
    return launch<DH, true, false>(q, k, v, ks, vs, pos, tables, out, B, H, Hkv, S, nblk,
                                   block_s, max_blocks, sm_scale, st);
  if (paged)
    return launch<DH, false, true>(q, k, v, ks, vs, pos, tables, out, B, H, Hkv, S, nblk,
                                   block_s, max_blocks, sm_scale, st);
  return launch<DH, false, false>(q, k, v, ks, vs, pos, tables, out, B, H, Hkv, S, nblk,
                                  block_s, max_blocks, sm_scale, st);
}

}  // namespace

// tables == nullptr: slab cache with S rows per (b, g) plane and blocks of
// block_s rows; otherwise the pool, blocks of block_s (= BS) rows.
extern "C" int lutvq_flash_decode(const void* q, const void* k, const void* v,
                                  const void* ks, const void* vs, const void* pos,
                                  const void* tables, void* out, int B, int H, int Hkv,
                                  int Dh, int S, int nblk, int block_s, int max_blocks,
                                  int kv_int8, float sm_scale, void* stream_ptr) {
  if (Hkv < 1 || H % Hkv || H / Hkv > kMaxRep || block_s < 1 || block_s > kMaxBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const bool paged = tables != nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  if (Dh == 128)
    return static_cast<int>(dispatch<128>(kv_int8, paged, q, k, v, ks, vs, pos, tables, out,
                                          B, H, Hkv, S, nblk, block_s, max_blocks,
                                          sm_scale, st));
  if (Dh == 64)
    return static_cast<int>(dispatch<64>(kv_int8, paged, q, k, v, ks, vs, pos, tables, out,
                                         B, H, Hkv, S, nblk, block_s, max_blocks,
                                         sm_scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
