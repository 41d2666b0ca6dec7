// The port's first attention body, kept for the fp32 entries that still
// run it: fp32 flash prefill (#1's, flash_attention.cu), fp32 paged context
// (#3's) and fp32 quantized paged context (#6's, on int8 / fp8 pools), all
// parity paths. One tiled online-softmax body whose only differences are
// where a key row comes from (a contiguous (b, skv, hkv, d) cache, or a
// page pool read through a per-row block table), the mask, and the element
// type of K/V. bf16 flash prefill (flash_attention.cu, fa::flash_fwd), bf16
// paged context on bf16 and one-byte pools (paged_attention.cu,
// pc::context_fwd) and every decode and verify kernel, paged or
// contiguous, quantized or not, in bf16 and fp32 (decode.cuh,
// dk::decode_fwd) have bodies of their own.
//
// Layout of one thread block: 256 threads as a 16 x 16 grid (ty, tx). The
// block owns BQ = 16 * ROWS query ROWS, where a row is one (position, query
// head) pair of ONE kv head's GQA group: flat row fr maps to position
// fr / g and query head kvh * g + fr % g. So every K/V tile the block loads
// serves all g query heads of its kv head, instead of being fetched g times
// as the TPU grids (batch, q_head, kv_block) did.
//
// Per tile of BK = 32 keys: thread (ty, tx) computes scores for rows
// ty + 16 i and keys tx + 16 j in registers, reduces row max / row sum over
// its 16-lane half warp with shuffles, keeps (m, l) per row in registers and
// the output accumulator for columns tx + 16 c in registers. Shared memory
// holds the Q tile, one K and V tile, and the probability tile, all in fp32
// (inputs are widened on load; accumulation is fp32). Row strides of D + 1
// floats keep the column reads of Q and K conflict-free. Tiles are loaded
// with 16-byte vector loads and not pipelined: PERF.md says where each
// kernel stands against its bound.
//
// Masking follows repro.kernels.ref exactly: a masked score is NEG_INF, a
// probability is 0 where the score is <= NEG_INF / 2 (no exp of a huge
// negative number), and a row that saw no live key writes exact zeros.
//
// A bf16 page pool under fp32 q (KV = __nv_bfloat16: an fp32 model serving
// a bf16 pool) is read 8 elements to a 16-byte load and widened exactly.
//
// Quantized page pools (KV = int8_t or __nv_fp8_e4m3, with per-token-per-
// head fp32 scale pools (n_blocks, bs, hkv) in AttnParams::k_scale/v_scale):
// a thread's 16-byte load holds 16 one-byte elements of a K or V row,
// widened exactly to fp32 on their way into shared memory. The tile's K and
// V scales are staged in shared memory, one load per key row and kv head,
// and folded into the arithmetic instead of dequantizing the tile: s_j =
// (q . kq_j) * k_scale_j * scale before the running max, and the
// probability that weighs row j of V is p_j * v_scale_j (the row sum l
// keeps the unscaled p_j). A null page's scales are 0, so a free slot's row
// reads 0 * payload and stays finite.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;
constexpr int BK = 32;

// 16-byte loads: 4 floats per thread
__device__ __forceinline__ void load16(const float* src, float (&dst)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}
// 16 one-byte elements of a quantized K/V row, widened to float (exact)
template <typename KV>
__device__ __forceinline__ void unpack16(const uint4& v, float (&dst)[16]);
template <>
__device__ __forceinline__ void unpack16<int8_t>(const uint4& v,
                                                 float (&dst)[16]) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int i = 0; i < 16; ++i) dst[i] = static_cast<float>(b[i]);
}
template <>
__device__ __forceinline__ void unpack16<__nv_fp8_e4m3>(const uint4& v,
                                                        float (&dst)[16]) {
  const __nv_fp8x2_storage_t* h =
      reinterpret_cast<const __nv_fp8x2_storage_t*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 f =
        __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(h[i], __NV_E4M3)));
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load16(const int8_t* src, float (&dst)[16]) {
  unpack16<int8_t>(*reinterpret_cast<const uint4*>(src), dst);
}
__device__ __forceinline__ void load16(const __nv_fp8_e4m3* src,
                                       float (&dst)[16]) {
  unpack16<__nv_fp8_e4m3>(*reinterpret_cast<const uint4*>(src), dst);
}
// 8 bf16 elements of a K/V row (a bf16 pool under fp32 q), widened to
// float (exact)
__device__ __forceinline__ void load16(const __nv_bfloat16* src,
                                       float (&dst)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

struct AttnParams {
  const void* q;        // (b, sq, hq, d)
  const void* k;        // flash: (b, skv, hkv, d); paged: (n_blocks, bs, hkv, d)
  const void* v;
  void* o;              // (b, sq, hq, d)
  const int* tables;    // paged: (b, max_blocks) physical page per logical block
  const int* q_start;   // (b,) absolute position of query position 0, or null
  const int* kv_len;    // (b,) keys at positions >= kv_len are masked, or null
  const int* kv_start;  // (b,) keys at positions < kv_start are masked, or null
  int b, sq, skv, hq, hkv;
  int bs, max_blocks;   // paged only
  int causal, window;
  float scale;
  // quantized pools: (n_blocks, bs, hkv) fp32 scales of K and V rows, or
  // null for pools stored in q's dtype
  const float* k_scale;
  const float* v_scale;
};

// The fp32 flash entry's training instances (PT below): AttnParams and the
// rows' log-sum-exp of the scaled scores, lse (b, hq, sq) fp32, m + log l
// (0 on a row that saw no key), which the backward kernel
// (flash_attention_bwd.cu) recomputes P from. The serving instances keep
// PT = AttnParams and the code they had.
struct AttnParamsLse : AttnParams {
  float* lse;
};

// Row of key position kpos in the K/V arrays: (b, skv) rows for a
// contiguous cache, or (page, offset) through row bi's block table.
template <bool PAGED>
__device__ __forceinline__ int64_t key_row(const AttnParams& p, int bi,
                                           int kpos) {
  if (PAGED) {
    const int page = p.tables[bi * (int64_t)p.max_blocks + kpos / p.bs];
    return (int64_t)page * p.bs + kpos % p.bs;
  }
  return bi * (int64_t)p.skv + kpos;
}

template <int ROWS, int D, bool QUANT>
constexpr size_t smem_bytes() {
  return sizeof(float) * (16 * ROWS * (D + 1) + BK * (D + 1) + BK * D +
                          16 * ROWS * (BK + 1) + (QUANT ? 2 * BK : 0));
}

// T: q / o element type (float); KV: K / V element type (T, or a one-byte
// quantized payload read with the scales of AttnParams)
template <typename T, typename KV, int D, int ROWS, bool PAGED,
          class PT = AttnParams>
__global__ void __launch_bounds__(THREADS) attn_fwd(PT p) {
  constexpr bool QUANT = sizeof(KV) == 1;
  constexpr bool LSE = sizeof(PT) != sizeof(AttnParams);
  constexpr int BQ = 16 * ROWS;
  constexpr int DP = D + 1;
  constexpr int PP = BK + 1;
  constexpr int DC = D / 16;
  constexpr int VEC = 16 / sizeof(T);    // q elements per 16-byte load
  constexpr int DV = D / VEC;            // 16-byte loads per q row
  constexpr int KVEC = 16 / sizeof(KV);  // K/V elements per 16-byte load
  constexpr int KDV = D / KVEC;          // 16-byte loads per K/V row
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * DP;
  float* sV = sK + BK * DP;
  float* sP = sV + BK * D;
  float* sKs = sP + BQ * PP;  // QUANT: the tile's K and V scales
  float* sVs = sKs + BK;

  const T* Q = static_cast<const T*>(p.q);
  const KV* K = static_cast<const KV*>(p.k);
  const KV* V = static_cast<const KV*>(p.v);
  T* O = static_cast<T*>(p.o);

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bi = blockIdx.z;
  const int kvh = blockIdx.y;
  const int g = p.hq / p.hkv;
  const int nrows = p.sq * g;
  const int row0 = blockIdx.x * BQ;
  const int qs = p.q_start ? p.q_start[bi] : 0;

  // live key range of this row: [kv_begin, kv_end), before causal / window
  int kv_end = PAGED ? p.max_blocks * p.bs : p.skv;
  if (p.kv_len) kv_end = min(kv_end, p.kv_len[bi]);
  const int kv_begin = p.kv_start ? max(p.kv_start[bi], 0) : 0;
  // tile loop bounds: stop at the causal limit of the block's last row and
  // start at the window edge of its first, instead of masking dead tiles
  const int last = min(row0 + BQ, nrows) - 1;
  int hi = kv_end;
  if (p.causal) hi = min(hi, qs + last / g + 1);
  int lo = kv_begin;
  if (p.window > 0) lo = max(lo, qs + row0 / g - p.window + 1);
  lo = (lo / BK) * BK;

  for (int idx = threadIdx.x; idx < BQ * DV; idx += THREADS) {
    const int r = idx / DV, dd = (idx % DV) * VEC, fr = row0 + r;
    float val[VEC] = {};
    if (fr < nrows) {
      const int64_t c = fr / g, h = kvh * g + fr % g;
      load16(Q + ((bi * (int64_t)p.sq + c) * p.hq + h) * D + dd, val);
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) sQ[r * DP + dd + i] = val[i];
  }

  int qpos[ROWS];
  bool live[ROWS];
  float m[ROWS], l[ROWS], acc[ROWS][DC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int fr = row0 + ty + 16 * i;
    live[i] = fr < nrows;
    qpos[i] = qs + fr / g;
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = lo; k0 < hi; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done with sK/sV/sP
    for (int idx = threadIdx.x; idx < BK * KDV; idx += THREADS) {
      const int j = idx / KDV, dd = (idx % KDV) * KVEC, kpos = k0 + j;
      float kv[KVEC] = {}, vv[KVEC] = {};
      if (kpos < hi) {
        const int64_t off = (key_row<PAGED>(p, bi, kpos) * p.hkv + kvh) * D + dd;
        load16(K + off, kv);
        load16(V + off, vv);
      }
#pragma unroll
      for (int i = 0; i < KVEC; ++i) {
        sK[j * DP + dd + i] = kv[i];
        sV[j * D + dd + i] = vv[i];
      }
    }
    if constexpr (QUANT) {
      for (int j = threadIdx.x; j < BK; j += THREADS) {
        const int kpos = k0 + j;
        float ks = 0.f, vs = 0.f;
        if (kpos < hi) {
          const int64_t r = key_row<PAGED>(p, bi, kpos) * p.hkv + kvh;
          ks = p.k_scale[r];
          vs = p.v_scale[r];
        }
        sKs[j] = ks;
        sVs[j] = vs;
      }
    }
    __syncthreads();

    float s[ROWS][2];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
    for (int dd = 0; dd < D; ++dd) {
      const float k_a = sK[tx * DP + dd];
      const float k_b = sK[(tx + 16) * DP + dd];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float qv = sQ[(ty + 16 * i) * DP + dd];
        s[i][0] += qv * k_a;
        s[i][1] += qv * k_b;
      }
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = live[i] && kpos >= kv_begin && kpos < kv_end;
        if (p.causal) ok = ok && kpos <= qpos[i];
        if (p.window > 0) ok = ok && kpos > qpos[i] - p.window;
        float sv = s[i][j];
        if constexpr (QUANT) sv *= sKs[tx + 16 * j];
        s[i][j] = ok ? sv * p.scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float pv = s[i][j] <= NEG_INF / 2 ? 0.f : expf(s[i][j] - m_new);
        float pw = pv;  // the weight of V row j: p_j * v_scale_j
        if constexpr (QUANT) pw *= sVs[tx + 16 * j];
        sP[(ty + 16 * i) * PP + tx + 16 * j] = pw;
        rs += pv;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = sV[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float pv = sP[(ty + 16 * i) * PP + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] += pv * vv[c];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    if (!live[i]) continue;
    const int fr = row0 + ty + 16 * i;
    const int64_t c = fr / g, h = kvh * g + fr % g;
    const int64_t r = (bi * (int64_t)p.sq + c) * p.hq + h;
    T* out = O + r * D;
    const bool dead = m[i] <= NEG_INF / 2;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < DC; ++cc)
      store(out + tx + 16 * cc, dead ? 0.f : acc[i][cc] / den);
    if constexpr (LSE) {
      if (tx == 0)
        p.lse[(bi * (int64_t)p.hq + h) * p.sq + c] =
            dead ? 0.f : m[i] + logf(den);
    }
  }
}

template <typename T, typename KV, int D, int ROWS, bool PAGED,
          class PT = AttnParams>
cudaError_t launch(const PT& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<ROWS, D, sizeof(KV) == 1>();
  auto kern = attn_fwd<T, KV, D, ROWS, PAGED, PT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int rows = p.sq * (p.hq / p.hkv);
  dim3 grid((rows + 16 * ROWS - 1) / (16 * ROWS), p.hkv, p.b);
  kern<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// fp32 q / o on K/V of type KV (float, or a one-byte payload read with
// the scales of AttnParams): a few rows (<= 16, e.g. a short context
// chunk's g query heads) take the 16-row block, more the 64-row block.
// Head dims the port serves: 32, 64, 128, and 80 (h2o-danube-1.8b's) and
// 256 (paligemma-3b's) for contiguous K/V (PAGED false), which is fp32
// flash prefill's; the paged kernels take no config of head dim 80 or 256
// and have no instance of them. PT = AttnParamsLse (training, which also
// writes lse) has instances of the backward kernel's head dims, 64, 80,
// 128 and 256.
template <typename KV, bool PAGED, class PT = AttnParams>
cudaError_t dispatch_d(const PT& p, int d, cudaStream_t stream) {
  constexpr bool LSE = sizeof(PT) != sizeof(AttnParams);
  const bool small = p.sq * (p.hq / p.hkv) <= 16;
  switch (d) {
    case 80:
      if constexpr (!PAGED)
        return small ? launch<float, KV, 80, 1, PAGED, PT>(p, stream)
                     : launch<float, KV, 80, 4, PAGED, PT>(p, stream);
      else
        return cudaErrorInvalidValue;
    case 256:
      if constexpr (!PAGED)
        return small ? launch<float, KV, 256, 1, PAGED, PT>(p, stream)
                     : launch<float, KV, 256, 4, PAGED, PT>(p, stream);
      else
        return cudaErrorInvalidValue;
    case 32:
      if constexpr (!LSE)
        return small ? launch<float, KV, 32, 1, PAGED>(p, stream)
                     : launch<float, KV, 32, 4, PAGED>(p, stream);
      else
        return cudaErrorInvalidValue;
    case 64:
      return small ? launch<float, KV, 64, 1, PAGED, PT>(p, stream)
                   : launch<float, KV, 64, 4, PAGED, PT>(p, stream);
    case 128:
      return small ? launch<float, KV, 128, 1, PAGED, PT>(p, stream)
                   : launch<float, KV, 128, 4, PAGED, PT>(p, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace rt
