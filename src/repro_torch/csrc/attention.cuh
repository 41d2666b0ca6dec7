// Shared core of the port's first attention bodies: one tiled online-softmax
// attention body whose only differences are where a key row comes from (a
// contiguous (b, skv, hkv, d) cache, or a page pool read through a per-row
// block table), the mask, and the element type of K/V. The entries that
// still run it:
//  - the quantized paged decode and verify kernels, #5 and #7
//    (paged_{decode,verify}_attention_quant_fwd: int8 / fp8 pools);
//  - fp32 quantized paged context (#6's parity path), fp32 paged context
//    (#3's) and fp32 flash prefill (#1's).
// bf16 flash prefill (flash_attention.cu), bf16 paged context on bf16 and
// on one-byte pools (paged_attention.cu, pc::context_fwd: TMA + wgmma on
// gathered, widened tiles) and the unquantized decode and verify kernels,
// paged and contiguous (decode.cuh) have bodies of their own.
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
// (inputs are widened on load; accumulation is fp32 for every input type).
// Row strides of D + 1 floats keep the column reads of Q and K conflict-free.
//
// Masking follows repro.kernels.ref exactly: a masked score is NEG_INF, a
// probability is 0 where the score is <= NEG_INF / 2 (no exp of a huge
// negative number), and a row that saw no live key writes exact zeros.
//
// Two bodies share that contract: attn_fwd, scalar fp32 FMAs (fp32 inputs,
// and a few rows in any dtype), and attn_fwd_mma below, bf16 tensor cores
// (mma.sync) for many-row bf16 blocks. Both load tiles with 16-byte vector
// loads. attn_fwd can also split a row's keys over n_split blocks (the
// quantized decode, #5) whose partial states combine_splits merges. Neither
// pipelines its loads (cp.async / TMA) nor uses wgmma: PERF.md says where
// each kernel stands against its bound.
//
// Quantized page pools (KV = int8_t or __nv_fp8_e4m3, with per-token-per-
// head fp32 scale pools (n_blocks, bs, hkv) in AttnParams::k_scale/v_scale)
// run through the same two bodies. A thread still owns one 16-byte load,
// which now holds 16 one-byte elements of a K or V row; they are widened
// on their way into shared memory (to fp32 in attn_fwd, to bf16 in
// attn_fwd_mma: every int8 and every e4m3 value is exact in bf16). The
// tile's K and V scales are staged in shared memory, one load per key row
// and kv head, and folded into the arithmetic instead of dequantizing
// the tile: s_j = (q . kq_j) * k_scale_j * scale before the running max,
// and the probability that weighs row j of V is p_j * v_scale_j (the row
// sum l keeps the unscaled p_j). A null page's scales are 0, so a free
// slot's row reads 0 * payload and stays finite.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;
constexpr int BK = 32;

// 16-byte loads: 4 floats or 8 bf16 per thread, widened to float
__device__ __forceinline__ void load16(const float* src, float (&dst)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}
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
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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
  // split-KV (decode): > 1 splits each row's keys over n_split blocks that
  // write unnormalized partials (m, l, acc[d]) to part, (rows, n_split,
  // d + 2) fp32, merged by combine_splits
  int n_split;
  float* part;
  // quantized pools: (n_blocks, bs, hkv) fp32 scales of K and V rows, or
  // null for pools stored in q's dtype
  const float* k_scale;
  const float* v_scale;
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

// T: q / o element type; KV: K / V element type (T, or a one-byte
// quantized payload read with the scales of AttnParams)
template <typename T, typename KV, int D, int ROWS, bool PAGED>
__global__ void __launch_bounds__(THREADS) attn_fwd(AttnParams p) {
  constexpr bool QUANT = sizeof(KV) == 1;
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
  const int n_tiles = (nrows + BQ - 1) / BQ;
  const int split = blockIdx.x / n_tiles;
  const int row0 = (blockIdx.x % n_tiles) * BQ;
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
  if (p.n_split > 1) {
    // this block's share of the live tiles, from this row's own length
    const int tiles = max(hi - lo + BK - 1, 0) / BK;
    const int chunk = (tiles + p.n_split - 1) / p.n_split * BK;
    lo += split * chunk;
    hi = min(hi, lo + chunk);
  }

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
    if (p.n_split > 1) {
      float* part = p.part + (r * p.n_split + split) * (D + 2);
      if (tx == 0) {
        part[0] = m[i];
        part[1] = l[i];
      }
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) part[2 + tx + 16 * cc] = acc[i][cc];
      continue;
    }
    T* out = O + r * D;
    const bool dead = m[i] <= NEG_INF / 2;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < DC; ++cc)
      store(out + tx + 16 * cc, dead ? 0.f : acc[i][cc] / den);
  }
}

// Merge of the split-KV partials of one (b, position, head) row per block,
// one output column per thread: the online-softmax merge of n_split
// (m, l, acc) triples; a row no split saw a key for writes zeros.
template <typename T, int D>
__global__ void __launch_bounds__(D) combine_splits(AttnParams p) {
  const int64_t r = blockIdx.x;
  const float* part = p.part + r * p.n_split * (D + 2);
  float mx = NEG_INF;
  for (int s = 0; s < p.n_split; ++s) mx = fmaxf(mx, part[s * (D + 2)]);
  float l = 0.f, o = 0.f;
  for (int s = 0; s < p.n_split; ++s) {
    const float* ps = part + s * (D + 2);
    const float w = ps[0] <= NEG_INF / 2 ? 0.f : expf(ps[0] - mx);
    l += ps[1] * w;
    o += ps[2 + threadIdx.x] * w;
  }
  T* out = static_cast<T*>(p.o) + r * D;
  store(out + threadIdx.x, mx <= NEG_INF / 2 ? 0.f : o / fmaxf(l, 1e-30f));
}

template <typename T, typename KV, int D, int ROWS, bool PAGED>
cudaError_t launch(const AttnParams& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<ROWS, D, sizeof(KV) == 1>();
  auto kern = attn_fwd<T, KV, D, ROWS, PAGED>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int rows = p.sq * (p.hq / p.hkv);
  const int splits = p.n_split > 1 ? p.n_split : 1;
  dim3 grid((rows + 16 * ROWS - 1) / (16 * ROWS) * splits, p.hkv, p.b);
  kern<<<grid, THREADS, smem, stream>>>(p);
  if (splits > 1) {
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    combine_splits<T, D><<<p.b * p.sq * p.hq, D, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 tensor-core body (mma.sync m16n8k16, fp32 accumulation) for blocks of
// many rows: prefill and context chunks, where the work is bound by
// operations. Same row mapping, tile loop bounds, masks and dead-row
// contract as attn_fwd; 4 warps own 16 rows each of a 64-row block and a
// tile is 64 keys. Q fragments stay in registers for the whole key loop;
// S = Q K^T and the online softmax live in the mma accumulators; P goes back
// into the tensor cores as the A operand of P V without leaving registers.
// P is split into a bf16 high part and a bf16 remainder (two mma each), so
// the product keeps ~16 bits of P instead of bf16's 8 and the result matches
// the fp32 plain version to bf16 output rounding.
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;
constexpr int MMA_BQ = 64;
constexpr int MMA_BK = 64;

template <int D, bool QUANT>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (MMA_BQ + 2 * MMA_BK) * (D + 8) +
         (QUANT ? sizeof(float) * 2 * MMA_BK : 0);
}

// 16 one-byte K/V elements -> 16 bf16 at dst (16-byte aligned); exact
template <typename KV>
__device__ __forceinline__ void widen16_bf16(const uint4& raw,
                                             __nv_bfloat16* dst) {
  float f[16];
  unpack16<KV>(raw, f);
  uint4 out[2];
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(out);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  reinterpret_cast<uint4*>(dst)[0] = out[0];
  reinterpret_cast<uint4*>(dst)[1] = out[1];
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) -> bf16 pair hi and bf16 pair of what hi leaves out
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragment (16 keys x 8 columns) of a row-major [key][col] smem tile
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1,
                                                  const __nv_bfloat16* ptr) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b0), "=r"(b1)
      : "r"(addr));
}

// Page pools only (bf16 flash prefill has a body of its own). KV:
// __nv_bfloat16, or a one-byte quantized payload (int8_t, __nv_fp8_e4m3)
// widened to bf16 on its way into shared memory
template <typename KV, int D>
__global__ void __launch_bounds__(MMA_THREADS) attn_fwd_mma(AttnParams p) {
  constexpr bool QUANT = sizeof(KV) == 1;
  constexpr int LD = D + 8;       // padded rows: conflict-free fragment loads
  constexpr int KD = D / 16;      // k-steps of Q K^T
  constexpr int ND = D / 8;       // output column blocks of P V
  constexpr int NB = MMA_BK / 8;  // key column blocks of S
  constexpr int DV = D / 8;       // 16-byte loads per q row
  constexpr int KVEC = 16 / sizeof(KV);
  constexpr int KDV = D / KVEC;   // 16-byte loads per K/V row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + MMA_BQ * LD;
  __nv_bfloat16* sV = sK + MMA_BK * LD;
  float* sKs = reinterpret_cast<float*>(sV + MMA_BK * LD);  // QUANT scales
  float* sVs = sKs + MMA_BK;

  const __nv_bfloat16* Q = static_cast<const __nv_bfloat16*>(p.q);
  const KV* K = static_cast<const KV*>(p.k);
  const KV* V = static_cast<const KV*>(p.v);
  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(p.o);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int bi = blockIdx.z;
  const int kvh = blockIdx.y;
  const int g = p.hq / p.hkv;
  const int nrows = p.sq * g;
  const int row0 = blockIdx.x * MMA_BQ;
  const int qs = p.q_start ? p.q_start[bi] : 0;

  int kv_end = p.max_blocks * p.bs;
  if (p.kv_len) kv_end = min(kv_end, p.kv_len[bi]);
  const int kv_begin = p.kv_start ? max(p.kv_start[bi], 0) : 0;
  const int last = min(row0 + MMA_BQ, nrows) - 1;
  int hi = kv_end;
  if (p.causal) hi = min(hi, qs + last / g + 1);
  int lo = kv_begin;
  if (p.window > 0) lo = max(lo, qs + row0 / g - p.window + 1);
  lo = (lo / MMA_BK) * MMA_BK;

  for (int idx = threadIdx.x; idx < MMA_BQ * DV; idx += MMA_THREADS) {
    const int r = idx / DV, c = (idx % DV) * 8, fr = row0 + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (fr < nrows) {
      const int64_t pos = fr / g, h = kvh * g + fr % g;
      v = *reinterpret_cast<const uint4*>(
          Q + ((bi * (int64_t)p.sq + pos) * p.hq + h) * D + c);
    }
    *reinterpret_cast<uint4*>(sQ + r * LD + c) = v;
  }
  __syncthreads();

  // this thread's two rows (block-local) and their A fragments of Q
  const int ra = warp * 16 + gq, rb = ra + 8;
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const __nv_bfloat16* q0 = sQ + ra * LD + kk * 16 + 2 * tq;
    qf[kk][0] = ld32(q0);
    qf[kk][1] = ld32(q0 + 8 * LD);
    qf[kk][2] = ld32(q0 + 8);
    qf[kk][3] = ld32(q0 + 8 * LD + 8);
  }
  const bool live[2] = {row0 + ra < nrows, row0 + rb < nrows};
  const int qpos[2] = {qs + (row0 + ra) / g, qs + (row0 + rb) / g};
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  for (int k0 = lo; k0 < hi; k0 += MMA_BK) {
    __syncthreads();  // the previous tile's readers are done with sK/sV
    for (int idx = threadIdx.x; idx < MMA_BK * KDV; idx += MMA_THREADS) {
      const int j = idx / KDV, c = (idx % KDV) * KVEC, kpos = k0 + j;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
      if (kpos < hi) {
        const int64_t off =
            (key_row<true>(p, bi, kpos) * p.hkv + kvh) * D + c;
        kv = *reinterpret_cast<const uint4*>(K + off);
        vv = *reinterpret_cast<const uint4*>(V + off);
      }
      if constexpr (QUANT) {
        widen16_bf16<KV>(kv, sK + j * LD + c);
        widen16_bf16<KV>(vv, sV + j * LD + c);
      } else {
        *reinterpret_cast<uint4*>(sK + j * LD + c) = kv;
        *reinterpret_cast<uint4*>(sV + j * LD + c) = vv;
      }
    }
    if constexpr (QUANT) {
      for (int j = threadIdx.x; j < MMA_BK; j += MMA_THREADS) {
        const int kpos = k0 + j;
        float ks = 0.f, vs = 0.f;
        if (kpos < hi) {
          const int64_t r = key_row<true>(p, bi, kpos) * p.hkv + kvh;
          ks = p.k_scale[r];
          vs = p.v_scale[r];
        }
        sKs[j] = ks;
        sVs[j] = vs;
      }
    }
    __syncthreads();

    // S = Q K^T: s[nb] holds rows (ra, rb) x keys k0 + nb*8 + 2tq + {0,1}
    float s[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const __nv_bfloat16* k_ = sK + (nb * 8 + gq) * LD + kk * 16 + 2 * tq;
        mma_bf16(s[nb], qf[kk], ld32(k_), ld32(k_ + 8));
      }
    }

    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int kpos = k0 + nb * 8 + 2 * tq + (e & 1);
        bool ok = live[h] && kpos >= kv_begin && kpos < kv_end;
        if (p.causal) ok = ok && kpos <= qpos[h];
        if (p.window > 0) ok = ok && kpos > qpos[h] - p.window;
        float sv = s[nb][e];
        if constexpr (QUANT) sv *= sKs[nb * 8 + 2 * tq + (e & 1)];
        s[nb][e] = ok ? sv * p.scale : NEG_INF;
        mx[h] = fmaxf(mx[h], s[nb][e]);
      }
    }
    float m_new[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      m_new[h] = fmaxf(m[h], mx[h]);
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float pv =
            s[nb][e] <= NEG_INF / 2 ? 0.f : expf(s[nb][e] - m_new[h]);
        s[nb][e] = pv;
        rs[h] += pv;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
      const float corr = expf(m[h] - m_new[h]);
      l[h] = l[h] * corr + rs[h];
      m[h] = m_new[h];
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        acc[nd][2 * h] *= corr;
        acc[nd][2 * h + 1] *= corr;
      }
    }
    if constexpr (QUANT) {  // weigh V row j by p_j * v_scale_j
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] *= sVs[nb * 8 + 2 * tq + (e & 1)];
    }

    // O += P V, 16 keys per step; P's accumulator layout is the A layout
#pragma unroll
    for (int kk = 0; kk < MMA_BK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
      const __nv_bfloat16* vrow = sV + (kk * 16 + (lane & 15)) * LD;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, vrow + nd * 8);
        mma_bf16(acc[nd], ph, b0, b1);
        mma_bf16(acc[nd], pl, b0, b1);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!live[h]) continue;
    const int fr = row0 + (h ? rb : ra);
    const int64_t pos = fr / g, head = kvh * g + fr % g;
    __nv_bfloat16* out = O + ((bi * (int64_t)p.sq + pos) * p.hq + head) * D;
    const bool dead = m[h] <= NEG_INF / 2;
    const float den = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const float o0 = dead ? 0.f : acc[nd][2 * h] / den;
      const float o1 = dead ? 0.f : acc[nd][2 * h + 1] / den;
      *reinterpret_cast<__nv_bfloat162*>(out + nd * 8 + 2 * tq) =
          __floats2bfloat162_rn(o0, o1);
    }
  }
}

template <typename KV, int D>
cudaError_t launch_mma(const AttnParams& p, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D, sizeof(KV) == 1>();
  auto kern = attn_fwd_mma<KV, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int rows = p.sq * (p.hq / p.hkv);
  dim3 grid((rows + MMA_BQ - 1) / MMA_BQ, p.hkv, p.b);
  kern<<<grid, MMA_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// Few rows (a decode step's g query heads) take the scalar 16-row block.
// Larger blocks take the tensor-core body in bf16 and the scalar 64-row
// block in fp32 (mma.sync has no fp32 inputs; the fp32 path is the one the
// parity runs use). Head dims the port serves: 32, 64, 128. Contiguous
// K/V (PAGED false) is fp32 flash prefill's only.
template <typename T, typename KV, bool PAGED>
cudaError_t dispatch_d(const AttnParams& p, int d, cudaStream_t stream) {
  const bool small = p.sq * (p.hq / p.hkv) <= 16;
  if constexpr (sizeof(T) == 2) {
    static_assert(PAGED, "bf16 on contiguous K/V has bodies of its own");
    switch (d) {
      case 32:
        return small ? launch<T, KV, 32, 1, PAGED>(p, stream)
                     : launch_mma<KV, 32>(p, stream);
      case 64:
        return small ? launch<T, KV, 64, 1, PAGED>(p, stream)
                     : launch_mma<KV, 64>(p, stream);
      case 128:
        return small ? launch<T, KV, 128, 1, PAGED>(p, stream)
                     : launch_mma<KV, 128>(p, stream);
      default:
        return cudaErrorInvalidValue;
    }
  } else {
    switch (d) {
      case 32:
        return small ? launch<T, KV, 32, 1, PAGED>(p, stream)
                     : launch<T, KV, 32, 4, PAGED>(p, stream);
      case 64:
        return small ? launch<T, KV, 64, 1, PAGED>(p, stream)
                     : launch<T, KV, 64, 4, PAGED>(p, stream);
      case 128:
        return small ? launch<T, KV, 128, 1, PAGED>(p, stream)
                     : launch<T, KV, 128, 4, PAGED>(p, stream);
      default:
        return cudaErrorInvalidValue;
    }
  }
}

template <typename KV>
cudaError_t dispatch_q(const AttnParams& p, int d, int dtype,
                       cudaStream_t stream) {
  if (dtype == 0) return dispatch_d<float, KV, true>(p, d, stream);
  if (dtype == 1) return dispatch_d<__nv_bfloat16, KV, true>(p, d, stream);
  return cudaErrorInvalidValue;
}

}  // namespace rt
