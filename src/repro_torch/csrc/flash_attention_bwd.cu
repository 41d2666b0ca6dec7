// Flash attention backward for Hopper (sm_90a): the gradient of #1.
//
// Replaces: src/repro/kernels/ops.py:_fa_full_bwd, the hand-written VJP the
// reference wraps around its flash path (an XLA custom VJP, not a Pallas
// kernel; the TPU grid's forward is flash_attention_pallas). FA2's
// algorithm: from the forward's output o and the rows' log-sum-exp lse
// (b, hq, sq) fp32 (written by flash_attention.cu's LSE instances), with
// scores S = Q K^T scale and P = exp(S - lse) recomputed tile by tile,
//   D  = rowsum(dO * O)                        (pass 1)
//   dV = P^T dO,  dK = dS^T Q                  (pass 2, per key tile)
//   dQ = dS K                                  (pass 3, per row tile)
// with dS = P (dO V^T - D) scale. q, dq (b, sq, hq, d); k, v, dk, dv
// (b, skv, hkv, d) in fp32 or bf16; every sum is fp32. Causal or not,
// sq != skv (queries at positions 0 .. sq-1, as the forward's causal mask
// has them), kv_len / kv_start masks, a sliding window (a row at position p
// sees keys (p - window, p]), GQA with any g (dK and dV sum over the g query
// heads of their kv head), d 64, 80 (h2o-danube-1.8b), 128 or 256
// (paligemma-3b).
//
// Deterministic, no atomics: dK / dV and dQ each have one owner, a block
// that walks the other axis in order, so the gradient is the same bits
// from run to run. That recomputes S and dO V^T once more in pass 3: seven
// products of the pair count where five would do (FA3's atomicAdd into dQ
// would save two, but its order of additions varies between runs).
//
// Bound on the card: at training shapes the five products dominate (five
// 2 d FLOPs per visible (query, key) pair), far above the ridge, so it is
// bound by operations. Two bodies:
//
//  - The tensor-core body (namespace fbh): bf16 at head dims 64 and 128
//    with a GQA group of at most 64 (every group the bf16 forward takes),
//    FA2's backward with all its products on wgmma. Rows are grouped as
//    in the forward: a 64-row tile is P = 64 / g positions x the g query
//    heads of one kv head. Pass 1 writes each row's lse log2 e and D in
//    that order. A block is two warpgroups; its thread 0 issues the TMA
//    loads of the tiles it streams three ahead through a ring of four
//    stages with full and empty mbarriers. There is no producer warp:
//    ptxas fits every thread of a block within the launch bound, rounding
//    the block up to whole warpgroups (setmaxnreg moves registers at run
//    time only), so a third warpgroup would leave 168 registers a thread,
//    where two leave 255.
//      dK / dV (dkdv_kernel): a block owns 128 keys of one (b, kv head),
//    64 a warpgroup, resident as K and V tiles in shared memory, and
//    streams the row tiles that can see them (the causal start, the
//    window's band), each with its rows' stats (one bulk copy of a
//    16-byte aligned window). A warpgroup computes S^T = K Q^T and dP^T =
//    V dO^T on wgmma with both operands from shared memory and keys as M,
//    P^T = 2^(S^T scale log2 e - lse log2 e) and dS^T = P^T (dP^T - D)
//    scale on the accumulators, then dV += P^T dO and dK += dS^T Q with
//    P^T and dS^T as bf16 register fragments and dO and Q through
//    transposing (MN-major) descriptors. dK and dV of 64 keys at d 128
//    are 128 registers a thread beside S^T's and dP^T's 64.
//      dQ (dq_kernel): a block owns 2 x 64 rows of one (b, kv head), Q and
//    dO resident, and streams the 64-key K / V tiles they can see; S = Q
//    K^T and dP = dO V^T as above, then dQ += dS K with K through a
//    transposing descriptor. (Pipelining tile t + 1's score products
//    against tile t's dS within a warpgroup, in a second register buffer,
//    made it slower: the two warpgroups already overlap each other.)
//    P^T and dS round to bf16 as wgmma operands (as the forward rounds P
//    once); every sum stays fp32. A tile's rows past P g (g not dividing
//    64: the zoo's g 48 and g 3) are never loaded: they are masked (p =
//    0) and the dK / dV kernel zeroes its row buffers once, so those rows
//    add nothing (stale shared memory could hold NaN); the dQ kernel
//    writes nothing for them. A masked entry's dS^T is P^T (= 0) times
//    its row's dP^T - D, so every D a tile's stats window holds must be
//    finite: the window of the last tile reaches past the rows, and pass
//    1 zeroes that pad (the scratch's 128 pairs past them), which would
//    otherwise be memory as the allocator left it (NaN poisons a column
//    of dS^T, and dK of the kv head). Masks are applied only on the
//    tiles that need them.
//
//  - The SIMT body (namespace fb): fp32 at every head dim (the parity
//    path), and bf16 at d 80 (h2o-danube-1.8b), 256 (paligemma-3b) or with
//    a group past 64. It runs the products on the fp32 pipes: a block of
//    256 threads as a 16 x 16 grid (ty, tx) owns a 32-key (pass 2) or
//    32-row (pass 3) tile of fp32 accumulators in registers, and stages Q,
//    dO, K, V tiles as fp32 in shared memory, rows padded to d + 1 floats
//    so that the column walks hit distinct banks.
//
// A row of a tile is one (position, query head) pair of one kv head's
// group (row r: position r / g, head kvh g + r % g), as in the forward, so
// each K / V tile serves all g heads. Masking follows repro.kernels.ref: a
// masked pair has P = 0 (and so dS = 0), never exp(S - lse) of a score
// the forward did not see. A window bounds the tiles each block walks to
// the band its rows or keys can see, so the work grows with s x window,
// not s^2. The SIMT body at d 256 stages 140 KB of shared memory a block
// (Smem below), within the 227 KB a block may opt into.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash.cuh"

namespace fb {

constexpr int THREADS = 256;
constexpr int BN = 32;  // keys a tile
constexpr int BM = 32;  // rows a tile

struct Params {
  const void *q, *k, *v, *o, *dout;
  const float* lse;  // (b, hq, sq)
  float* delta;      // (b, hq, sq): rowsum(dO * O), pass 1's output
  void *dq, *dk, *dv;
  const int* kv_len;    // (b,) or null
  const int* kv_start;  // (b,) or null
  int b, sq, skv, hq, hkv, g, causal;
  float scale;
  int window;  // > 0: a row at position p sees keys (p - window, p]
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// pass 1: D = rowsum(dO * O) of every (b, position, query head), one warp
// a row
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) delta_kernel(Params p) {
  const int64_t rows = (int64_t)p.b * p.sq * p.hq;
  const int64_t r = (int64_t)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const T* o = static_cast<const T*>(p.o) + r * D;
  const T* d = static_cast<const T*>(p.dout) + r * D;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32) acc += to_f(o[c]) * to_f(d[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    // r = (bi * sq + pos) * hq + h -> (bi, h, pos)
    const int64_t h = r % p.hq, bp = r / p.hq;
    const int64_t bi = bp / p.sq, pos = bp % p.sq;
    p.delta[(bi * p.hq + h) * p.sq + pos] = acc;
  }
}

// rows [r0, r0 + BM) of one kv head's group (row r: position r / g, head
// kvh g + r % g) of a (b, sq, hq, D) tensor into dst[BM][D + 1] as fp32;
// zeros past the last row
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int bi,
                                          int kvh, int r0, const Params& p) {
  constexpr int VEC = 16 / sizeof(T), PER = D / VEC;
  const int nrows = p.sq * p.g;
  for (int i = threadIdx.x; i < BM * PER; i += THREADS) {
    const int rr = i / PER, c = (i % PER) * VEC, r = r0 + rr;
    alignas(16) T val[VEC];
    if (r < nrows) {
      const int64_t pos = r / p.g, h = kvh * p.g + r % p.g;
      *reinterpret_cast<uint4*>(val) = *reinterpret_cast<const uint4*>(
          src + ((bi * (int64_t)p.sq + pos) * p.hq + h) * D + c);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) val[j] = from_f<T>(0.f);
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) dst[rr * (D + 1) + c + j] = to_f(val[j]);
  }
}

// keys [k0, k0 + BN) of kv head kvh of a (b, skv, hkv, D) tensor into
// dst[BN][D + 1] as fp32; zeros past skv
template <typename T, int D>
__device__ __forceinline__ void load_keys(float* dst, const T* src, int bi,
                                          int kvh, int k0, const Params& p) {
  constexpr int VEC = 16 / sizeof(T), PER = D / VEC;
  for (int i = threadIdx.x; i < BN * PER; i += THREADS) {
    const int j = i / PER, c = (i % PER) * VEC, kpos = k0 + j;
    alignas(16) T val[VEC];
    if (kpos < p.skv) {
      *reinterpret_cast<uint4*>(val) = *reinterpret_cast<const uint4*>(
          src + ((bi * (int64_t)p.skv + kpos) * p.hkv + kvh) * D + c);
    } else {
#pragma unroll
      for (int jj = 0; jj < VEC; ++jj) val[jj] = from_f<T>(0.f);
    }
#pragma unroll
    for (int jj = 0; jj < VEC; ++jj) dst[j * (D + 1) + c + jj] = to_f(val[jj]);
  }
}

// lse and D of rows [r0, r0 + BM) into sl, sd
__device__ __forceinline__ void load_row_stats(float* sl, float* sd, int bi,
                                               int kvh, int r0,
                                               const Params& p) {
  for (int rr = threadIdx.x; rr < BM; rr += THREADS) {
    const int r = r0 + rr;
    float l = 0.f, dd = 0.f;
    if (r < p.sq * p.g) {
      const int64_t i =
          (bi * (int64_t)p.hq + kvh * p.g + r % p.g) * p.sq + r / p.g;
      l = p.lse[i];
      dd = p.delta[i];
    }
    sl[rr] = l;
    sd[rr] = dd;
  }
}

// Shared memory of both passes: the row tile's Q and dO, the key tile's K
// and V (fp32, rows of D + 1), P and dS of the tile pair, lse and D of
// the rows.
template <int D>
struct Smem {
  static constexpr int ROW = D + 1;
  static constexpr int Q = 0, DO = Q + BM * ROW, K = DO + BM * ROW,
                       V = K + BN * ROW, P = V + BN * ROW,
                       DS = P + BM * (BN + 1), L = DS + BM * (BN + 1),
                       DL = L + BM, FLOATS = DL + BM;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

// P and dS of the tile pair (rows r0.., keys k0..) into shared memory:
// thread (ty, tx) takes rows ty + 16 i and keys tx + 16 j (i, j < 2)
template <int D>
__device__ __forceinline__ void tile_p_ds(float* sm, int r0, int k0,
                                          int kv_begin, int kv_end,
                                          const Params& p) {
  using S = Smem<D>;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[2][2] = {}, dp[2][2] = {};
#pragma unroll 8
  for (int c = 0; c < D; ++c) {
    float qv[2], dov[2], kv[2], vv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      qv[i] = sm[S::Q + (ty + 16 * i) * S::ROW + c];
      dov[i] = sm[S::DO + (ty + 16 * i) * S::ROW + c];
      kv[i] = sm[S::K + (tx + 16 * i) * S::ROW + c];
      vv[i] = sm[S::V + (tx + 16 * i) * S::ROW + c];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[i][j] += qv[i] * kv[j];
        dp[i][j] += dov[i] * vv[j];
      }
  }
  const int nrows = p.sq * p.g;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rr = ty + 16 * i, r = r0 + rr, qpos = r / p.g;
    const float l = sm[S::L + rr], dd = sm[S::DL + rr];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int jj = tx + 16 * j, kpos = k0 + jj;
      bool ok = r < nrows && kpos >= kv_begin && kpos < kv_end;
      if (p.causal) ok = ok && kpos <= qpos;
      if (p.window > 0) ok = ok && kpos > qpos - p.window;
      const float pv = ok ? expf(s[i][j] * p.scale - l) : 0.f;
      sm[S::P + rr * (BN + 1) + jj] = pv;
      sm[S::DS + rr * (BN + 1) + jj] = pv * (dp[i][j] - dd) * p.scale;
    }
  }
}

__device__ __forceinline__ void live_keys(const Params& p, int bi,
                                          int& kv_begin, int& kv_end) {
  kv_end = p.kv_len ? min(p.skv, p.kv_len[bi]) : p.skv;
  kv_begin = p.kv_start ? max(p.kv_start[bi], 0) : 0;
}

// pass 2: dK, dV of keys [k0, k0 + BN) of kv head blockIdx.y of row
// blockIdx.z, over every row tile that can see them
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) dkdv_kernel(Params p) {
  using S = Smem<D>;
  constexpr int DC = D / 16;
  extern __shared__ float sm[];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * BN, kvh = blockIdx.y, bi = blockIdx.z;
  int kv_begin, kv_end;
  live_keys(p, bi, kv_begin, kv_end);
  load_keys<T, D>(sm + S::K, static_cast<const T*>(p.k), bi, kvh, k0, p);
  load_keys<T, D>(sm + S::V, static_cast<const T*>(p.v), bi, kvh, k0, p);
  // thread (ty, tx) owns keys ty + 16 j (j < 2), columns tx + 16 c
  float dk[2][DC] = {}, dv[2][DC] = {};
  const int nrows = p.sq * p.g;
  // a causal row sees key k0 from position k0 on; a windowed row at
  // position p sees no key of this tile once p >= k0 + BN - 1 + window
  const int r_lo = p.causal ? min(k0, p.sq) * p.g / BM * BM : 0;
  const int r_hi =
      p.window > 0 ? min(nrows, min(k0 + BN - 1 + p.window, p.sq) * p.g)
                   : nrows;
  const bool any = k0 < kv_end && k0 + BN > kv_begin;
  for (int r0 = any ? r_lo : nrows; r0 < r_hi; r0 += BM) {
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, D>(sm + S::Q, static_cast<const T*>(p.q), bi, kvh, r0, p);
    load_rows<T, D>(sm + S::DO, static_cast<const T*>(p.dout), bi, kvh, r0,
                    p);
    load_row_stats(sm + S::L, sm + S::DL, bi, kvh, r0, p);
    __syncthreads();
    tile_p_ds<D>(sm, r0, k0, kv_begin, kv_end, p);
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < BM; ++rr) {
      float pv[2], dsv[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        pv[j] = sm[S::P + rr * (BN + 1) + ty + 16 * j];
        dsv[j] = sm[S::DS + rr * (BN + 1) + ty + 16 * j];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float dov = sm[S::DO + rr * S::ROW + tx + 16 * c];
        const float qv = sm[S::Q + rr * S::ROW + tx + 16 * c];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          dv[j][c] += pv[j] * dov;
          dk[j][c] += dsv[j] * qv;
        }
      }
    }
  }
  T* DK = static_cast<T*>(p.dk);
  T* DV = static_cast<T*>(p.dv);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int kpos = k0 + ty + 16 * j;
    if (kpos >= p.skv) continue;
    const int64_t base = ((bi * (int64_t)p.skv + kpos) * p.hkv + kvh) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      DK[base + tx + 16 * c] = from_f<T>(dk[j][c]);
      DV[base + tx + 16 * c] = from_f<T>(dv[j][c]);
    }
  }
}

// pass 3: dQ of rows [r0, r0 + BM) of kv head blockIdx.y's group of row
// blockIdx.z, over every key tile they can see
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) dq_kernel(Params p) {
  using S = Smem<D>;
  constexpr int DC = D / 16;
  extern __shared__ float sm[];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int r0 = blockIdx.x * BM, kvh = blockIdx.y, bi = blockIdx.z;
  int kv_begin, kv_end;
  live_keys(p, bi, kv_begin, kv_end);
  const int nrows = p.sq * p.g;
  const int last = min(r0 + BM, nrows) - 1;
  const int hi = p.causal ? min(kv_end, last / p.g + 1) : kv_end;
  // a windowed row at position p sees keys past p - window only
  const int lo =
      p.window > 0 ? max(kv_begin, r0 / p.g - p.window + 1) : kv_begin;
  load_rows<T, D>(sm + S::Q, static_cast<const T*>(p.q), bi, kvh, r0, p);
  load_rows<T, D>(sm + S::DO, static_cast<const T*>(p.dout), bi, kvh, r0,
                  p);
  load_row_stats(sm + S::L, sm + S::DL, bi, kvh, r0, p);
  // thread (ty, tx) owns rows ty + 16 i (i < 2), columns tx + 16 c
  float dq[2][DC] = {};
  for (int k0 = lo / BN * BN; k0 < hi; k0 += BN) {
    __syncthreads();
    load_keys<T, D>(sm + S::K, static_cast<const T*>(p.k), bi, kvh, k0, p);
    load_keys<T, D>(sm + S::V, static_cast<const T*>(p.v), bi, kvh, k0, p);
    __syncthreads();
    tile_p_ds<D>(sm, r0, k0, kv_begin, kv_end, p);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BN; ++j) {
      float dsv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        dsv[i] = sm[S::DS + (ty + 16 * i) * (BN + 1) + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float kv = sm[S::K + j * S::ROW + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 2; ++i) dq[i][c] += dsv[i] * kv;
      }
    }
  }
  T* DQ = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= nrows) continue;
    const int64_t base =
        ((bi * (int64_t)p.sq + r / p.g) * p.hq + kvh * p.g + r % p.g) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) DQ[base + tx + 16 * c] = from_f<T>(dq[i][c]);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t st) {
  constexpr size_t smem = Smem<D>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      dkdv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e != cudaSuccess) return e;
  const int64_t rows = (int64_t)p.b * p.sq * p.hq;
  delta_kernel<T, D><<<(unsigned)((rows + 7) / 8), THREADS, 0, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dkdv_kernel<T, D>
      <<<dim3((p.skv + BN - 1) / BN, p.hkv, p.b), THREADS, smem, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dq_kernel<T, D><<<dim3((p.sq * p.g + BM - 1) / BM, p.hkv, p.b), THREADS,
                     smem, st>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_d(const Params& p, int d, cudaStream_t st) {
  switch (d) {
    case 64:
      return launch<T, 64>(p, st);
    case 80:  // h2o-danube-1.8b: VEC divides 80 in both dtypes, DC = 5
      return launch<T, 80>(p, st);
    case 128:
      return launch<T, 128>(p, st);
    case 256:  // paligemma-3b: 140 KB of shared memory a block
      return launch<T, 256>(p, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace fb

// The tensor-core body: bf16 at head dims 64 and 128 with a GQA group of at
// most 64 (see the note at the top of this file).
namespace fbh {

using bf16 = __nv_bfloat16;
using fa::Geo;
constexpr int ROWS = fa::WG_ROWS;  // a warpgroup's keys (dK / dV) or rows (dQ)
// Warpgroups a block, no producer warp: ptxas fits every thread of a block
// within the launch bound, rounding it up to whole warpgroups (setmaxnreg
// moves registers at run time only), so a third warpgroup or warp would
// leave 168 registers a thread, too few for dK and dV beside S^T and dP^T.
// Thread 0 issues the loads.
constexpr int NC = 2;
constexpr int THREADS = 128 * NC;
constexpr int STAGES = 4;          // streamed tiles in flight
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const bf16 *o, *dout;
  const float* lse;  // (b, hq, sq)
  // (b, hkv, sq g): {lse log2 e, D} of each row, row = position g + head
  // within its kv head's group (the rows' order of both kernels' tiles)
  float2* stats;
  bf16 *dq, *dk, *dv;
  const int* kv_len;    // (b,) or null
  const int* kv_start;  // (b,) or null
  int b, sq, skv, hq, hkv, g, P, causal, window;
  float scale, scale_log2;
};

// pass 1: D = rowsum(dO * O) and lse log2 e of every row into stats in the
// rows' order; LANES lanes a row, 16 bytes of O and of dO a lane
template <int D>
__global__ void __launch_bounds__(256) stats_kernel(const Params p) {
  constexpr int LANES = D / 8, RPB = 256 / LANES;  // lanes a row, rows a block
  const int64_t rows = (int64_t)p.b * p.sq * p.hq;
  const int64_t r = (int64_t)blockIdx.x * RPB + threadIdx.x / LANES;
  const int part = threadIdx.x % LANES;
  float acc = 0.f;
  if (r < rows) {
    const uint4 a = *reinterpret_cast<const uint4*>(p.o + r * D + part * 8);
    const uint4 b = *reinterpret_cast<const uint4*>(p.dout + r * D + part * 8);
    const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 u = __bfloat1622float2(x[e]), v = __bfloat1622float2(y[e]);
      acc += u.x * v.x + u.y * v.y;
    }
  }
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  // the pad the last row tile's stats window reaches into: zeros
  if (blockIdx.x == 0 && threadIdx.x < 128)
    p.stats[rows + threadIdx.x] = make_float2(0.f, 0.f);
  if (r < rows && part == 0) {
    // r = (bi * sq + pos) * hq + hh
    const int64_t hh = r % p.hq, bp = r / p.hq;
    const int64_t bi = bp / p.sq, pos = bp % p.sq;
    const int64_t kvh = hh / p.g, h = hh % p.g;
    p.stats[((bi * p.hkv + kvh) * p.sq + pos) * p.g + h] =
        make_float2(p.lse[(bi * p.hq + hh) * p.sq + pos] * LOG2E, acc);
  }
}

// acc (64 x 64) = A B^T over d: A the 64 rows at a, B the 64 rows at b,
// both K-major tiles of Geo<D>'s swizzled chunks (64 rows a chunk)
template <int D>
__device__ __forceinline__ void issue_ss(float (&acc)[32],
                                         const unsigned char* a,
                                         const unsigned char* b) {
  using G = Geo<D>;
  // the k-steps' descriptors are the base's plus the step's offset (16-byte
  // units of the 14-bit address field, which no offset here carries out
  // of); the empty asm keeps the compiler from hoisting all 2 D / 16 of a
  // resident tile's out of the tile loop, 64 registers at d 128
  uint64_t da = hx::gmma_desc(a, 16, 8 * G::ROWB, G::SWZ);
  uint64_t db = hx::gmma_desc(b, 16, 8 * G::ROWB, G::SWZ);
  asm volatile("" : "+l"(da), "+l"(db));
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk / (G::CH / 16), kb = (kk % (G::CH / 16)) * 32;
    const uint64_t off = (c * ROWS * G::ROWB + kb) >> 4;
    hx::wgmma_ss_n64(acc, da + off, db + off, kk > 0);
  }
}

// the two score products of a tile pair on the tensor cores, waited for:
// s = A1 B1^T, dp = A2 B2^T
template <int D>
__device__ __forceinline__ void scores(float (&s)[32], float (&dp)[32],
                                       const unsigned char* a1,
                                       const unsigned char* b1,
                                       const unsigned char* a2,
                                       const unsigned char* b2) {
  hx::fence_regs(s);
  hx::fence_regs(dp);
  hx::wgmma_fence();
  issue_ss<D>(s, a1, b1);
  issue_ss<D>(dp, a2, b2);
  hx::wgmma_commit();
  hx::wgmma_wait<0>();
  hx::fence_regs(s);
  hx::fence_regs(dp);
}

template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[D / 2],
                                           int h, int tq) {
  // this thread's columns 8 j + 2 tq, + 1 of accumulator row half h
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * tq) =
        fa::pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

// The ring both passes stream tiles through: thread 0 issues tile t +
// STAGES - 1's loads at the top of tile t, into the stage tile t - 1 has
// just left, once every warp has handed that stage back.
struct Ring {
  uint64_t *full, *empty;
  __device__ __forceinline__ void wait(int t) const {
    hx::mbar_wait(&full[t % STAGES], (t / STAGES) & 1);
  }
  __device__ __forceinline__ void release(int t, int lane) const {
    if (lane == 0) hx::mbar_arrive(&empty[t % STAGES]);
  }
  // the stage tile t + STAGES - 1 loads into, once free; -1 for none
  __device__ __forceinline__ int next(int t, int n) const {
    const int u = t + STAGES - 1;
    if (u >= n) return -1;
    if (t > 0) hx::mbar_wait(&empty[(t - 1) % STAGES], ((t - 1) / STAGES) & 1);
    return u % STAGES;
  }
};

// a row tile's stats: a 16-byte aligned window of the rows' (lse log2 e, D)
// pairs, 2 more than the tile's 64 (the first row is pair 0 or 1 of it)
constexpr int STAT_PAIRS = ROWS + 2;

template <int D>
struct SmemKV {  // the dK / dV kernel
  static constexpr int T = ROWS * D * 2;  // one 64-row tile
  static constexpr size_t K = 0;          // [NC] resident key tiles
  static constexpr size_t V = K + (size_t)NC * T;
  static constexpr size_t Q = V + (size_t)NC * T;  // [STAGES] row tiles
  static constexpr size_t DO = Q + (size_t)STAGES * T;
  static constexpr size_t ST = DO + (size_t)STAGES * T;  // [STAGES] stats
  static constexpr size_t COL = ST + (size_t)STAGES * STAT_PAIRS * 8;
  static constexpr size_t BAR = COL + ROWS * 4;
  static constexpr size_t BYTES = BAR + (2 * STAGES + 1) * 8 + 1024;
};

// pass 2: dK and dV of keys [k0, k0 + NC ROWS) of kv head blockIdx.x of row
// blockIdx.y (k0 from blockIdx.z, the keys most rows see first), over the
// row tiles (P positions x g heads) that can see them
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    dkdv_kernel(const Params p, const __grid_constant__ CUtensorMap tmq,
                const __grid_constant__ CUtensorMap tmdo,
                const __grid_constant__ CUtensorMap tmk,
                const __grid_constant__ CUtensorMap tmv) {
  using G = Geo<D>;
  using S = SmemKV<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::BAR);
  const Ring ring{bars, bars + STAGES};
  uint64_t* kvbar = bars + 2 * STAGES;
  const float2* stats = reinterpret_cast<const float2*>(smem + S::ST);
  int* col_pos = reinterpret_cast<int*>(smem + S::COL);
  const int kvh = blockIdx.x, bi = blockIdx.y;
  const int k0 = blockIdx.z * NC * ROWS;
  const int kv_end = p.kv_len ? min(p.skv, p.kv_len[bi]) : p.skv;
  const int kv_begin = p.kv_start ? max(p.kv_start[bi], 0) : 0;
  // the rows that may see a key of the block: a causal row at position q
  // sees keys <= q, a windowed one keys > q - window
  const int p_lo = p.causal ? min(k0, p.sq) : 0;
  const int p_hi =
      p.window > 0 ? min(p.sq, k0 + NC * ROWS - 1 + p.window) : p.sq;
  const bool any = k0 < kv_end && k0 + NC * ROWS > kv_begin;
  const int ntiles = any && p_hi > p_lo ? (p_hi - p_lo + p.P - 1) / p.P : 0;
  const float2* rows_g = p.stats + ((size_t)bi * p.hkv + kvh) * p.sq * p.g;
  // tile t: the row tile of positions [p_lo + t P, + P), and the window of
  // its stats
  auto load = [&](int t, int st) {
    const int p0 = p_lo + t * p.P;
    const uintptr_t a = reinterpret_cast<uintptr_t>(rows_g + (size_t)p0 * p.g);
    hx::mbar_arrive_tx(&ring.full[st],
                       2 * p.P * p.g * D * 2 + STAT_PAIRS * 8);
    hx::bulk_load(smem + S::ST + (size_t)st * STAT_PAIRS * 8,
                  reinterpret_cast<const void*>(a & ~uintptr_t(15)),
                  STAT_PAIRS * 8, &ring.full[st]);
#pragma unroll
    for (int c = 0; c < G::NCH; ++c) {
      hx::tma_load_4d(smem + S::Q + (size_t)st * S::T + c * ROWS * G::ROWB,
                      &tmq, &ring.full[st], c * G::CH, kvh * p.g, p0, bi);
      hx::tma_load_4d(smem + S::DO + (size_t)st * S::T + c * ROWS * G::ROWB,
                      &tmdo, &ring.full[st], c * G::CH, kvh * p.g, p0, bi);
    }
  };

  // a row tile holds P g rows: the rows past them stay zero (p = 0 there,
  // and a zero row adds nothing to dK or dV; stale memory could be NaN)
  for (int i = threadIdx.x; i < 2 * STAGES * S::T / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(smem + S::Q)[i] = make_uint4(0, 0, 0, 0);
  // row c of a tile: position p0 + col_pos[c], or no row (-1)
  for (int c = threadIdx.x; c < ROWS; c += blockDim.x)
    col_pos[c] = c < p.P * p.g ? c / p.g : -1;
  hx::fence_proxy_async();
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hx::mbar_init(&ring.full[s], 1);
      hx::mbar_init(&ring.empty[s], 4 * NC);  // one arrival per warp
    }
    hx::mbar_init(kvbar, 1);
    hx::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hx::mbar_arrive_tx(kvbar, 2 * NC * S::T);
    for (int w = 0; w < NC; ++w) {
#pragma unroll
      for (int c = 0; c < G::NCH; ++c) {
        const size_t off = (size_t)w * S::T + c * ROWS * G::ROWB;
        hx::tma_load_4d(smem + S::K + off, &tmk, kvbar, c * G::CH, kvh,
                        k0 + w * ROWS, bi);
        hx::tma_load_4d(smem + S::V + off, &tmv, kvbar, c * G::CH, kvh,
                        k0 + w * ROWS, bi);
      }
    }
    for (int t = 0; t < min(STAGES - 1, ntiles); ++t) load(t, t);
  }

  // warpgroup w owns keys [kw0, kw0 + 64); S^T = K Q^T and dP^T = V dO^T
  // with keys as wgmma's M, rows as N
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, tq = lane % 4;
  const int ra = warp * 16 + lane / 4;  // accumulator rows ra, ra + 8
  const int kw0 = k0 + wg * ROWS;
  const unsigned char* kt = smem + S::K + (size_t)wg * S::T;
  const unsigned char* vt = smem + S::V + (size_t)wg * S::T;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  hx::mbar_wait(kvbar, 0);
  for (int t = 0; t < ntiles; ++t) {
    if (threadIdx.x == 0) {
      const int st = ring.next(t, ntiles);
      if (st >= 0) load(t + STAGES - 1, st);
    }
    const int stage = t % STAGES;
    const int p0 = p_lo + t * p.P, p_last = p0 + p.P - 1;
    ring.wait(t);
    // a tile no row of which sees this warpgroup's keys only passes
    const bool seen = !(p.causal && p_last < kw0) &&
                      !(p.window > 0 && p0 >= kw0 + ROWS - 1 + p.window) &&
                      kw0 < kv_end && kw0 + ROWS > kv_begin;
    if (seen) {
      const unsigned char* qt = smem + S::Q + (size_t)stage * S::T;
      const unsigned char* dt = smem + S::DO + (size_t)stage * S::T;
      float s[32], dp[32];
      scores<D>(s, dp, kt, qt, vt, dt);
      // mask only where the tile needs it: part-filled, the causal
      // diagonal, the window's and the live keys' edges
      const bool full_tile =
          p.P * p.g == ROWS && p_last < p.sq && kw0 >= kv_begin &&
          kw0 + ROWS <= kv_end && (!p.causal || kw0 + ROWS - 1 <= p0) &&
          (p.window <= 0 || kw0 > p_last - p.window);
      const float2* sw =
          stats + stage * STAT_PAIRS +
          ((reinterpret_cast<uintptr_t>(rows_g + (size_t)p0 * p.g) >> 3) & 1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * tq + e;
          const float2 r = sw[c];  // (lse log2 e, D) of row c
          const int pos = p0 + col_pos[c];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * h + e, key = kw0 + ra + 8 * h;
            bool ok = true;
            if (!full_tile) {
              ok = col_pos[c] >= 0 && pos < p.sq && key >= kv_begin &&
                   key < kv_end;
              if (p.causal) ok = ok && key <= pos;
              if (p.window > 0) ok = ok && key > pos - p.window;
            }
            const float pv =
                ok ? fa::ex2(fmaf(s[i], p.scale_log2, -r.x)) : 0.f;
            s[i] = pv;
            dp[i] = pv * (dp[i] - r.y) * p.scale;
          }
        }
      }
      // P^T and dS^T as bf16 A fragments: dV += P^T dO, dK += dS^T Q
      uint32_t pf[4][4], df[4][4];
      fa::pack_p<ROWS>(pf, s);
      fa::pack_p<ROWS>(df, dp);
      fa::issue_pv<D, ROWS>(dv, pf, dt);
      fa::issue_pv<D, ROWS>(dk, df, qt);
      hx::wgmma_wait<0>();
      hx::fence_regs(dv);
      hx::fence_regs(dk);
    }
    ring.release(t, lane);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = kw0 + ra + 8 * h;
    if (key >= p.skv) continue;
    const size_t base = (((size_t)bi * p.skv + key) * p.hkv + kvh) * D;
    store_rows<D>(p.dv + base, dv, h, tq);
    store_rows<D>(p.dk + base, dk, h, tq);
  }
}

template <int D>
struct SmemQ {  // the dQ kernel
  static constexpr int T = ROWS * D * 2;
  static constexpr size_t Q = 0;  // [NC] resident row tiles
  static constexpr size_t DO = Q + (size_t)NC * T;
  static constexpr size_t K = DO + (size_t)NC * T;  // [STAGES] key tiles
  static constexpr size_t V = K + (size_t)STAGES * T;
  static constexpr size_t BAR = V + (size_t)STAGES * T;
  static constexpr size_t BYTES = BAR + (2 * STAGES + 1) * 8 + 1024;
};

// pass 3: dQ of positions [pos0, pos0 + NC P) (from blockIdx.z, longest
// causal rows first) of kv head blockIdx.x's group of row blockIdx.y, over
// the key tiles they can see
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    dq_kernel(const Params p, const __grid_constant__ CUtensorMap tmq,
              const __grid_constant__ CUtensorMap tmdo,
              const __grid_constant__ CUtensorMap tmk,
              const __grid_constant__ CUtensorMap tmv) {
  using G = Geo<D>;
  using S = SmemQ<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::BAR);
  const Ring ring{bars, bars + STAGES};
  uint64_t* qbar = bars + 2 * STAGES;
  const int kvh = blockIdx.x, bi = blockIdx.y;
  const int pos0 = (gridDim.z - 1 - blockIdx.z) * NC * p.P;
  const int kv_end = p.kv_len ? min(p.skv, p.kv_len[bi]) : p.skv;
  const int kv_begin = p.kv_start ? max(p.kv_start[bi], 0) : 0;
  const int last = min(pos0 + NC * p.P, p.sq) - 1;
  const int hi = p.causal ? min(kv_end, last + 1) : kv_end;
  const int lo =
      (p.window > 0 ? max(kv_begin, pos0 - p.window + 1) : kv_begin) / ROWS *
      ROWS;
  const int ntiles = hi > lo ? (hi - lo + ROWS - 1) / ROWS : 0;
  auto load = [&](int t, int st) {  // key tile t: keys [lo + t ROWS, + ROWS)
    hx::mbar_arrive_tx(&ring.full[st], 2 * S::T);
#pragma unroll
    for (int c = 0; c < G::NCH; ++c) {
      hx::tma_load_4d(smem + S::K + (size_t)st * S::T + c * ROWS * G::ROWB,
                      &tmk, &ring.full[st], c * G::CH, kvh, lo + t * ROWS,
                      bi);
      hx::tma_load_4d(smem + S::V + (size_t)st * S::T + c * ROWS * G::ROWB,
                      &tmv, &ring.full[st], c * G::CH, kvh, lo + t * ROWS,
                      bi);
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hx::mbar_init(&ring.full[s], 1);
      hx::mbar_init(&ring.empty[s], 4 * NC);
    }
    hx::mbar_init(qbar, 1);
    hx::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hx::mbar_arrive_tx(qbar, 2 * NC * p.P * p.g * D * 2);
    for (int w = 0; w < NC; ++w) {
#pragma unroll
      for (int c = 0; c < G::NCH; ++c) {
        const size_t off = (size_t)w * S::T + c * ROWS * G::ROWB;
        hx::tma_load_4d(smem + S::Q + off, &tmq, qbar, c * G::CH, kvh * p.g,
                        pos0 + w * p.P, bi);
        hx::tma_load_4d(smem + S::DO + off, &tmdo, qbar, c * G::CH,
                        kvh * p.g, pos0 + w * p.P, bi);
      }
    }
    for (int t = 0; t < min(STAGES - 1, ntiles); ++t) load(t, t);
  }

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, tq = lane % 4;
  const int ra = warp * 16 + lane / 4;  // accumulator rows ra, ra + 8
  const int pw = pos0 + wg * p.P;       // this warpgroup's first position
  const int last_w = min(pw + p.P, p.sq) - 1;
  const unsigned char* qt = smem + S::Q + (size_t)wg * S::T;
  const unsigned char* dt = smem + S::DO + (size_t)wg * S::T;
  // each row's stats and the keys it sees, [a, b) (empty for a row past
  // the warpgroup's P g or past sq)
  float lse2[2], delta[2];
  int qpos[2], ka[2], kb[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ra + 8 * h;
    qpos[h] = pw + r / p.g;
    const bool live = r < p.P * p.g && qpos[h] < p.sq;
    float2 x = make_float2(0.f, 0.f);
    if (live)
      x = p.stats[(((size_t)bi * p.hkv + kvh) * p.sq + pw) * p.g + r];
    lse2[h] = x.x;
    delta[h] = x.y;
    int a = kv_begin, b = kv_end;
    if (p.causal) b = min(b, qpos[h] + 1);
    if (p.window > 0) a = max(a, qpos[h] - p.window + 1);
    ka[h] = live ? a : 0;
    kb[h] = live ? b : 0;
  }
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  hx::mbar_wait(qbar, 0);
  for (int t = 0; t < ntiles; ++t) {
    if (threadIdx.x == 0) {
      const int st = ring.next(t, ntiles);
      if (st >= 0) load(t + STAGES - 1, st);
    }
    const int stage = t % STAGES, k0 = lo + t * ROWS;
    ring.wait(t);
    const bool seen = pw < p.sq && !(p.causal && k0 > last_w) &&
                      !(p.window > 0 && k0 + ROWS <= pw - p.window + 1);
    if (seen) {
      const unsigned char* kt = smem + S::K + (size_t)stage * S::T;
      const unsigned char* vt = smem + S::V + (size_t)stage * S::T;
      float s[32], dp[32];
      scores<D>(s, dp, qt, kt, dt, vt);
      const bool full_tile =
          p.P * p.g == ROWS && last_w == pw + p.P - 1 && k0 >= kv_begin &&
          k0 + ROWS <= kv_end && (!p.causal || k0 + ROWS - 1 <= pw) &&
          (p.window <= 0 || k0 > last_w - p.window);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1;
        const int key = k0 + 8 * (i / 4) + 2 * tq + (i & 1);
        const bool ok = full_tile || (key >= ka[h] && key < kb[h]);
        const float pv =
            ok ? fa::ex2(fmaf(s[i], p.scale_log2, -lse2[h])) : 0.f;
        dp[i] = pv * (dp[i] - delta[h]) * p.scale;
      }
      // dS as bf16 A fragments: dQ += dS K, K through its transposing
      // descriptor
      uint32_t df[4][4];
      fa::pack_p<ROWS>(df, dp);
      fa::issue_pv<D, ROWS>(dq, df, kt);
      hx::wgmma_wait<0>();
      hx::fence_regs(dq);
    }
    ring.release(t, lane);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ra + 8 * h;
    if (r >= p.P * p.g || qpos[h] >= p.sq) continue;
    store_rows<D>(p.dq + (((size_t)bi * p.sq + qpos[h]) * p.hq + kvh * p.g +
                          r % p.g) * D,
                  dq, h, tq);
  }
}

template <int D>
cudaError_t launch(Params p, const void* q, const void* k, const void* v,
                   cudaStream_t st) {
  using G = Geo<D>;
  CUtensorMap tmq, tmdo, tmk, tmv;
  cudaError_t e = hx::bf16_map_4d(&tmq, q, D, p.hq, p.sq, p.b, G::CH, p.g,
                                  p.P, 1, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess)
    e = hx::bf16_map_4d(&tmdo, p.dout, D, p.hq, p.sq, p.b, G::CH, p.g, p.P,
                        1, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess)
    e = hx::bf16_map_4d(&tmk, k, D, p.hkv, p.skv, p.b, G::CH, 1, ROWS, 1,
                        CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess)
    e = hx::bf16_map_4d(&tmv, v, D, p.hkv, p.skv, p.b, G::CH, 1, ROWS, 1,
                        CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dkdv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SmemKV<D>::BYTES);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SmemQ<D>::BYTES);
  if (e != cudaSuccess) return e;
  const int64_t rows = (int64_t)p.b * p.sq * p.hq;
  constexpr int RPB = 256 / (D / 8);
  stats_kernel<D><<<(unsigned)((rows + RPB - 1) / RPB), 256, 0, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dkdv_kernel<D><<<dim3(p.hkv, p.b, (p.skv + NC * ROWS - 1) / (NC * ROWS)),
                   THREADS, SmemKV<D>::BYTES, st>>>(p, tmq, tmdo, tmk, tmv);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dq_kernel<D><<<dim3(p.hkv, p.b, (p.sq + NC * p.P - 1) / (NC * p.P)),
                 THREADS, SmemQ<D>::BYTES, st>>>(p, tmq, tmdo, tmk, tmv);
  return cudaGetLastError();
}

cudaError_t run(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* scratch, void* dq,
                void* dk, void* dv, const int* kv_len, const int* kv_start,
                int b, int sq, int skv, int hq, int hkv, int d, int causal,
                int window, float scale, cudaStream_t st) {
  Params p{};
  p.o = static_cast<const bf16*>(o);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = lse;
  p.stats = reinterpret_cast<float2*>(scratch);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.kv_len = kv_len;
  p.kv_start = kv_start;
  p.b = b;
  p.sq = sq;
  p.skv = skv;
  p.hq = hq;
  p.hkv = hkv;
  p.g = hq / hkv;
  p.P = ROWS / p.g;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  return d == 64 ? launch<64>(p, q, k, v, st) : launch<128>(p, q, k, v, st);
}

}  // namespace fbh

// dtype: 0 float32, 1 bfloat16 (kernels/flash_attention.DTYPES). delta is
// fp32 scratch of 2 b hq sq + 256 floats (the SIMT body uses the first b
// hq sq as D (b, hq, sq); the tensor-core body 2 b hq sq as the rows'
// stats, and its tiles' 16-byte aligned windows reach past them, into
// the 256 floats that its pass 1 zeroes).
// Returns a cudaError_t.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, const int* kv_len, const int* kv_start, int b, int sq, int skv,
    int hq, int hkv, int d, int causal, int window, float scale, int dtype,
    void* stream) {
  if (hkv <= 0 || hq % hkv != 0) return (int)cudaErrorInvalidValue;
  fb::Params p{q,  k,      v,        o, dout, lse, delta, dq, dk,
               dv, kv_len, kv_start, b, sq,   skv, hq,    hkv};
  p.g = hq / hkv;
  p.causal = causal;
  p.scale = scale;
  p.window = window;
  cudaStream_t st = (cudaStream_t)stream;
  // bf16 at d 64 and 128 with whole GQA groups in a 64-row warpgroup (every
  // group the forward takes) runs on the tensor cores
  if (dtype == 1 && (d == 64 || d == 128) && p.g <= fbh::ROWS)
    return (int)fbh::run(q, k, v, o, dout, lse, delta, dq, dk, dv, kv_len,
                         kv_start, b, sq, skv, hq, hkv, d, causal, window,
                         scale, st);
  if (dtype == 0) return (int)fb::by_d<float>(p, d, st);
  if (dtype == 1) return (int)fb::by_d<__nv_bfloat16>(p, d, st);
  return (int)cudaErrorInvalidValue;
}
