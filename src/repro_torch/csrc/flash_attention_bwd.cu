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
// products of the pair count where five would do.
//
// Bound on the card: at training shapes the five products dominate (five
// 2 d FLOPs per visible (query, key) pair), far above the ridge, so it is
// bound by operations. This first kernel runs them on the fp32 pipes, not
// the tensor cores: a block of 256 threads as a 16 x 16 grid (ty, tx)
// owns a 32-key (pass 2) or 32-row (pass 3) tile of fp32 accumulators in
// registers, and stages Q, dO, K, V tiles as fp32 in shared memory, rows
// padded to d + 1 floats so that the column walks hit distinct banks.
// A row of a tile is one (position, query head) pair of one kv head's
// group (row r: position r / g, head kvh g + r % g), as in the forward, so
// each K / V tile serves all g heads. Masking follows repro.kernels.ref: a
// masked pair has P = 0 (and so dS = 0), never exp(S - lse) of a score
// the forward did not see. A window bounds the tiles each block walks to
// the band its rows or keys can see, so the work grows with s x window,
// not s^2. d 256 stages 140 KB of shared memory a block (Smem below),
// within the 227 KB a block may opt into.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

// dtype: 0 float32, 1 bfloat16 (kernels/flash_attention.DTYPES). delta is
// (b, hq, sq) fp32 scratch. Returns a cudaError_t.
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
  if (dtype == 0) return (int)fb::by_d<float>(p, d, st);
  if (dtype == 1) return (int)fb::by_d<__nv_bfloat16>(p, d, st);
  return (int)cudaErrorInvalidValue;
}
