// Selective scan backward for Hopper (sm_90a): the gradient of #9.
//
// Replaces: src/repro/kernels/ops.py:_ssm_chunks_bwd, the hand-written VJP
// the reference wraps around its chunked scan (an XLA custom VJP, not a
// Pallas kernel; the forward's TPU kernel is ssm_scan_pallas), plus the
// D x term the reference differentiates outside it. With the forward
//   h[t] = a[t] h[t-1] + dt[t] x[t] B[t],  a[t] = exp(dt[t] A)
//   y[t] = h[t] . C[t] + D x[t]
// and the state entering every CHUNK-step chunk, h_ins (b, nc, din, ds) fp32
// (ssm_scan.cu's STATES instances), the chunks run last to first: each
// recomputes its states from its entry state, and the state cotangent
//   lam[t] = dy[t] C[t] + a[t+1] lam[t+1]     (lam after the last step:
//                                              dh_out, or zeros)
// runs back through it, giving
//   dx[t]  = sum_n lam dt B + dy D          ddt[t] = sum_n (lam h[t-1] a A
//                                                    + lam x B)
//   dB[t]  = sum_d lam dt x                 dC[t]  = sum_d dy h[t]
//   dA     = sum_{b,t} lam h[t-1] a dt      dD     = sum_{b,t} dy x
//   dh0    = a[0] lam[0]
// x, dt, dy (b, s, din) in fp32 or bf16 (x's and dt's dtypes), B, C
// (b, s, ds) of x's dtype, A (din, ds), D (din,) fp32; dx, ddt, dB, dC in
// their inputs' dtypes, dA, dD, dh0 fp32.
//
// Bound on the card: like the forward, the exponentials (one per state
// element and step at least, a[t]) against ~28 bytes of traffic per
// (row, step, channel); and the recurrence's latency, which the design
// has to hide.
//
// Design, as the forward (ssm_scan.cu):
//   - The state split over lanes: 2 neighbouring lanes share a channel,
//     each holding ds / 2 consecutive state elements, so a 128-thread
//     block covers 64 channels of one row in one pass over time (grid
//     (ceil(din / 64), b): 512 blocks at b 4 and d_inner 8192). The sums
//     over n (dx, ddt) take one shuffle level; the sums over din (dB, dC)
//     go through shared memory to one partial per (block, t, n); the sums
//     over b and s (dA, dD) stay in registers and leave as per-row
//     partials. A second kernel adds the partials in a fixed order: no
//     atomics, so the gradients are the same bits from run to run.
//   - Inputs staged a tile ahead: time runs in 16-step tiles; x, dt, dy of
//     the block's channels and B, C of the row (widened to fp32) of the
//     next tile are issued by cp.async (16 bytes a copy, zero-filled past s
//     and din) before the current tile's arithmetic, so the recurrence
//     reads shared memory, never device memory. Rows that miss the copies'
//     16-byte alignment take element-wise loads. A chunk's tiles are
//     visited twice: forwards (the checkpoints), then backwards.
//   - The states three levels deep: a chunk's forward walk keeps the
//     state entering each 16-step piece (8 of them, in shared memory: 64
//     registers a thread at d_state 16 would not fit beside the rest); a
//     piece, last first, is walked again keeping the state entering each
//     4-step sub-piece in registers; a sub-piece, last first, is
//     recomputed keeping h[t] and a[t] of its 4 steps, and walked back
//     with those a[t]. That is three exponentials per element and step
//     (ex2.approx.ftz with dt pre-scaled by log2 e), none in the backward
//     step itself. Keeping a[t] of a whole 16-step piece instead (two
//     exponentials) would take 1 KB of shared memory a thread at d_state
//     16, 128 KB a block: one block an SM.
// Steps past s run on zero-filled inputs (dt = 0: a = 1, no input), which
// change no state, cotangent or sum; their outputs are not written.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace sb {

constexpr int THREADS = 256;  // the reduction's block
constexpr int CHUNK = 128;           // steps between saved states
constexpr float LOG2E = 1.4426950408889634f;

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

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

template <typename TX, typename TDT>
struct Params {
  const TX* x;
  const TDT* dt;
  const float* A;
  const TX* B;
  const TX* C;
  const float* D;
  const float* h_ins;   // (b, nc, din, ds)
  const TX* dy;         // (b, s, din)
  const float* dh_out;  // (b, din, ds) or null
  TX* dx;
  TDT* ddt;
  float* dh0;           // (b, din, ds)
  float* dA_part;       // (b, din, ds): dA of each row
  float* dD_part;       // (b, din): dD of each row
  float* dB_part;       // (b, nblk, s, ds): dB of each block's channels
  float* dC_part;       // (b, nblk, s, ds)
  int s, din, nc, nblk;
};


constexpr int TS = 16;         // steps a tile (a piece)
constexpr int SUBS = 4;        // steps a sub-piece
constexpr int NPIECE = CHUNK / TS;
constexpr int LANES = 2;       // lanes a channel (ss::lanes)
constexpr int BT = 128;        // threads a block
constexpr int CH = BT / LANES; // channels a block

// Parts of ssm_bwd_lanes that a build may leave out, to time what each
// costs (scripts/ssm_scan_bwd_parts.py; the gradients are then wrong):
// a bit mask of the chunk's forward walk (1), the piece's walk to its
// sub-pieces (2), the sub-pieces' recompute and backward step (4), the
// dB / dC sum over the block's channels (8) and the barrier before it
// (16). 0, every part, unless the build defines it.
#ifndef SB_SKIP
#define SB_SKIP 0
#endif
constexpr int SKIP = SB_SKIP;

// A thread's 16-byte pieces of a [TS][CH] tile of T: piece q of the
// tile's TS * PER_ROW is at step q / PER_ROW, channel (q % PER_ROW) E
template <typename T>
struct Pieces {
  static constexpr int E = 16 / sizeof(T), PER_ROW = CH / E,
                       ALL = TS * PER_ROW, N = (ALL + BT - 1) / BT;
};

// Steps [t0, t0 + nt) of channels [c0, c0 + CH) of a (b, s, din) tensor
// (its element `base` is (row, t0, 0)) into dst[TS][CH]; zeros past s and
// din. cp.async when every 16-byte piece is aligned and wholly inside or
// outside din (vec), else element-wise loads.
template <typename T>
__device__ __forceinline__ void load_steps(T (&dst)[TS][CH],
                                           const T* __restrict__ src,
                                           size_t base, int nt, int c0,
                                           int din, bool vec) {
  using P = Pieces<T>;
  if (vec) {
    const T* tile = src + base + c0;
#pragma unroll
    for (int i = 0; i < P::N; ++i) {
      const int q = threadIdx.x + i * BT;
      const int tt = q / P::PER_ROW, c = (q % P::PER_ROW) * P::E;
      const bool in = tt < nt && c0 + c < din;
      if (P::ALL % BT == 0 || q < P::ALL)
        hx::cp_async16(&dst[tt][c], in ? tile + (size_t)tt * din + c : src,
                       in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < TS * CH; i += BT) {
      const int tt = i / CH, c = i % CH;
      dst[tt][c] = (tt < nt && c0 + c < din)
                       ? src[base + (size_t)tt * din + c0 + c]
                       : from_f<T>(0.f);
    }
  }
}

// nt steps of B or C (DS values each, contiguous from `off`) into dst;
// zeros past them
template <int DS, typename T>
__device__ __forceinline__ void load_bc(T (&dst)[TS * DS],
                                        const T* __restrict__ src, size_t off,
                                        int nt) {
  constexpr int E = 16 / sizeof(T), N = TS * DS;
  const int n = nt * DS;
  if (reinterpret_cast<uintptr_t>(src + off) % 16 == 0) {
    for (int i = threadIdx.x * E; i < N; i += BT * E) {
      const int bytes = min(E, max(n - i, 0)) * (int)sizeof(T);
      hx::cp_async16(&dst[i], bytes ? src + off + i : src, bytes);
    }
  } else {
    for (int i = threadIdx.x; i < N; i += BT)
      dst[i] = i < n ? src[off + i] : from_f<T>(0.f);
  }
}

// K consecutive floats from shared memory as 16- or 8-byte vectors
template <int K>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int j = 0; j < K; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + j);
      v[j] = q.x, v[j + 1] = q.y, v[j + 2] = q.z, v[j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; j += 2) {
      const float2 q = *reinterpret_cast<const float2*>(p + j);
      v[j] = q.x, v[j + 1] = q.y;
    }
  }
}
template <int K>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int j = 0; j < K; j += 4)
      *reinterpret_cast<float4*>(p + j) =
          make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < K; j += 2)
      *reinterpret_cast<float2*>(p + j) = make_float2(v[j], v[j + 1]);
  }
}

template <int DS, typename TX, typename TDT>
struct Smem {
  alignas(16) TX x[2][TS][CH];
  alignas(16) TDT dt[2][TS][CH];
  alignas(16) TX dy[2][TS][CH];
  alignas(16) TX bc_raw[2][2][TS * DS];  // B, C of a tile as stored
  alignas(16) float bc[2][TS][DS];       // the current tile's, in fp32
  // a sub-piece's dB and dC terms of every (step, channel, element),
  // summed over the channels after each sub-piece
  alignas(16) float red[2][SUBS][CH][DS];
  // each thread's state entering each piece of the chunk
  alignas(16) float cp[NPIECE][BT][DS / LANES];
};

template <int DS, typename TX, typename TDT>
__global__ void __launch_bounds__(BT, 2)
    ssm_bwd_lanes(const Params<TX, TDT> p) {
  using S = Smem<DS, TX, TDT>;
  constexpr int K = DS / LANES;
  extern __shared__ __align__(16) unsigned char smem[];
  S& sm = *reinterpret_cast<S*>(smem);
  const int row = blockIdx.y, blk = blockIdx.x;
  const int g = threadIdx.x / LANES, part = threadIdx.x % LANES;
  const int c0 = blk * CH, c = c0 + g;
  const bool live = c < p.din;
  const int s = p.s, din = p.din;
  const size_t xrow = (size_t)row * s * din, bcrow = (size_t)row * s * DS;
  const size_t st = ((size_t)row * din + c) * DS + part * K;
  float A[K], lam[K], dA[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    A[j] = live ? p.A[(size_t)c * DS + part * K + j] : 0.f;
    lam[j] = live && p.dh_out ? p.dh_out[st + j] : 0.f;
    dA[j] = 0.f;
  }
  const float dcoef = live ? p.D[c] : 0.f;
  float dD = 0.f;
  const bool vx = reinterpret_cast<uintptr_t>(p.x) % 16 == 0 &&
                  (din * sizeof(TX)) % 16 == 0;
  const bool vdt = reinterpret_cast<uintptr_t>(p.dt) % 16 == 0 &&
                   (din * sizeof(TDT)) % 16 == 0;
  const bool vdy = reinterpret_cast<uintptr_t>(p.dy) % 16 == 0 &&
                   (din * sizeof(TX)) % 16 == 0;
  float* dBp = p.dB_part + ((size_t)row * p.nblk + blk) * s * DS;
  float* dCp = p.dC_part + ((size_t)row * p.nblk + blk) * s * DS;

  // jobs: for each chunk, last first, its tiles forwards then backwards
  auto tiles = [&](int ch) {
    return (min(s, ch * CHUNK + CHUNK) - ch * CHUNK + TS - 1) / TS;
  };
  // tile start of job (ch, j) of a chunk of nt tiles, and whether it walks
  // back
  auto load = [&](int buf, int ch, int j, int nt) {
    const bool back = j >= nt;
    const int t0 = ch * CHUNK + (back ? 2 * nt - 1 - j : j) * TS;
    const int n = min(TS, s - t0);
    const size_t base = xrow + (size_t)t0 * din;
    load_steps(sm.x[buf], p.x, base, n, c0, din, vx);
    load_steps(sm.dt[buf], p.dt, base, n, c0, din, vdt);
    load_bc<DS>(sm.bc_raw[buf][0], p.B, bcrow + (size_t)t0 * DS, n);
    if (back) {
      load_steps(sm.dy[buf], p.dy, base, n, c0, din, vdy);
      load_bc<DS>(sm.bc_raw[buf][1], p.C, bcrow + (size_t)t0 * DS, n);
    }
  };

  float h[K];
  float* cp = &sm.cp[0][threadIdx.x][0];  // piece q's entry: cp + q BT K
  int ch = p.nc - 1, nt = tiles(ch), j = 0, buf = 0;
  load(0, ch, 0, nt);
  for (;;) {
    hx::cp_async_wait_all();
    __syncthreads();  // job (ch, j)'s tile is in; the other buffer is free
    {
      int ch2 = ch, j2 = j + 1, nt2 = nt;
      if (j2 == 2 * nt) {
        --ch2;
        j2 = 0;
        nt2 = ch2 >= 0 ? tiles(ch2) : 0;
      }
      if (ch2 >= 0) load(buf ^ 1, ch2, j2, nt2);
    }
    const bool back = j >= nt;
    const int piece = back ? 2 * nt - 1 - j : j;
    const int t0 = ch * CHUNK + piece * TS;
    // B (and C) of the tile, widened to fp32
    for (int i = threadIdx.x; i < (back ? 2 : 1) * TS * DS; i += BT)
      (&sm.bc[0][0][0])[i] = to_f((&sm.bc_raw[buf][0][0])[i]);
    __syncthreads();
    const TX* xs = &sm.x[buf][0][g];
    const TDT* dts = &sm.dt[buf][0][g];
    const float* bs = &sm.bc[0][0][part * K];
    // one step forwards: h = a h + dt x B, a = 2^(dt log2 e A)
    auto step = [&](int tt, float (&hh)[K], float (&a)[K]) {
      float bv[K];
      load_vec<K>(bs + tt * DS, bv);
      const float dtv = to_f(dts[tt * CH]), dtx = dtv * to_f(xs[tt * CH]);
      const float dtl = dtv * LOG2E;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        a[k] = ex2(dtl * A[k]);
        hh[k] = fmaf(a[k], hh[k], dtx * bv[k]);
      }
    };
    if (!back) {
      if (piece == 0) {  // the chunk's entry state
#pragma unroll
        for (int k = 0; k < K; ++k)
          h[k] = live ? p.h_ins[(((size_t)row * p.nc + ch) * din + c) * DS +
                                part * K + k]
                      : 0.f;
      }
      store_vec<K>(cp + piece * BT * K, h);
      float a[K];
      // nothing reads the state after the last piece
      if (!(SKIP & 1) && piece < nt - 1) {
#pragma unroll 4
        for (int tt = 0; tt < TS; ++tt) step(tt, h, a);
      }
    } else {
      load_vec<K>(cp + piece * BT * K, h);
      // the state entering each sub-piece
      float sub[TS / SUBS][K];
#pragma unroll
      for (int q = 0; q < TS / SUBS; ++q) {
#pragma unroll
        for (int k = 0; k < K; ++k) sub[q][k] = h[k];
        float a[K];
        if (!(SKIP & 2) && q < TS / SUBS - 1) {  // ... nor after the last
#pragma unroll
          for (int i = 0; i < SUBS; ++i) step(q * SUBS + i, h, a);
        }
      }
      const TX* dys = &sm.dy[buf][0][g];
      const float* cs = &sm.bc[1][0][part * K];
#pragma unroll
      for (int q = TS / SUBS - 1; q >= 0; --q) {
        // h[t] and a[t] of the sub-piece's steps
        float hs[SUBS][K], as[SUBS][K];
#pragma unroll
        for (int k = 0; k < K; ++k) h[k] = sub[q][k];
#pragma unroll
        for (int i = 0; i < SUBS; ++i) {
          step(q * SUBS + i, h, as[i]);
#pragma unroll
          for (int k = 0; k < K; ++k) hs[i][k] = h[k];
        }
#pragma unroll
        for (int i = SUBS - 1; !(SKIP & 4) && i >= 0; --i) {
          const int tt = q * SUBS + i, t = t0 + tt;
          float bv[K], cv[K], gb[K], gc[K];
          load_vec<K>(bs + tt * DS, bv);
          load_vec<K>(cs + tt * DS, cv);
          const float dtv = to_f(dts[tt * CH]), xv = to_f(xs[tt * CH]);
          const float dyv = to_f(dys[tt * CH]), dtx = dtv * xv;
          float sa = 0.f, sg = 0.f;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float hp = i > 0 ? hs[i - 1][k] : sub[q][k];
            lam[k] = fmaf(dyv, cv[k], lam[k]);  // the cotangent of h[t]
            const float da = lam[k] * hp * as[i][k];  // through a[t]
            dA[k] = fmaf(da, dtv, dA[k]);
            sa = fmaf(da, A[k], sa);
            sg = fmaf(lam[k], bv[k], sg);  // through dt x
            gb[k] = lam[k] * dtx;
            gc[k] = dyv * hs[i][k];
            lam[k] *= as[i][k];
          }
          store_vec<K>(&sm.red[0][i][g][part * K], gb);
          store_vec<K>(&sm.red[1][i][g][part * K], gc);
          sa += __shfl_xor_sync(0xffffffffu, sa, 1);
          sg += __shfl_xor_sync(0xffffffffu, sg, 1);
          if (part == 0 && live && t < s) {
            const size_t o = xrow + (size_t)t * din + c;
            p.dx[o] = from_f<TX>(fmaf(dtv, sg, dyv * dcoef));
            p.ddt[o] = from_f<TDT>(fmaf(xv, sg, sa));
            dD = fmaf(dyv, xv, dD);
          }
        }
        if (!(SKIP & 16)) __syncthreads();
        // dB, dC of the sub-piece's steps summed over the block's
        // channels, in order, into the block's partials
        for (int o = threadIdx.x; !(SKIP & 8) && o < 2 * SUBS * DS;
             o += BT) {
          const int w = o / (SUBS * DS), i = (o / DS) % SUBS, n = o % DS;
          const int t = t0 + q * SUBS + i;
          // four chains of 16, not one of 64: the adds' latency
          float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int gg = 0; gg < CH; ++gg) sum[gg % 4] += sm.red[w][i][gg][n];
          if (t < s)
            (w ? dCp : dBp)[(size_t)t * DS + n] =
                (sum[0] + sum[1]) + (sum[2] + sum[3]);
        }
        __syncthreads();
      }
    }
    if (++j == 2 * nt) {
      if (--ch < 0) break;
      j = 0;
      nt = tiles(ch);
    }
    buf ^= 1;
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      p.dh0[st + k] = lam[k];
      p.dA_part[st + k] = dA[k];
    }
    if (part == 0) p.dD_part[(size_t)row * din + c] = dD;
  }
}

// the partials summed in a fixed order: dB, dC (b, s, ds) over the blocks,
// dA (din, ds) and dD (din,) over the rows
template <typename TX, typename TDT>
__global__ void __launch_bounds__(THREADS)
    ssm_bwd_reduce(const Params<TX, TDT> p, int b, int ds, TX* dB, TX* dC,
                   float* dA, float* dD) {
  const int64_t nbc = (int64_t)b * p.s * ds, na = (int64_t)p.din * ds;
  const int64_t total = nbc + na + p.din;
  for (int64_t i = blockIdx.x * (int64_t)THREADS + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * THREADS) {
    if (i < nbc) {
      const int64_t row = i / ((int64_t)p.s * ds), r = i % ((int64_t)p.s * ds);
      float sb = 0.f, sc = 0.f;
      for (int k = 0; k < p.nblk; ++k) {
        const int64_t o = (row * p.nblk + k) * p.s * ds + r;
        sb += p.dB_part[o];
        sc += p.dC_part[o];
      }
      dB[i] = from_f<TX>(sb);
      dC[i] = from_f<TX>(sc);
    } else if (i < nbc + na) {
      const int64_t j = i - nbc;
      float sa = 0.f;
      for (int r = 0; r < b; ++r) sa += p.dA_part[r * na + j];
      dA[j] = sa;
    } else {
      const int64_t j = i - nbc - na;
      float sd = 0.f;
      for (int r = 0; r < b; ++r) sd += p.dD_part[r * (int64_t)p.din + j];
      dD[j] = sd;
    }
  }
}

// dB / dC partials a row: one per block of CH channels
inline int blocks_a_row(int din) { return (din + CH - 1) / CH; }

template <int DS, typename TX, typename TDT>
cudaError_t launch(Params<TX, TDT> p, int b, TX* dB, TX* dC, float* dA,
                   float* dD, cudaStream_t st) {
  p.nblk = blocks_a_row(p.din);
  constexpr int SMEM = sizeof(Smem<DS, TX, TDT>);
  auto kernel = ssm_bwd_lanes<DS, TX, TDT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(p.nblk, b), BT, SMEM, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int64_t total = (int64_t)b * p.s * DS + (int64_t)p.din * DS + p.din;
  const int blocks = (int)min((total + THREADS - 1) / THREADS, (int64_t)1024);
  ssm_bwd_reduce<TX, TDT><<<blocks, THREADS, 0, st>>>(p, b, DS, dB, dC, dA,
                                                        dD);
  return cudaGetLastError();
}

template <typename TX, typename TDT>
cudaError_t by_ds(Params<TX, TDT> p, int b, int ds, void* dB, void* dC,
                  float* dA, float* dD, cudaStream_t st) {
  switch (ds) {
    case 4:
      return launch<4>(p, b, (TX*)dB, (TX*)dC, dA, dD, st);
    case 8:
      return launch<8>(p, b, (TX*)dB, (TX*)dC, dA, dD, st);
    case 16:
      return launch<16>(p, b, (TX*)dB, (TX*)dC, dA, dD, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TX, typename TDT>
cudaError_t run(const void* const* in, void* const* out, float* const* part,
                int b, int s, int din, int ds, cudaStream_t st) {
  Params<TX, TDT> p{};
  p.x = (const TX*)in[0];
  p.dt = (const TDT*)in[1];
  p.A = (const float*)in[2];
  p.B = (const TX*)in[3];
  p.C = (const TX*)in[4];
  p.D = (const float*)in[5];
  p.h_ins = (const float*)in[6];
  p.dy = (const TX*)in[7];
  p.dh_out = (const float*)in[8];
  p.dx = (TX*)out[0];
  p.ddt = (TDT*)out[1];
  p.dh0 = (float*)out[6];
  p.dA_part = part[0];
  p.dD_part = part[1];
  p.dB_part = part[2];
  p.dC_part = part[3];
  p.s = s;
  p.din = din;
  p.nc = (s + CHUNK - 1) / CHUNK;
  return by_ds(p, b, ds, out[3], out[4], (float*)out[2], (float*)out[5], st);
}

}  // namespace sb

// in: x, dt, A, B, C, D, h_ins, dy, dh_out (null: zeros); out: dx, ddt, dA,
// dB, dC, dD, dh0; part: fp32 scratch of ssm_scan_bwd_scratch floats (the
// dA, dD, dB and dC partials, in that order). dtype codes: 0 float32,
// 1 bfloat16 (kernels/flash_attention.DTYPES). Returns a cudaError_t.
extern "C" int ssm_scan_bwd(const void* const* in, void* const* out,
                            float* scratch, int b, int s, int din, int ds,
                            int x_dtype, int dt_dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (ds != 4 && ds != 8 && ds != 16) return (int)cudaErrorInvalidValue;
  const size_t nblk = sb::blocks_a_row(din);
  float* part[4] = {scratch, scratch + (size_t)b * din * ds,
                    scratch + (size_t)b * din * (ds + 1),
                    scratch + (size_t)b * din * (ds + 1) +
                        (size_t)b * nblk * s * ds};
  if (x_dtype == 0 && dt_dtype == 0)
    return (int)sb::run<float, float>(in, out, part, b, s, din, ds, st);
  if (x_dtype == 0 && dt_dtype == 1)
    return (int)sb::run<float, __nv_bfloat16>(in, out, part, b, s, din, ds,
                                              st);
  if (x_dtype == 1 && dt_dtype == 0)
    return (int)sb::run<__nv_bfloat16, float>(in, out, part, b, s, din, ds,
                                              st);
  if (x_dtype == 1 && dt_dtype == 1)
    return (int)sb::run<__nv_bfloat16, __nv_bfloat16>(in, out, part, b, s,
                                                      din, ds, st);
  return (int)cudaErrorInvalidValue;
}

// floats of fp32 scratch ssm_scan_bwd needs at (b, s, din, ds)
extern "C" long long ssm_scan_bwd_scratch(int b, int s, int din, int ds) {
  if (ds != 4 && ds != 8 && ds != 16) return -1;
  const long long nblk = sb::blocks_a_row(din);
  return (long long)b * din * (ds + 1) + 2LL * b * nblk * s * ds;
}
