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
// Design. A thread holds one state element (channel, n): a block of 256
// threads is 256 / ds channels of one row at a time and walks a run of
// such channel groups in turn (cpb channels a block), so the sums over
// din (dB, dC) leave the block as one partial per (block, t, n). A chunk's
// 128 states do not fit beside the inputs for many channels (8 KB a
// channel at ds 16), so the chunk is sub-checkpointed: one pass from its
// entry state keeps the state at every SUB-th step in registers, then each
// SUB-step piece, last first, is recomputed into shared memory and walked
// back. The sums over n (dx, ddt) are shuffles among the ds lanes of a
// channel; the sums over din (dB, dC) go through shared memory; the sums
// over b and s (dA, dD) stay in registers and leave as per-row partials.
// A second kernel adds the partials in a fixed order: no atomics, so the
// gradients are the same bits from run to run.
//
// Bound on the card: like the forward, the exponentials: one per state
// element and step at least (a[t]); this kernel evaluates three (the
// sub-checkpoint pass, the recompute, the backward step), each on the SFU
// (ex2.approx.ftz with A pre-scaled by log2 e, as the forward).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace sb {

constexpr int THREADS = 256;
constexpr int CHUNK = 128;           // steps between saved states
constexpr int SUB = 16;              // steps recomputed at a time
constexpr int NSUB = CHUNK / SUB;    // sub-checkpoints a chunk
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
  int s, din, nc, cpb, nblk;
};

template <int DS, typename TX, typename TDT>
__global__ void __launch_bounds__(THREADS)
    ssm_bwd_kernel(const Params<TX, TDT> p) {
  constexpr int CP = THREADS / DS;  // channels a group
  __shared__ float H[SUB][THREADS];  // the piece's states h[t]
  __shared__ float G[SUB][THREADS];  // lam dt x of each element (dB)
  __shared__ float Y[SUB][CP];       // dy of the piece's channels (dC)
  const int row = blockIdx.y, blk = blockIdx.x;
  const int lc = threadIdx.x / DS, n = threadIdx.x % DS;
  const int s = p.s, din = p.din;
  const size_t xrow = (size_t)row * s * din, brow = (size_t)row * s * DS;
  float* dBp = p.dB_part + ((size_t)row * p.nblk + blk) * s * DS;
  float* dCp = p.dC_part + ((size_t)row * p.nblk + blk) * s * DS;

  for (int g0 = 0; g0 < p.cpb; g0 += CP) {
    const int c = blk * p.cpb + g0 + lc;
    const bool live = g0 + lc < p.cpb && c < din;
    const size_t st = ((size_t)row * din + c) * DS + n;
    const float a = live ? p.A[(size_t)c * DS + n] : 0.f, a2 = a * LOG2E;
    const float dcoef = live ? p.D[c] : 0.f;
    float lam = live && p.dh_out ? p.dh_out[st] : 0.f;
    float dA = 0.f, dD = 0.f;
    // inputs of step t of this thread's channel and state element; zeros
    // for a dead channel, whose state then stays 0
    auto in = [&](int t, float& xv, float& dtv, float& bv) {
      xv = live ? to_f(p.x[xrow + (size_t)t * din + c]) : 0.f;
      dtv = live ? to_f(p.dt[xrow + (size_t)t * din + c]) : 0.f;
      bv = to_f(p.B[brow + (size_t)t * DS + n]);
    };
    for (int ch = p.nc - 1; ch >= 0; --ch) {
      const int t0 = ch * CHUNK, t1 = min(s, t0 + CHUNK);
      float h = live ? p.h_ins[(((size_t)row * p.nc + ch) * din + c) * DS + n]
                     : 0.f;
      float hs[NSUB];  // the state entering each piece
#pragma unroll
      for (int j = 0; j < NSUB; ++j) {
        hs[j] = h;
        const int ta = t0 + j * SUB, tb = min(t1, ta + SUB);
        for (int t = ta; t < tb; ++t) {
          float xv, dtv, bv;
          in(t, xv, dtv, bv);
          h = ex2(dtv * a2) * h + dtv * xv * bv;
        }
      }
#pragma unroll
      for (int j = NSUB - 1; j >= 0; --j) {
        const int ta = t0 + j * SUB, tb = min(t1, ta + SUB);
        if (ta >= tb) continue;  // past s: the same for the whole block
        h = hs[j];
        for (int t = ta; t < tb; ++t) {
          float xv, dtv, bv;
          in(t, xv, dtv, bv);
          h = ex2(dtv * a2) * h + dtv * xv * bv;
          H[t - ta][threadIdx.x] = h;
        }
        for (int t = tb - 1; t >= ta; --t) {
          float xv, dtv, bv;
          in(t, xv, dtv, bv);
          const float dyv =
              live ? to_f(p.dy[xrow + (size_t)t * din + c]) : 0.f;
          const float cv = to_f(p.C[brow + (size_t)t * DS + n]);
          const float hp = t > ta ? H[t - ta - 1][threadIdx.x] : hs[j];
          lam += dyv * cv;  // the cotangent of h[t]
          const float av = ex2(dtv * a2);
          const float da = lam * hp * av;  // through a[t]
          const float gx = lam * bv;       // through dt x
          float ddt = da * a + gx * xv, dx = gx * dtv;
          dA += da * dtv;
          G[t - ta][threadIdx.x] = lam * dtv * xv;
          lam *= av;
#pragma unroll
          for (int off = DS / 2; off > 0; off >>= 1) {
            dx += __shfl_xor_sync(0xffffffffu, dx, off);
            ddt += __shfl_xor_sync(0xffffffffu, ddt, off);
          }
          if (n == 0) {
            Y[t - ta][lc] = dyv;
            if (live) {
              p.dx[xrow + (size_t)t * din + c] = from_f<TX>(dx + dyv * dcoef);
              p.ddt[xrow + (size_t)t * din + c] = from_f<TDT>(ddt);
              dD += dyv * xv;
            }
          }
        }
        __syncthreads();
        // dB, dC of the piece's steps, summed over this group's channels
        // (a dead channel's terms are 0), into the block's partials
        for (int i = threadIdx.x; i < (tb - ta) * DS; i += THREADS) {
          const int tt = i / DS, nn = i % DS;
          float sb = 0.f, sc = 0.f;
#pragma unroll 4
          for (int k = 0; k < CP; ++k) {
            sb += G[tt][k * DS + nn];
            sc += Y[tt][k] * H[tt][k * DS + nn];
          }
          const size_t o = (size_t)(ta + tt) * DS + nn;
          dBp[o] = g0 == 0 ? sb : dBp[o] + sb;
          dCp[o] = g0 == 0 ? sc : dCp[o] + sc;
        }
        __syncthreads();
      }
    }
    if (live) {
      p.dh0[st] = lam;
      p.dA_part[st] = dA;
      if (n == 0) p.dD_part[(size_t)row * din + c] = dD;
    }
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

// channels a block: groups of 256 / ds, enough of them that a row has at
// most BLOCKS_A_ROW blocks (so the dB / dC partials stay small)
constexpr int BLOCKS_A_ROW = 64;

template <int DS>
int channels_a_block(int din) {
  constexpr int CP = THREADS / DS;
  const int groups = (din + CP * BLOCKS_A_ROW - 1) / (CP * BLOCKS_A_ROW);
  return CP * (groups > 0 ? groups : 1);
}

template <int DS, typename TX, typename TDT>
cudaError_t launch(Params<TX, TDT> p, int b, TX* dB, TX* dC, float* dA,
                   float* dD, cudaStream_t st) {
  p.cpb = channels_a_block<DS>(p.din);
  p.nblk = (p.din + p.cpb - 1) / p.cpb;
  ssm_bwd_kernel<DS, TX, TDT><<<dim3(p.nblk, b), THREADS, 0, st>>>(p);
  cudaError_t e = cudaGetLastError();
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
  int cpb;
  switch (ds) {
    case 4:
      cpb = sb::channels_a_block<4>(din);
      break;
    case 8:
      cpb = sb::channels_a_block<8>(din);
      break;
    case 16:
      cpb = sb::channels_a_block<16>(din);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  const size_t nblk = (din + cpb - 1) / cpb;
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
  int cpb;
  switch (ds) {
    case 4:
      cpb = sb::channels_a_block<4>(din);
      break;
    case 8:
      cpb = sb::channels_a_block<8>(din);
      break;
    case 16:
      cpb = sb::channels_a_block<16>(din);
      break;
    default:
      return -1;
  }
  const long long nblk = (din + cpb - 1) / cpb;
  return (long long)b * din * (ds + 1) + 2LL * b * nblk * s * ds;
}
