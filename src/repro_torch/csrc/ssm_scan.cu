// Selective scan (Mamba S6) for Hopper (sm_90a): the prefill of every Mamba
// layer.
//
// Replaces: src/repro/kernels/ssm_scan.py:ssm_scan_pallas. Computes
//   h[t] = exp(dt[t] A) * h[t-1] + (dt[t] x[t]) B[t]      (din, ds) state
//   y[t] = h[t] . C[t] + D x[t]
// over x, dt (b, s, din), A (din, ds) fp32, B, C (b, s, ds), D (din,) fp32
// and an optional fp32 initial state h0 (b, din, ds) (null: zeros); writes
// y (b, s, din) in x's dtype and the final state (b, din, ds) in fp32. Any
// s >= 1 works: the TPU kernel needed s to be a multiple of its chunk, the
// time loop here stops at s.
//
// Bound on the card: per (row, step, channel) it reads x, dt and writes y
// (8 bytes with x bf16 and dt fp32) but evaluates ds exponentials, one per
// state element. At ds = 16 that is 2 exponentials per byte, and the SFU
// issues 16 ex2 per clock per SM against ~13 bytes per clock per SM of HBM
// (3.35 TB/s over 132 SMs at 1.98 GHz), so the kernel is bound by the
// exponentials (the SFU), not by memory.
// The design keeps everything else off that path:
//   - one thread per (row, channel), so the recurrence over time is a
//     sequential loop in registers with no cross-thread reduction: the
//     thread holds its channel's h[ds] and its A row pre-scaled by log2 e,
//     so each state update costs one ex2 (exp2f) and two FMAs;
//   - a block holds 128 consecutive channels of one row (grid
//     (ceil(din / 128), b)); x, dt and y are innermost in din, so the
//     block's loads and stores of one step are coalesced;
//   - time runs in tiles of 32 steps: the tile's B and C rows (shared by
//     all channels of the row) are staged once per block in shared memory,
//     and each thread loads its 32 x and dt values into registers before
//     the tile's arithmetic, so their latency is paid once per tile.
// The state is fp32 whatever the input dtype. A chunked two-pass scan for
// small b (more blocks than rows x din / 128) and a cp.async prefetch of the
// next tile are later work; PERF.md has the measured time beside the bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace ss {

constexpr int THREADS = 128;
constexpr int TILE = 32;
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

// TX: x, B, C and y (the model dtype); TDT: dt.
template <int DS, typename TX, typename TDT>
__global__ void __launch_bounds__(THREADS)
    ssm_scan_kernel(const TX* __restrict__ x, const TDT* __restrict__ dt,
                    const float* __restrict__ A, const TX* __restrict__ B,
                    const TX* __restrict__ C, const float* __restrict__ D,
                    const float* __restrict__ h0, TX* __restrict__ y,
                    float* __restrict__ h_out, int s, int din) {
  __shared__ float Bs[TILE][DS];
  __shared__ float Cs[TILE][DS];
  const int row = blockIdx.y;
  const int c = blockIdx.x * THREADS + threadIdx.x;
  const bool live = c < din;
  const size_t state = ((size_t)row * din + c) * DS;
  float a2[DS], h[DS];
#pragma unroll
  for (int n = 0; n < DS; ++n) {
    a2[n] = live ? A[(size_t)c * DS + n] * LOG2E : 0.f;
    h[n] = (live && h0 != nullptr) ? h0[state + n] : 0.f;
  }
  const float dc = live ? D[c] : 0.f;
  const size_t base = (size_t)row * s * din + c;
  const TX* Brow = B + (size_t)row * s * DS;
  const TX* Crow = C + (size_t)row * s * DS;

  for (int t0 = 0; t0 < s; t0 += TILE) {
    const int nt = min(TILE, s - t0);
    __syncthreads();  // every thread is done with the previous tile's B, C
    for (int i = threadIdx.x; i < nt * DS; i += THREADS) {
      Bs[i / DS][i % DS] = to_f(Brow[(size_t)t0 * DS + i]);
      Cs[i / DS][i % DS] = to_f(Crow[(size_t)t0 * DS + i]);
    }
    __syncthreads();
    if (!live) continue;
    float xr[TILE], dr[TILE];
#pragma unroll
    for (int tt = 0; tt < TILE; ++tt) {
      const size_t off = base + (size_t)(t0 + tt) * din;
      xr[tt] = tt < nt ? to_f(x[off]) : 0.f;
      dr[tt] = tt < nt ? to_f(dt[off]) : 0.f;
    }
#pragma unroll
    for (int tt = 0; tt < TILE; ++tt) {
      if (tt < nt) {
        const float dx = dr[tt] * xr[tt];
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < DS; ++n) {
          h[n] = exp2f(dr[tt] * a2[n]) * h[n] + dx * Bs[tt][n];
          acc += h[n] * Cs[tt][n];
        }
        y[base + (size_t)(t0 + tt) * din] = from_f<TX>(acc + dc * xr[tt]);
      }
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < DS; ++n) h_out[state + n] = h[n];
  }
}

template <int DS, typename TX, typename TDT>
cudaError_t launch(const void* x, const void* dt, const float* A,
                   const void* B, const void* C, const float* D,
                   const float* h0, void* y, float* h_out, int b, int s,
                   int din, cudaStream_t stream) {
  dim3 grid((din + THREADS - 1) / THREADS, b);
  ssm_scan_kernel<DS, TX, TDT><<<grid, THREADS, 0, stream>>>(
      (const TX*)x, (const TDT*)dt, A, (const TX*)B, (const TX*)C, D, h0,
      (TX*)y, h_out, s, din);
  return cudaGetLastError();
}

template <int DS>
cudaError_t by_dtype(const void* x, const void* dt, const float* A,
                     const void* B, const void* C, const float* D,
                     const float* h0, void* y, float* h_out, int b, int s,
                     int din, int x_dtype, int dt_dtype,
                     cudaStream_t stream) {
  // dtype codes: 0 float32, 1 bfloat16 (kernels/flash_attention.DTYPES)
  if (x_dtype == 0 && dt_dtype == 0)
    return launch<DS, float, float>(x, dt, A, B, C, D, h0, y, h_out, b, s,
                                    din, stream);
  if (x_dtype == 0 && dt_dtype == 1)
    return launch<DS, float, __nv_bfloat16>(x, dt, A, B, C, D, h0, y, h_out,
                                            b, s, din, stream);
  if (x_dtype == 1 && dt_dtype == 0)
    return launch<DS, __nv_bfloat16, float>(x, dt, A, B, C, D, h0, y, h_out,
                                            b, s, din, stream);
  if (x_dtype == 1 && dt_dtype == 1)
    return launch<DS, __nv_bfloat16, __nv_bfloat16>(x, dt, A, B, C, D, h0, y,
                                                    h_out, b, s, din, stream);
  return cudaErrorInvalidValue;
}

}  // namespace ss

extern "C" int ssm_scan_fwd(const void* x, const void* dt, const float* A,
                            const void* B, const void* C, const float* D,
                            const float* h0, void* y, float* h_out, int b,
                            int s, int din, int ds, int x_dtype, int dt_dtype,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (ds) {
    case 4:
      return (int)ss::by_dtype<4>(x, dt, A, B, C, D, h0, y, h_out, b, s, din,
                                  x_dtype, dt_dtype, st);
    case 8:
      return (int)ss::by_dtype<8>(x, dt, A, B, C, D, h0, y, h_out, b, s, din,
                                  x_dtype, dt_dtype, st);
    case 16:
      return (int)ss::by_dtype<16>(x, dt, A, B, C, D, h0, y, h_out, b, s,
                                   din, x_dtype, dt_dtype, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
