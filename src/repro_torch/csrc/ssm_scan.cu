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
// time loop here stops at s. The TPU kernel walks its chunks in order on one
// core with the (d_block, ds) state in VMEM; here the parallelism is over
// (row, channel, state element) and time stays a loop in registers.
//
// Bound on the card: per (row, step, channel) it reads x, dt and writes y
// (8 bytes with x bf16 and dt fp32) but evaluates ds exponentials, one per
// state element. At ds = 16 that is 2 exponentials per byte; the SFU issues
// 16 ex2 per clock per SM (a warp's MUFU.EX2 holds its sub-partition's SFU
// 8 clocks) against ~13 bytes per clock per SM of HBM, so the exponentials
// bound the kernel. Each state element and step also needs 4 fp32
// instructions (the exponent's product, dt x B, the state's FMA, C's FMA):
// 4 issue slots a warp against the SFU's 8, and everything else a step does
// (loads, the sum over lanes, stores) has to fit in the difference. The
// design:
//   - the state split over lanes: L = 2 neighbouring lanes of a warp
//     (lanes(ds); at d_state 16 two beat four and eight from b 4 up) share
//     a channel, each holding ds / L consecutive state
//     elements and A entries pre-scaled by log2 e. A 128-thread block
//     covers 64 channels of one row (grid (ceil(din / 64), b)): at b = 1
//     and d_inner 8192, 128 blocks of 4 warps where one thread a channel
//     gave 64 blocks and left half of the 132 SMs idle, and ~94 registers
//     a thread where it took 142. A time-chunked two-pass scan would give
//     the same parallelism but evaluate every exponential twice;
//   - the sum over lanes, once per L steps: each lane keeps its partial y
//     of L consecutive steps, and a reduce-scatter of log2 L
//     __shfl_xor_sync levels (lanes L / 2 apart first) leaves step j's sum
//     on lane j: L - 1 shuffles for L steps, and each lane stores one y in
//     L. D x joins the first lane's partial;
//   - each exponential once, in fp32, on the SFU: ex2.approx.ftz.f32 by
//     inline PTX (exp2f's non-ftz form adds a compare and two scalings
//     around each MUFU.EX2; ftz flushes results below 2^-126 to zero);
//   - the next tile's loads in flight: time runs in 32-step tiles; x and dt
//     of tile t + 1 and B and C of tile t + 2 are issued by cp.async (16
//     bytes a copy, zero-filled past s and din) before tile t's arithmetic,
//     into second buffers, with one barrier a tile; B and C, shared by all
//     channels of the row, are widened to fp32 in shared memory a tile
//     ahead and read as 16-byte vectors; y goes through a shared tile of
//     its own and out as 16-byte stores a tile later. A tile past s runs
//     on zero-filled steps, which leave the state as it is. Rows that miss
//     the copies' 16-byte alignment (din not a multiple of 16 bytes, odd
//     offsets) take element-wise loads instead.
// The state is fp32 whatever the input dtype.
//
// Training's forward (STATES) also writes the state entering every CHUNK-
// step chunk, (b, ceil(s / CHUNK), din, ds) fp32, after the final state in
// h_out: the backward kernel (ssm_scan_bwd.cu) re-runs each chunk from it,
// as the reference's _ssm_chunks VJP does. Its instances are the serving
// ones' code plus those stores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace ss {

constexpr int THREADS = 128;
constexpr int TILE = 32;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int CHUNK = 128;  // steps between saved states (STATES)

// lanes that share one channel's state, per d_state (kernels/ssm_scan.py:
// LANES holds the same table): at d_state 16, 2 lanes beat 4 and 8 at b 4
// to 16 and 4 at b 1 only (scripts/ssm_scan_sweep.py --lanes, PERF.md)
constexpr int lanes(int /*ds*/) { return 2; }

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

// K consecutive floats from shared memory, as 16- or 8-byte vectors
template <int K>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int j = 0; j < K; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + j);
      v[j] = q.x, v[j + 1] = q.y, v[j + 2] = q.z, v[j + 3] = q.w;
    }
  } else {
    static_assert(K % 2 == 0, "ds / L must be even");
#pragma unroll
    for (int j = 0; j < K; j += 2) {
      const float2 q = *reinterpret_cast<const float2*>(p + j);
      v[j] = q.x, v[j + 1] = q.y;
    }
  }
}

// The group's L lanes hold partial sums p[0..L) of L consecutive steps'
// outputs; afterwards lane `part` holds step part's total. Each level
// halves the steps a lane keeps: lanes whose bit w is set keep the upper
// half, send the lower one to lane part ^ w and add what it sends back,
// so a group spends L - 1 shuffles on L steps. Step j's total is
// ((P0 + P2) + (P1 + P3)) at L = 4 (Pq: lane q's partial), P0 + P1 at 2.
template <int L>
__device__ __forceinline__ float reduce_scatter(float (&p)[L], int part) {
#pragma unroll
  for (int w = L / 2; w >= 1; w /= 2) {
    const bool hi = part & w;
#pragma unroll
    for (int i = 0; i < w; ++i) {
      const float send = hi ? p[i] : p[i + w];
      const float keep = hi ? p[i + w] : p[i];
      p[i] = keep + __shfl_xor_sync(0xffffffffu, send, w);
    }
  }
  return p[0];
}

template <int DS, int L, typename TX, typename TDT>
struct Smem {
  static constexpr int CH = THREADS / L;  // channels a block
  alignas(16) TX x[2][TILE][CH];
  alignas(16) TDT dt[2][TILE][CH];
  alignas(16) TX bc_raw[2][2][TILE * DS];  // B, C of a tile as stored
  alignas(16) float bc[2][2][TILE][DS];    // the same widened to fp32
};

// A thread's 16-byte pieces of a [TILE][CH] tile of T: piece i is q =
// threadIdx.x + i THREADS of the tile's TILE * PER_ROW, at step q / PER_ROW
// and channel (q % PER_ROW) E; N a thread, the last maybe past the tile
template <int CH, typename T>
struct Pieces {
  static constexpr int E = 16 / sizeof(T), PER_ROW = CH / E,
                       ALL = TILE * PER_ROW, N = (ALL + THREADS - 1) / THREADS;
  static __device__ __forceinline__ bool exists(int q) {
    return ALL % THREADS == 0 || q < ALL;
  }
};

// Rows [t0, t0 + nt) of channels [c0, c0 + CH) of a (b, s, din) tensor of
// row `row` (its element `base` is (row, t0, 0)) into dst[TILE][CH]; zeros
// past s and din. cp.async when every 16-byte piece is aligned and either
// wholly inside din or wholly outside (vec), else element-wise loads.
template <int CH, typename T>
__device__ __forceinline__ void load_steps(T (&dst)[TILE][CH],
                                           const T* __restrict__ src,
                                           size_t base, int nt, int c0,
                                           int din, bool vec) {
  using P = Pieces<CH, T>;
  if (vec) {
    const T* tile = src + base + c0;
#pragma unroll
    for (int i = 0; i < P::N; ++i) {
      const int q = threadIdx.x + i * THREADS;
      const int tt = q / P::PER_ROW, c = (q % P::PER_ROW) * P::E;
      const bool in = tt < nt && c0 + c < din;
      if (P::exists(q))
        hx::cp_async16(&dst[tt][c], in ? tile + tt * din + c : src,
                       in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < TILE * CH; i += THREADS) {
      const int tt = i / CH, c = i % CH;
      dst[tt][c] = (tt < nt && c0 + c < din)
                       ? src[base + (size_t)tt * din + c0 + c]
                       : T(0.f);
    }
  }
}

// The inverse of load_steps for y: rows [0, nt) of src[TILE][CH] to the
// tensor, nothing past s or din; 16-byte stores when vec.
template <int CH, typename T>
__device__ __forceinline__ void store_steps(const T (&src)[TILE][CH],
                                            T* __restrict__ dst, size_t base,
                                            int nt, int c0, int din,
                                            bool vec) {
  using P = Pieces<CH, T>;
  if (vec) {
    T* tile = dst + base + c0;
#pragma unroll
    for (int i = 0; i < P::N; ++i) {
      const int q = threadIdx.x + i * THREADS;
      const int tt = q / P::PER_ROW, c = (q % P::PER_ROW) * P::E;
      if (P::exists(q) && tt < nt && c0 + c < din)
        *reinterpret_cast<uint4*>(tile + tt * din + c) =
            *reinterpret_cast<const uint4*>(&src[tt][c]);
    }
  } else {
    for (int i = threadIdx.x; i < TILE * CH; i += THREADS) {
      const int tt = i / CH, c = i % CH;
      if (tt < nt && c0 + c < din)
        dst[base + (size_t)tt * din + c0 + c] = src[tt][c];
    }
  }
}

// nt steps of B or C (ds values each, contiguous from `off`) into dst;
// zeros past them
template <int DS, typename T>
__device__ __forceinline__ void load_bc(T (&dst)[TILE * DS],
                                        const T* __restrict__ src, size_t off,
                                        int nt) {
  constexpr int E = 16 / sizeof(T), N = TILE * DS;
  const int n = nt * DS;
  if (reinterpret_cast<uintptr_t>(src + off) % 16 == 0) {
    for (int i = threadIdx.x * E; i < N; i += THREADS * E) {
      const int bytes = min(E, max(n - i, 0)) * (int)sizeof(T);
      hx::cp_async16(&dst[i], bytes ? src + off + i : src, bytes);
    }
  } else {
    for (int i = threadIdx.x; i < N; i += THREADS)
      dst[i] = i < n ? src[off + i] : T(0.f);
  }
}

template <int DS, int L, typename TX, typename TDT>
__device__ __forceinline__ void load_tile_bc(Smem<DS, L, TX, TDT>& sm, int buf,
                                             const TX* B, const TX* C,
                                             size_t off, int nt) {
  load_bc<DS>(sm.bc_raw[buf][0], B, off, nt);
  load_bc<DS>(sm.bc_raw[buf][1], C, off, nt);
}

// 16 bytes of B or C as stored -> fp32 (bf16 widens exactly: its bits are
// the top half of the float's)
__device__ __forceinline__ void widen16(const float* raw, float* out) {
  *reinterpret_cast<float4*>(out) = *reinterpret_cast<const float4*>(raw);
}
__device__ __forceinline__ void widen16(const __nv_bfloat16* raw, float* out) {
  const uint4 q = *reinterpret_cast<const uint4*>(raw);
  auto lo = [](uint32_t w) { return __uint_as_float(w << 16); };
  auto hi = [](uint32_t w) { return __uint_as_float(w & 0xffff0000u); };
  reinterpret_cast<float4*>(out)[0] =
      make_float4(lo(q.x), hi(q.x), lo(q.y), hi(q.y));
  reinterpret_cast<float4*>(out)[1] =
      make_float4(lo(q.z), hi(q.z), lo(q.w), hi(q.w));
}

// bc_raw[buf] -> bc[buf] in fp32, 16 bytes of the raw tile a thread a pass
template <int DS, int L, typename TX, typename TDT>
__device__ __forceinline__ void widen_bc(Smem<DS, L, TX, TDT>& sm,
                                         int buf) {
  constexpr int E = 16 / sizeof(TX), N = 2 * TILE * DS;
  const TX* raw = &sm.bc_raw[buf][0][0];
  float* out = &sm.bc[buf][0][0][0];
  for (int i = threadIdx.x * E; i < N; i += THREADS * E)
    widen16(raw + i, out + i);
}

// TX: x, B, C and y (the model dtype); TDT: dt. At least 5 blocks an SM,
// as many as the d_state 16 bf16 instances' 44 KB of shared memory allow:
// ptxas then takes up to 102 registers a thread (without a minimum it
// capped some instances at 80 and spilled)
template <int DS, int L, typename TX, typename TDT, bool STATES = false>
__global__ void __launch_bounds__(THREADS, 5)
    ssm_scan_kernel(const TX* __restrict__ x, const TDT* __restrict__ dt,
                    const float* __restrict__ A, const TX* __restrict__ B,
                    const TX* __restrict__ C, const float* __restrict__ D,
                    const float* __restrict__ h0, TX* __restrict__ y,
                    float* __restrict__ h_out, int s, int din) {
  using S = Smem<DS, L, TX, TDT>;
  constexpr int CH = S::CH, K = DS / L;
  extern __shared__ __align__(16) unsigned char smem[];
  S& sm = *reinterpret_cast<S*>(smem);
  // y of a tile, written back a tile later; an array of its own, so the
  // compiler sees that its stores alias no step's loads
  __shared__ __align__(16) TX ys_[2][TILE][CH];
  const int row = blockIdx.y;
  // lane `part` of lane group g holds channel c0 + g
  const int g = threadIdx.x / L, part = threadIdx.x % L;
  const int c0 = blockIdx.x * CH, c = c0 + g;
  const bool live = c < din;
  const size_t state = ((size_t)row * din + c) * DS + part * K;
  float a2[K], h[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    a2[j] = live ? A[(size_t)c * DS + part * K + j] * LOG2E : 0.f;
    h[j] = (live && h0 != nullptr) ? h0[state + j] : 0.f;
  }
  const float dz = live && part == 0 ? D[c] : 0.f;  // D x on the first lane
  const size_t xrow = (size_t)row * s * din;
  const size_t bcrow = (size_t)row * s * DS;
  // 16-byte pieces of x, dt and y rows line up when din fills whole pieces
  const bool vx = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  (din * sizeof(TX)) % 16 == 0;
  const bool vdt = reinterpret_cast<uintptr_t>(dt) % 16 == 0 &&
                   (din * sizeof(TDT)) % 16 == 0;
  const bool vy = reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                  (din * sizeof(TX)) % 16 == 0;
  const int ntiles = (s + TILE - 1) / TILE;
  auto steps = [&](int k) { return min(TILE, s - k * TILE); };

  // prologue: x, dt and B, C of tile 0, B and C of tile 1; B, C of tile 0
  // widened before the loop
  load_steps<CH>(sm.x[0], x, xrow, steps(0), c0, din, vx);
  load_steps<CH>(sm.dt[0], dt, xrow, steps(0), c0, din, vdt);
  load_tile_bc(sm, 0, B, C, bcrow, steps(0));
  if (ntiles > 1) load_tile_bc(sm, 1, B, C, bcrow + TILE * DS, steps(1));
  hx::cp_async_wait_all();
  __syncthreads();
  widen_bc(sm, 0);

  for (int k = 0; k < ntiles; ++k) {
    const int buf = k & 1, t0 = k * TILE;
    // this thread's copies of tile k (x, dt) and k + 1 (B, C) have landed;
    // after the barrier everyone's have, B and C of tile k are widened,
    // and every buffer of tile k - 1 is free
    hx::cp_async_wait_all();
    __syncthreads();
    if (k > 0)  // y of tile k - 1, a whole tile
      store_steps<CH>(ys_[buf ^ 1], y, xrow + (size_t)(t0 - TILE) * din,
                      TILE, c0, din, vy);
    if (k + 1 < ntiles) {
      const size_t next = xrow + (size_t)(t0 + TILE) * din;
      load_steps<CH>(sm.x[buf ^ 1], x, next, steps(k + 1), c0, din, vx);
      load_steps<CH>(sm.dt[buf ^ 1], dt, next, steps(k + 1), c0, din, vdt);
    }
    if (k + 2 < ntiles)
      load_tile_bc(sm, buf, B, C, bcrow + (size_t)(t0 + 2 * TILE) * DS,
                   steps(k + 2));
    if (k + 1 < ntiles) widen_bc(sm, buf ^ 1);
    if constexpr (STATES) {  // the state entering chunk t0 / CHUNK
      if (t0 % CHUNK == 0 && live) {
        const int nc = (s + CHUNK - 1) / CHUNK;
        float* h_in = h_out + (size_t)gridDim.y * din * DS +
                      (((size_t)row * nc + t0 / CHUNK) * din + c) * DS +
                      part * K;
#pragma unroll
        for (int j = 0; j < K; ++j) h_in[j] = h[j];
      }
    }

    // all TILE steps, also past s: the copies zero-filled x, dt, B and C
    // there, and a step with dt = 0 leaves the state as it is (exp2(0) = 1,
    // dt x B = 0); store_steps drops those steps' y
    const TX* xs = &sm.x[buf][0][g];
    const TDT* dts = &sm.dt[buf][0][g];
    const float* bs = &sm.bc[buf][0][0][part * K];
    const float* cs = &sm.bc[buf][1][0][part * K];
    TX* ys = &ys_[buf][part][g];  // lane `part` stores steps part mod L
    float p[L];                   // this lane's partial y of L steps
#pragma unroll
    for (int tt = 0; tt < TILE; ++tt) {
      float bv[K], cv[K];
      load_vec<K>(bs + tt * DS, bv);
      load_vec<K>(cs + tt * DS, cv);
      const float xv = to_f(xs[tt * CH]), dv = to_f(dts[tt * CH]);
      const float dx = dv * xv;
      float acc = dz * xv;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        h[j] = ex2(dv * a2[j]) * h[j] + dx * bv[j];
        acc += h[j] * cv[j];
      }
      p[tt % L] = acc;
      if (tt % L == L - 1)
        ys[(tt - (L - 1)) * CH] = from_f<TX>(reduce_scatter<L>(p, part));
    }
  }
  __syncthreads();
  store_steps<CH>(ys_[(ntiles - 1) & 1], y,
                  xrow + (size_t)(ntiles - 1) * TILE * din, steps(ntiles - 1),
                  c0, din, vy);
  if (live) {
#pragma unroll
    for (int j = 0; j < K; ++j) h_out[state + j] = h[j];
  }
}

template <int DS, int L, typename TX, typename TDT, bool STATES>
cudaError_t launch(const void* x, const void* dt, const float* A,
                   const void* B, const void* C, const float* D,
                   const float* h0, void* y, float* h_out, int b, int s,
                   int din, cudaStream_t stream) {
  static_assert(DS % L == 0 && 32 % L == 0 && TILE % L == 0,
                "L lanes of a warp share a channel");
  constexpr int CH = THREADS / L;
  // dynamic shared memory (with ys_ above 48 KB at ds 4 and 8, x fp32)
  constexpr int SMEM = sizeof(Smem<DS, L, TX, TDT>);
  auto kernel = ssm_scan_kernel<DS, L, TX, TDT, STATES>;
  const cudaError_t opt_in = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (opt_in != cudaSuccess) return opt_in;
  dim3 grid((din + CH - 1) / CH, b);
  kernel<<<grid, THREADS, SMEM, stream>>>(
      (const TX*)x, (const TDT*)dt, A, (const TX*)B, (const TX*)C, D, h0,
      (TX*)y, h_out, s, din);
  return cudaGetLastError();
}

template <int DS, bool STATES>
cudaError_t by_dtype(const void* x, const void* dt, const float* A,
                     const void* B, const void* C, const float* D,
                     const float* h0, void* y, float* h_out, int b, int s,
                     int din, int x_dtype, int dt_dtype,
                     cudaStream_t stream) {
  constexpr int L = lanes(DS);
  // dtype codes: 0 float32, 1 bfloat16 (kernels/flash_attention.DTYPES)
  if (x_dtype == 0 && dt_dtype == 0)
    return launch<DS, L, float, float, STATES>(x, dt, A, B, C, D, h0, y,
                                               h_out, b, s, din, stream);
  if (x_dtype == 0 && dt_dtype == 1)
    return launch<DS, L, float, __nv_bfloat16, STATES>(
        x, dt, A, B, C, D, h0, y, h_out, b, s, din, stream);
  if (x_dtype == 1 && dt_dtype == 0)
    return launch<DS, L, __nv_bfloat16, float, STATES>(
        x, dt, A, B, C, D, h0, y, h_out, b, s, din, stream);
  if (x_dtype == 1 && dt_dtype == 1)
    return launch<DS, L, __nv_bfloat16, __nv_bfloat16, STATES>(
        x, dt, A, B, C, D, h0, y, h_out, b, s, din, stream);
  return cudaErrorInvalidValue;
}

template <bool STATES>
cudaError_t by_ds(const void* x, const void* dt, const float* A,
                  const void* B, const void* C, const float* D,
                  const float* h0, void* y, float* h_out, int b, int s,
                  int din, int ds, int x_dtype, int dt_dtype,
                  cudaStream_t st) {
  switch (ds) {
    case 4:
      return by_dtype<4, STATES>(x, dt, A, B, C, D, h0, y, h_out, b, s, din,
                                 x_dtype, dt_dtype, st);
    case 8:
      return by_dtype<8, STATES>(x, dt, A, B, C, D, h0, y, h_out, b, s, din,
                                 x_dtype, dt_dtype, st);
    case 16:
      return by_dtype<16, STATES>(x, dt, A, B, C, D, h0, y, h_out, b, s, din,
                                  x_dtype, dt_dtype, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace ss

// states: 0 (serving), or 1 (training: h_out (b, din, ds) is followed by
// the chunks' entry states (b, ceil(s / 128), din, ds))
extern "C" int ssm_scan_fwd(const void* x, const void* dt, const float* A,
                            const void* B, const void* C, const float* D,
                            const float* h0, void* y, float* h_out, int b,
                            int s, int din, int ds, int x_dtype, int dt_dtype,
                            int states, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(states ? ss::by_ds<true>(x, dt, A, B, C, D, h0, y, h_out, b,
                                        s, din, ds, x_dtype, dt_dtype, st)
                      : ss::by_ds<false>(x, dt, A, B, C, D, h0, y, h_out, b,
                                         s, din, ds, x_dtype, dt_dtype, st));
}

// the lanes a channel's state is split over at d_state ds (kernels/
// ssm_scan.py checks its LANES against it)
extern "C" int ssm_scan_lanes(int ds) { return ss::lanes(ds); }
