// Flash attention forward for Hopper (sm_90a), the port's cold-prefill kernel.
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention_pallas.
// Computes GQA attention q (b, sq, hq, d) x k/v (b, skv, hkv, d) with causal,
// sliding-window, kv_len and kv_start masks; sq and skv may be any length
// (the joint prefill pads prompts to multiples of 16), the ragged edges are
// masked here. Training's forward (head dims 64, 80, 128 and 256, with or
// without a sliding window) also writes each row's log-sum-exp for the
// backward kernel (flash_attention_bwd.cu), in instances of their own
// (ParamsLse, rt::AttnParamsLse), so the serving instances keep their code.
//
// Bound on the card: at prefill lengths the work is ~4 d sq skv hq / 2 FLOPs
// against O((sq + skv) d) bytes, far above the H100's ~295 FLOP/byte ridge,
// so it is bound by operations, and only wgmma reaches the tensor cores'
// full rate. The bf16 body (flash_fwd below) is warp-specialised:
//
//  - A CTA is three warpgroups. Warpgroup 0 gives its registers away
//    (setmaxnreg): one of its threads issues the TMA loads of each work
//    item's Q rows (into one of two Q buffers) and of its K and V tiles
//    (TILE_KEYS keys x d, K and V each in a ring of RING buffers with full
//    / empty mbarriers of its own, so a K tile goes back as soon as its S
//    is computed); another stores each item's O.
//    Tensor maps over the (b, s, h, d) layouts give 128-byte (64-byte at
//    d 32) swizzled tiles; rows past the tensor's end read as zeros and
//    are masked, and a store clips them.
//  - Head dim 256 (paligemma-3b) runs 32-key K/V tiles: two rings of two
//    16 KB tiles and the four 32 KB Q buffers take 192 KB of the 227 KB a
//    block may have (128-key tiles would need 384 KB). A consumer's O is
//    64 x 256 fp32, 128 registers a thread, so its Q rows stay in their
//    shared buffer and S = Q K^T takes both operands from shared memory
//    (wgmma's SS form, flash.cuh issue_qk_ss), and P V runs as two n128
//    products a k-step, one for each half of d.
//  - Head dim 80 (h2o-danube-1.8b) runs the 96-wide instance: three
//    64-byte swizzle chunks of 32 columns, whose tensor maps cover the
//    real 80 columns (160-byte rows, a multiple of 16 as TMA needs). The
//    last chunk's columns 80..95 lie past the tensor's end, so TMA fills
//    them with zeros in Q, K and V: Q K^T is exact, P V's extra columns
//    come out zero, and the O store clips them. That costs 1.2x the
//    products of a native 80-wide layout, which wgmma's k-steps of 16 and
//    the swizzle widths (32 or 64 columns) do not offer.
//  - Consumer warpgroups 1 and 2 own 64 rows each: P = 64 / g positions x
//    the g query heads of ONE kv head (row = position * g + head), so one
//    K/V tile serves all g heads (at g = 8 a 128-row CTA covers 16
//    positions). A warpgroup keeps its Q rows in registers for the item
//    (ldmatrix from the Q buffer) and runs S = Q K^T as wgmma with K from
//    shared memory, the online softmax on the accumulators (one FFMA and
//    one ex2 per score), and O += P V as wgmma with P in registers and V
//    through a transposing (MN-major) descriptor. Tile t - 1's P V is
//    issued with tile t's S, and the two warpgroups take turns at issuing,
//    so one's softmax runs while the other's products do.
//  - CTAs are persistent, one per SM. Work items (row tile, b, kv head)
//    come in sections of a few (b, kv head) pairs, so the K/V the CTAs
//    re-read stay in L2, longest causal rows first inside a section,
//    dealt to the CTAs in rounds that alternate direction, so the short
//    tail fills the card.
//
// Masking follows repro.kernels.ref: a masked score is NEG_INF, p = 0 where
// the score is <= NEG_INF / 2 (its exponent is then hugely negative), and a
// row that saw no live key writes zeros. P rounds to bf16 once before P V:
// that keeps the output within one bf16 ulp of the fp32 plain version.
// fp32 inputs (the parity path) run on the scalar body of attention.cuh.
#include <cuda_bf16.h>

#include "attention.cuh"
#include "flash.cuh"

namespace fa {

using bf16 = __nv_bfloat16;
constexpr int TILE_KEYS = 128;  // keys per K/V tile
constexpr int TILE_KEYS_256 = 32;  // ... at head dim 256
constexpr int RING = 2;         // K (and V) tiles in flight
// registers a thread: the producer warpgroup gives its to the consumers
// (PRODUCER_REGS + NC CONSUMER_REGS <= 65536 / 128)
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

struct Params {
  const int* kv_len;    // (b,) or null
  const int* kv_start;  // (b,) or null
  int b, sq, skv, hq, hkv, g, P, causal, window;
  float scale_log2;     // softmax scale * log2 e
  // work items: n_mtiles row tiles x b x hkv, in sections of `sect`
  // (b, kv head) pairs whose K/V fit the L2 cache together
  int items, n_mtiles, sect;
};

// The training instances' params (PP below): Params and the rows'
// log-sum-exp of the scaled scores, lse (b, hq, sq) fp32, m scale + log l
// (0 on a row that saw no key), which the backward kernel
// (flash_attention_bwd.cu) recomputes P from. The serving instances keep
// PP = Params and the code they had.
struct ParamsLse : Params {
  float* lse;
  float scale;
};

// One work item: positions [pos0, pos0 + NC P) of kv head kvh of row bi,
// the keys its rows may see before the causal and window limits,
// [kv_begin, kv_end), and its tiles [lo, hi).
struct Item {
  int bi, kvh, pos0, kv_begin, kv_end, lo, hi;
};

// Item t: sections of p.sect (b, kv head) pairs one after another, so the
// CTAs at work re-read K/V that the L2 cache holds, and inside a section
// the row tiles longest causal row first.
template <int BK>
__device__ __forceinline__ Item item_at(const Params& p, int t) {
  Item it;
  const int per = p.sect * p.n_mtiles, sec = t / per, base = sec * p.sect;
  const int np = min(p.sect, p.b * p.hkv - base), idx = t - sec * per;
  const int mt = p.n_mtiles - 1 - idx / np;
  const int pair = base + idx % np;
  it.bi = pair / p.hkv;
  it.kvh = pair % p.hkv;
  it.pos0 = mt * NC * p.P;
  it.kv_end = p.kv_len ? min(p.skv, p.kv_len[it.bi]) : p.skv;
  it.kv_begin = p.kv_start ? max(p.kv_start[it.bi], 0) : 0;
  const int last = min(it.pos0 + NC * p.P, p.sq) - 1;
  it.hi = p.causal ? min(it.kv_end, last + 1) : it.kv_end;
  int lo = it.kv_begin;
  if (p.window > 0) lo = max(lo, it.pos0 - p.window + 1);
  it.lo = lo / BK * BK;
  return it;
}

template <int D, int BK, int STAGES>
struct Smem {
  static constexpr int KV = BK * D * 2;  // one K (or V) tile
  static constexpr size_t K = 0;
  static constexpr size_t V = K + (size_t)STAGES * KV;
  static constexpr size_t Q = V + (size_t)STAGES * KV;  // [2][NC] buffers
  static constexpr size_t BAR = Q + (size_t)2 * NC * Geo<D>::QBYTES;
  static constexpr size_t BYTES = BAR + (4 * STAGES + 6) * 8 + 1024;
};

template <int D, int BK, int STAGES, class PP = Params>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
    flash_fwd(const PP p, const __grid_constant__ CUtensorMap tmq,
              const __grid_constant__ CUtensorMap tmk,
              const __grid_constant__ CUtensorMap tmv,
              const __grid_constant__ CUtensorMap tmo) {
  using G = Geo<D>;
  using S = Smem<D, BK, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::BAR);
  const Ring rg{bars, bars + STAGES, bars + 2 * STAGES, bars + 3 * STAGES};
  uint64_t* qfull = bars + 4 * STAGES;  // a Q buffer holds its item's Q
  uint64_t* staged = qfull + 2;         // ... its item's O
  uint64_t* qempty = staged + 2;        // ... nothing: O is stored
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hx::mbar_init(&rg.kfull[s], 1);
      hx::mbar_init(&rg.vfull[s], 1);
      hx::mbar_init(&rg.kempty[s], 4 * NC);  // one arrival per consumer warp
      hx::mbar_init(&rg.vempty[s], 4 * NC);
    }
    for (int b = 0; b < 2; ++b) {
      hx::mbar_init(&qfull[b], 1);
      hx::mbar_init(&staged[b], 4 * NC);  // one arrival per consumer warp
      hx::mbar_init(&qempty[b], 1);
    }
    hx::mbar_fence_init();
  }
  __syncthreads();

  if (wgi == 0) {
    // producer: thread 0 issues every TMA load; thread 32 (another warp)
    // stores each item's O once the consumers staged it, so no consumer
    // and no load waits for a store to read its buffer
    hx::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 32) {
      int j = 0;
      for (int r = 0; r * (int)gridDim.x < p.items; ++r) {
        const int t = item_of_round(r);
        if (t >= p.items) continue;
        const Item it = item_at<BK>(p, t);
        const int qb = j & 1;
        hx::mbar_wait(&staged[qb], (j >> 1) & 1);
        for (int w = 0; w < NC; ++w) {
          const unsigned char* o =
              smem + S::Q + (size_t)(qb * NC + w) * G::QBYTES;
#pragma unroll
          for (int c = 0; c < G::NCH; ++c)
            hx::tma_store_4d(&tmo, o + c * WG_ROWS * G::ROWB, c * G::CH,
                             it.kvh * p.g, it.pos0 + w * p.P, it.bi);
        }
        hx::bulk_commit();
        hx::bulk_wait_read();
        hx::mbar_arrive(&qempty[qb]);
        ++j;
      }
      return;
    }
    if (threadIdx.x != 0) return;
    int stage = 0, phase = 0, n = 0;
    for (int r = 0; r * (int)gridDim.x < p.items; ++r) {
      const int t = item_of_round(r);
      if (t >= p.items) continue;
      const Item it = item_at<BK>(p, t);
      const int qb = n & 1;
      hx::mbar_wait(&qempty[qb], ((n >> 1) & 1) ^ 1);
      hx::mbar_arrive_tx(&qfull[qb], NC * p.P * p.g * D * 2);
      for (int w = 0; w < NC; ++w) {
        unsigned char* q = smem + S::Q + (size_t)(qb * NC + w) * G::QBYTES;
#pragma unroll
        for (int c = 0; c < G::NCH; ++c)
          hx::tma_load_4d(q + c * WG_ROWS * G::ROWB, &tmq, &qfull[qb],
                          c * G::CH, it.kvh * p.g, it.pos0 + w * p.P, it.bi);
      }
      ++n;
      for (int k0 = it.lo; k0 < it.hi; k0 += BK) {
        unsigned char* k = smem + S::K + (size_t)stage * S::KV;
        unsigned char* v = smem + S::V + (size_t)stage * S::KV;
        hx::mbar_wait(&rg.kempty[stage], phase ^ 1);
        hx::mbar_arrive_tx(&rg.kfull[stage], S::KV);
#pragma unroll
        for (int c = 0; c < G::NCH; ++c)
          hx::tma_load_4d(k + c * BK * G::ROWB, &tmk, &rg.kfull[stage],
                          c * G::CH, it.kvh, k0, it.bi);
        hx::mbar_wait(&rg.vempty[stage], phase ^ 1);
        hx::mbar_arrive_tx(&rg.vfull[stage], S::KV);
#pragma unroll
        for (int c = 0; c < G::NCH; ++c)
          hx::tma_load_4d(v + c * BK * G::ROWB, &tmv, &rg.vfull[stage],
                          c * G::CH, it.kvh, k0, it.bi);
        advance<STAGES>(stage, phase);
      }
    }
    return;
  }

  // consumers
  hx::setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = wgi - 1;
  const int tid = threadIdx.x - 128 * wgi;
  const int warp = tid / 32, lane = tid % 32, gq = lane / 4, tq = lane % 4;
  const Turns turn{wg};
  if (wg == NC - 1) turn.end();  // warpgroup 0 issues first
  int stage = 0, phase = 0, n = 0;
  for (int r = 0; r * (int)gridDim.x < p.items; ++r) {
    const int t = item_of_round(r);
    if (t >= p.items) continue;
    const Item it = item_at<BK>(p, t);
    const int qb = n & 1;
    unsigned char* qs = smem + S::Q + (size_t)(qb * NC + wg) * G::QBYTES;

    // this warpgroup's positions and the keys they may see
    const int pos0 = it.pos0 + wg * p.P;
    const bool any = pos0 < p.sq;
    const int last = min(pos0 + p.P, p.sq) - 1;
    const int hi_w = p.causal ? min(it.kv_end, last + 1) : it.kv_end;
    const int lo_w =
        p.window > 0 ? max(it.kv_begin, pos0 - p.window + 1) : it.kv_begin;
    const int ra = warp * 16 + gq;
    const int qpos[2] = {pos0 + ra / p.g, pos0 + (ra + 8) / p.g};

    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    uint32_t pa[BK / 16][4];  // P of the previous tile, bf16 A fragments
    Rows rw{it.kv_begin, it.kv_end, pos0, last, {qpos[0], qpos[1]}, tq};

    // tiles [it.lo, it.hi): a leading and a trailing run that no row of
    // this warpgroup sees (the item's other rows do) only pass through;
    // the run between is computed, each tile's S issued with the previous
    // tile's P V, so no wgmma sits in a branch
    const int c_hi = any ? min(it.hi, hi_w) : it.lo;
    int k0 = it.lo;
    for (; k0 < c_hi && k0 + BK <= lo_w; k0 += BK) {
      pass_tile<STAGES>(rg, stage, phase, lane);
      turn.idle();
    }
    hx::mbar_wait(&qfull[qb], (n >> 1) & 1);
    // Q's A fragments, for the whole item (at head dim 256 Q stays in its
    // buffer: QREG)
    uint32_t qf[QFRAGS<D>][4];
    if constexpr (QREG<D>) load_q_frags<D>(qf, qs, warp, lane);
    if (k0 < c_hi) {
      float s[BK / 2];
      const unsigned char* kt = smem + S::K + (size_t)stage * S::KV;
      hx::mbar_wait(&rg.kfull[stage], phase);
      turn.begin();
      issue_s<D, BK>(s, qf, qs, kt);
      turn.end();
      hx::wgmma_wait<0>();
      hx::fence_regs(s);
      if (lane == 0) hx::mbar_arrive(&rg.kempty[stage]);
      softmax_tile<D, BK, true>(s, m, l, o, pa, p, rw, k0, nullptr, lane);
      int prev = stage, prev_phase = phase;
      advance<STAGES>(stage, phase);
      for (k0 += BK; k0 < c_hi; k0 += BK) {
        kt = smem + S::K + (size_t)stage * S::KV;
        hx::mbar_wait(&rg.kfull[stage], phase);
        hx::mbar_wait(&rg.vfull[prev], prev_phase);
        turn.begin();
        issue_s<D, BK>(s, qf, qs, kt);
        issue_pv<D, BK>(o, pa, smem + S::V + (size_t)prev * S::KV);
        turn.end();
        hx::wgmma_wait<1>();
        hx::fence_regs(s);
        if (lane == 0) hx::mbar_arrive(&rg.kempty[stage]);
        softmax_tile<D, BK, false>(s, m, l, o, pa, p, rw, k0,
                                   &rg.vempty[prev], lane);
        prev = stage;
        prev_phase = phase;
        advance<STAGES>(stage, phase);
      }
      hx::mbar_wait(&rg.vfull[prev], prev_phase);
      turn.begin();
      issue_pv<D, BK>(o, pa, smem + S::V + (size_t)prev * S::KV);
      turn.end();
      hx::wgmma_wait<0>();
      hx::fence_regs(o);
      if (lane == 0) hx::mbar_arrive(&rg.vempty[prev]);
    } else {
      turn.idle();  // every warpgroup takes tiles + 1 turns per item
    }
    for (; k0 < it.hi; k0 += BK) {
      pass_tile<STAGES>(rg, stage, phase, lane);
      turn.idle();
    }

    // epilogue: normalise into the Q buffer (same swizzled layout, so the
    // quads' 4-byte writes spread over the banks) for the producer
    // warpgroup's TMA store, which clips rows past sq
    hx::named_barrier(1 + wg, 128);  // every warp is done reading Q
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      inv[h] = m[h] <= NEG_INF / 2 ? 0.f : 1.f / fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 8 * j + 2 * tq;
        *reinterpret_cast<uint32_t*>(qs + G::off(ra + 8 * h, c / 8) +
                                     (c % 8) * 2) =
            pack_bf16(o[4 * j + 2 * h] * inv[h], o[4 * j + 2 * h + 1] * inv[h]);
      }
    }
    hx::fence_proxy_async();
    __syncwarp();
    if (lane == 0) hx::mbar_arrive(&staged[qb]);
    if constexpr (sizeof(PP) != sizeof(Params)) {
      if (tq == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // rows past the warpgroup's P whole groups (g not dividing 64)
          // hold stale Q: their positions belong to the next warpgroup
          const int r = ra + 8 * h;
          if (r < p.P * p.g && qpos[h] < p.sq)
            p.lse[((int64_t)it.bi * p.hq + it.kvh * p.g + r % p.g) * p.sq +
                  qpos[h]] = m[h] <= NEG_INF / 2
                                 ? 0.f
                                 : m[h] * p.scale + logf(l[h]);
        }
      }
    }
    ++n;
  }
}

// D: the instance's width in shared memory and registers; d: the tensors'
// head dim (d <= D; the columns past d read as zeros and are not stored)
template <int D, int BK, int STAGES, class PP = Params>
cudaError_t launch(PP p, const void* q, const void* k, const void* v,
                   void* o, int d, cudaStream_t stream) {
  using G = Geo<D>;
  constexpr size_t smem = Smem<D, BK, STAGES>::BYTES;
  const CUtensorMapSwizzle swz = G::ROWB == 128
                                     ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap tmq, tmk, tmv, tmo;
  cudaError_t e = hx::bf16_map_4d(&tmq, q, d, p.hq, p.sq, p.b, G::CH, p.g,
                                  p.P, 1, swz);
  if (e == cudaSuccess)
    e = hx::bf16_map_4d(&tmo, o, d, p.hq, p.sq, p.b, G::CH, p.g, p.P, 1, swz);
  if (e == cudaSuccess)
    e = hx::bf16_map_4d(&tmk, k, d, p.hkv, p.skv, p.b, G::CH, 1, BK, 1, swz);
  if (e == cudaSuccess)
    e = hx::bf16_map_4d(&tmv, v, d, p.hkv, p.skv, p.b, G::CH, 1, BK, 1, swz);
  if (e != cudaSuccess) return e;
  auto kern = flash_fwd<D, BK, STAGES, PP>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, l2 = 0;
  cudaGetDevice(&dev);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev);
  if (e != cudaSuccess) return e;
  p.n_mtiles = (p.sq + NC * p.P - 1) / (NC * p.P);
  p.items = p.n_mtiles * p.b * p.hkv;
  // pairs per section: their K and V take at most 1/16 of the L2 cache
  // (6 pairs at the serving shape on an H100), so the K/V tiles that the
  // 132 CTAs fetch at one time come from few pairs and are re-read from L2
  const int64_t pair_bytes = (int64_t)p.skv * d * 2 * 2;
  p.sect = (int)max((int64_t)1, l2 / 16 / pair_bytes);
  kern<<<min(p.items, sms), 128 * (NC + 1), smem, stream>>>(p, tmq, tmk, tmv,
                                                           tmo);
  return cudaGetLastError();
}

// bf16: the rows of a consumer warpgroup are whole GQA groups, so g <= 64
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, const int* kv_len, const int* kv_start,
                        int b, int sq, int skv, int hq, int hkv, int d,
                        int causal, int window, float scale,
                        cudaStream_t st) {
  Params p{};
  p.kv_len = kv_len;
  p.kv_start = kv_start;
  p.b = b;
  p.sq = sq;
  p.skv = skv;
  p.hq = hq;
  p.hkv = hkv;
  p.g = hq / hkv;
  p.P = WG_ROWS / p.g;
  p.causal = causal;
  p.window = window;
  p.scale_log2 = scale * 1.4426950408889634f;
  if (p.P < 1) return cudaErrorInvalidValue;
  if (skv == 0) {  // no key at all: every row is dead
    cudaError_t e = cudaMemsetAsync(o, 0, (size_t)b * sq * hq * d * 2, st);
    if (e == cudaSuccess && lse)
      e = cudaMemsetAsync(lse, 0, (size_t)b * hq * sq * 4, st);
    return e;
  }
  if (lse) {  // training: the head dims the backward kernel takes
    ParamsLse pl{};
    static_cast<Params&>(pl) = p;
    pl.lse = lse;
    pl.scale = scale;
    switch (d) {
      case 64:
        return launch<64, TILE_KEYS, RING>(pl, q, k, v, o, d, st);
      case 80:  // the serving instance's 96-wide layout
        return launch<96, TILE_KEYS, RING>(pl, q, k, v, o, d, st);
      case 128:
        return launch<128, TILE_KEYS, RING>(pl, q, k, v, o, d, st);
      case 256:
        return launch<256, TILE_KEYS_256, RING>(pl, q, k, v, o, d, st);
      default:
        return cudaErrorInvalidValue;
    }
  }
  switch (d) {
    case 32:
      return launch<32, TILE_KEYS, RING>(p, q, k, v, o, d, st);
    case 64:
      return launch<64, TILE_KEYS, RING>(p, q, k, v, o, d, st);
    case 80:  // 96 wide: three 32-column chunks, the last one part zeros
      return launch<96, TILE_KEYS, RING>(p, q, k, v, o, d, st);
    case 128:
      return launch<128, TILE_KEYS, RING>(p, q, k, v, o, d, st);
    case 256:  // 32-key tiles: see the note at the top of this file
      return launch<256, TILE_KEYS_256, RING>(p, q, k, v, o, d, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace fa

// lse: null (serving), or (b, hq, sq) fp32 for the rows' log-sum-exp
// (training; head dims 64, 80, 128 and 256)
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, float* lse, const int* kv_len,
                                   const int* kv_start, int b, int sq,
                                   int skv, int hq, int hkv, int d,
                                   int causal, int window, float scale,
                                   int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (hkv <= 0 || hq % hkv != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return (int)fa::launch_bf16(q, k, v, o, lse, kv_len, kv_start, b, sq, skv,
                                hq, hkv, d, causal, window, scale, st);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  rt::AttnParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.kv_len = kv_len;
  p.kv_start = kv_start;
  p.b = b;
  p.sq = sq;
  p.skv = skv;
  p.hq = hq;
  p.hkv = hkv;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  if (lse == nullptr) return (int)rt::dispatch_d<float, false>(p, d, st);
  rt::AttnParamsLse pl{};
  static_cast<rt::AttnParams&>(pl) = p;
  pl.lse = lse;
  return (int)rt::dispatch_d<float, false>(pl, d, st);
}
