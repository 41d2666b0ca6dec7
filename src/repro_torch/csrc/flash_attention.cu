// Flash attention forward for Hopper (sm_90a), the port's cold-prefill kernel.
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention_pallas.
// Computes GQA attention q (b, sq, hq, d) x k/v (b, skv, hkv, d) with causal,
// sliding-window, kv_len and kv_start masks; sq and skv may be any length
// (the joint prefill pads prompts to multiples of 16), the ragged edges are
// masked here.
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
#include "hopper.cuh"

namespace fa {

using bf16 = __nv_bfloat16;
constexpr float NEG_INF = rt::NEG_INF;
constexpr int WG_ROWS = 64;     // rows of one consumer warpgroup (wgmma M)
constexpr int NC = 2;           // consumer warpgroups per CTA
constexpr int TILE_KEYS = 128;  // keys per K/V tile
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

// Item of this CTA in round r: rounds of gridDim.x items, walked forwards
// and backwards in turn so no CTA always gets the longest of a round; past
// the end (the last round) it is >= p.items.
__device__ __forceinline__ int item_of_round(int r) {
  const int G = gridDim.x, c = blockIdx.x;
  return r * G + ((r & 1) ? G - 1 - c : c);
}

// Shared-memory geometry of a head dim: d is cut into chunks of CH columns
// (the swizzle width: 64 bf16 = 128 B, or 32 = 64 B at d 32); each chunk
// region holds its rows at ROWB bytes, swizzled in 16-byte units.
template <int D>
struct Geo {
  static constexpr int CH = D < 64 ? D : 64;
  static constexpr int NCH = D / CH;
  static constexpr int ROWB = CH * 2;
  static constexpr uint32_t SWZ = ROWB == 128 ? 1 : 2;  // descriptor mode
  static constexpr int MASK = ROWB / 16 - 1;
  static constexpr int QBYTES = WG_ROWS * D * 2;        // one Q buffer
  // byte offset of 16-byte unit c16 (of d / 8) of row r in a Q buffer
  __device__ static __forceinline__ int off(int r, int c16) {
    const int ch = c16 / (CH / 8), o = r * ROWB + (c16 % (CH / 8)) * 16;
    return ch * WG_ROWS * ROWB + (o ^ (((o >> 7) & MASK) << 4));
  }
};

template <int D, int BK, int STAGES>
struct Smem {
  static constexpr int KV = BK * D * 2;  // one K (or V) tile
  static constexpr size_t K = 0;
  static constexpr size_t V = K + (size_t)STAGES * KV;
  static constexpr size_t Q = V + (size_t)STAGES * KV;  // [2][NC] buffers
  static constexpr size_t BAR = Q + (size_t)2 * NC * Geo<D>::QBYTES;
  static constexpr size_t BYTES = BAR + (4 * STAGES + 6) * 8 + 1024;
};

// 2^x on the SFU (ex2.approx.ftz): 2^(-huge) is exactly 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// TB 1: B MN-major (V in P V), 0: K-major (K in Q K^T)
template <int N, int TB>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db,
                                       int accumulate) {
  if constexpr (N == 32) hx::wgmma_rs_n32<TB>(d, a, db, accumulate);
  if constexpr (N == 64) hx::wgmma_rs_n64<TB>(d, a, db, accumulate);
  if constexpr (N == 128) hx::wgmma_rs_n128<TB>(d, a, db, accumulate);
}

// this warp's A fragments of its 16 Q rows, all of d, from a Q buffer
template <int D>
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[D / 16][4],
                                             const unsigned char* qs,
                                             int warp, int lane) {
  const int row = warp * 16 + (lane % 8) + 8 * ((lane / 8) % 2);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t addr =
        hx::smem_u32(qs + Geo<D>::off(row, 2 * kk + lane / 16));
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(qf[kk][0]), "=r"(qf[kk][1]), "=r"(qf[kk][2]), "=r"(qf[kk][3])
        : "r"(addr));
  }
}

// issue S = Q K^T over d in k-steps of 16 (32 bytes along K's swizzled
// rows), Q's fragments in registers
template <int D, int BK>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2],
                                         const uint32_t (&qf)[D / 16][4],
                                         const unsigned char* k) {
  using G = Geo<D>;
  hx::fence_regs(s);
  hx::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk / (G::CH / 16), kb = (kk % (G::CH / 16)) * 32;
    mma_rs<BK, 0>(s, qf[kk],
                  hx::gmma_desc(k + c * BK * G::ROWB + kb, 16, 8 * G::ROWB,
                                G::SWZ),
                  kk > 0);
  }
  hx::wgmma_commit();
}

// issue O += P V, 16 keys per k-step; V's next 16 rows are 2 swizzle atoms
// further on, its next d chunk BK rows further on
template <int D, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[BK / 16][4],
                                         const unsigned char* v) {
  using G = Geo<D>;
  hx::fence_regs(o);
  hx::wgmma_fence();
#pragma unroll
  for (int kv = 0; kv < BK / 16; ++kv)
    mma_rs<D, 1>(o, pa[kv],
                 hx::gmma_desc(v + kv * 16 * G::ROWB, BK * G::ROWB,
                               8 * G::ROWB, G::SWZ),
                 1);
  hx::wgmma_commit();
}

template <int STAGES>
__device__ __forceinline__ void advance(int& stage, int& phase) {
  if (++stage == STAGES) {
    stage = 0;
    phase ^= 1;
  }
}

// The K/V ring: K and V tiles of a stage fill and empty on barriers of
// their own, so a K tile goes back as soon as S is computed while V waits
// for its P V.
struct Ring {
  uint64_t *kfull, *kempty, *vfull, *vempty;
};

// wait for a K/V tile and hand it back unread
template <int STAGES>
__device__ __forceinline__ void pass_tile(const Ring& rg, int& stage,
                                          int& phase, int lane) {
  hx::mbar_wait(&rg.kfull[stage], phase);
  hx::mbar_wait(&rg.vfull[stage], phase);
  if (lane == 0) {
    hx::mbar_arrive(&rg.kempty[stage]);
    hx::mbar_arrive(&rg.vempty[stage]);
  }
  advance<STAGES>(stage, phase);
}

// Turns of the consumer warpgroups at the tensor cores: warpgroup w issues
// its wgmma batch after w - 1's and before w + 1's (round robin), so one
// warpgroup's softmax runs while the others' products do, instead of all
// of them waiting on the same tile at once. Named barriers 4 .. 3 + NC;
// every warpgroup takes the same number of turns per item.
struct Turns {
  int wg;
  __device__ __forceinline__ void begin() const {
    hx::named_barrier(4 + wg, 256);
  }
  __device__ __forceinline__ void end() const {
    hx::named_arrive(4 + (wg + 1) % NC, 256);
  }
  __device__ __forceinline__ void idle() const {
    begin();
    end();
  }
};

// what the mask of a consumer thread's two rows needs
struct Rows {
  int kv_begin, kv_end, pos0, last, qpos[2], tq;
};

// Online softmax of one tile's scores s (raw, this thread's two rows) into
// the running max m, sum l and output o, leaving P as bf16 A fragments in
// pa. Not FIRST: the previous tile's P V is in flight and is waited for
// (then its stage `release`d) before o is rescaled.
template <int D, int BK, bool FIRST>
__device__ __forceinline__ void softmax_tile(
    float (&s)[BK / 2], float (&m)[2], float (&l)[2], float (&o)[D / 2],
    uint32_t (&pa)[BK / 16][4], const Params& p, const Rows& rw, int k0,
    uint64_t* release, int lane) {
  // mask only the tiles that need it (the causal diagonal, the window's
  // and kv_start / kv_len's edges)
  const bool full_tile = k0 >= rw.kv_begin && k0 + BK <= rw.kv_end &&
                         (!p.causal || k0 + BK - 1 <= rw.pos0) &&
                         (p.window <= 0 || k0 > rw.last - p.window);
  if (!full_tile) {
    // row h sees the tile's columns [a[h], b[h]) (column = key - k0 -
    // 2 tq, a constant of the unrolled loop)
    int a[2], b[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int lo = rw.kv_begin, hi = rw.kv_end;
      if (p.causal) hi = min(hi, rw.qpos[h] + 1);
      if (p.window > 0) lo = max(lo, rw.qpos[h] - p.window + 1);
      a[h] = lo - k0 - 2 * rw.tq;
      b[h] = hi - k0 - 2 * rw.tq;
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int h = (i >> 1) & 1, col = 8 * (i / 4) + (i & 1);
      s[i] = col >= a[h] && col < b[h] ? s[i] : NEG_INF;
    }
  }
  // row max over raw scores, two independent chains per row
  float mx[2][2] = {{m[0], m[0]}, {m[1], m[1]}};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i)
    mx[(i >> 1) & 1][(i >> 2) & 1] =
        fmaxf(mx[(i >> 1) & 1][(i >> 2) & 1], s[i]);
  float mc[2], corr[2], rs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v = fmaxf(mx[h][0], mx[h][1]);
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    // a row with no live key yet: its NEG_INF scores stay hugely negative
    // (p = 0) against a zero reference
    mc[h] = (v <= NEG_INF / 2 ? 0.f : v) * p.scale_log2;
    corr[h] = ex2(m[h] * p.scale_log2 - mc[h]);
    m[h] = v;
  }
  // p = 2^(s * scale log2 e - m * scale log2 e): one FFMA, one ex2
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int h = (i >> 1) & 1;
    s[i] = ex2(fmaf(s[i], p.scale_log2, -mc[h]));
    rs[h][(i >> 2) & 1] += s[i];
  }
  if (!FIRST) {  // the previous P V is done: release its stage
    hx::wgmma_wait<0>();
    hx::fence_regs(o);
    if (lane == 0) hx::mbar_arrive(release);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v = rs[h][0] + rs[h][1];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    l[h] = l[h] * corr[h] + v;
    if (!FIRST) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 2 * h] *= corr[h];
        o[4 * j + 2 * h + 1] *= corr[h];
      }
    }
  }
  // the S accumulator layout is the A fragment layout of P V
#pragma unroll
  for (int kv = 0; kv < BK / 16; ++kv)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pa[kv][i] = pack_bf16(s[8 * kv + 2 * i], s[8 * kv + 2 * i + 1]);
}

template <int D, int BK, int STAGES>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
    flash_fwd(const Params p, const __grid_constant__ CUtensorMap tmq,
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
    uint32_t qf[D / 16][4];  // Q's A fragments, for the whole item
    load_q_frags<D>(qf, qs, warp, lane);
    if (k0 < c_hi) {
      float s[BK / 2];
      const unsigned char* kt = smem + S::K + (size_t)stage * S::KV;
      hx::mbar_wait(&rg.kfull[stage], phase);
      turn.begin();
      issue_qk<D, BK>(s, qf, kt);
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
        issue_qk<D, BK>(s, qf, kt);
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
    ++n;
  }
}

template <int D, int BK, int STAGES>
cudaError_t launch(Params p, const void* q, const void* k, const void* v,
                   void* o, cudaStream_t stream) {
  using G = Geo<D>;
  constexpr size_t smem = Smem<D, BK, STAGES>::BYTES;
  const CUtensorMapSwizzle swz = G::ROWB == 128
                                     ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap tmq, tmk, tmv, tmo;
  cudaError_t e = hx::bf16_map_4d(&tmq, q, D, p.hq, p.sq, p.b, G::CH, p.g,
                                  p.P, 1, swz);
  if (e == cudaSuccess)
    e = hx::bf16_map_4d(&tmo, o, D, p.hq, p.sq, p.b, G::CH, p.g, p.P, 1, swz);
  if (e == cudaSuccess)
    e = hx::bf16_map_4d(&tmk, k, D, p.hkv, p.skv, p.b, G::CH, 1, BK, 1, swz);
  if (e == cudaSuccess)
    e = hx::bf16_map_4d(&tmv, v, D, p.hkv, p.skv, p.b, G::CH, 1, BK, 1, swz);
  if (e != cudaSuccess) return e;
  auto kern = flash_fwd<D, BK, STAGES>;
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
  const int64_t pair_bytes = (int64_t)p.skv * D * 2 * 2;
  p.sect = (int)max((int64_t)1, l2 / 16 / pair_bytes);
  kern<<<min(p.items, sms), 128 * (NC + 1), smem, stream>>>(p, tmq, tmk, tmv,
                                                           tmo);
  return cudaGetLastError();
}

// bf16: the rows of a consumer warpgroup are whole GQA groups, so g <= 64
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        const int* kv_len, const int* kv_start, int b, int sq,
                        int skv, int hq, int hkv, int d, int causal,
                        int window, float scale, cudaStream_t st) {
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
  if (skv == 0)  // no key at all: every row is dead
    return cudaMemsetAsync(o, 0, (size_t)b * sq * hq * d * 2, st);
  switch (d) {
    case 32:
      return launch<32, TILE_KEYS, RING>(p, q, k, v, o, st);
    case 64:
      return launch<64, TILE_KEYS, RING>(p, q, k, v, o, st);
    case 128:
      return launch<128, TILE_KEYS, RING>(p, q, k, v, o, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace fa

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, const int* kv_len,
                                   const int* kv_start, int b, int sq,
                                   int skv, int hq, int hkv, int d,
                                   int causal, int window, float scale,
                                   int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (hkv <= 0 || hq % hkv != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return (int)fa::launch_bf16(q, k, v, o, kv_len, kv_start, b, sq, skv, hq,
                                hkv, d, causal, window, scale, st);
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
  return (int)rt::dispatch_d<float, float, false>(p, d, st);
}
