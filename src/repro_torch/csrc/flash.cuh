// Building blocks of the port's wgmma attention bodies for Hopper (sm_90a):
// flash prefill (flash_attention.cu, fa::flash_fwd) and the paged context
// body (paged_attention.cu, pc::context_fwd). Both are three warpgroups, a
// producer and two consumers of 64 rows (P positions x the g query heads of
// one kv head); what they share is here: the shared-memory geometry of the
// swizzled Q and K/V tiles, the wgmma issue of S = Q K^T (K from shared
// memory, Q in registers) and O += P V (P in registers, V through a
// transposing descriptor), the K/V ring's barriers, the consumers' turns at
// the tensor cores, and the online softmax on the accumulators.
#pragma once

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace fa {

constexpr float NEG_INF = -1e30f;  // a masked score (repro.kernels.ref)
constexpr int WG_ROWS = 64;        // rows of one consumer warpgroup (wgmma M)
constexpr int NC = 2;              // consumer warpgroups per CTA

// Item of this CTA in round r: rounds of gridDim.x items, walked forwards
// and backwards in turn so no CTA always gets the longest of a round; past
// the end (the last round) it is >= p.items.
__device__ __forceinline__ int item_of_round(int r) {
  const int G = gridDim.x, c = blockIdx.x;
  return r * G + ((r & 1) ? G - 1 - c : c);
}

// Shared-memory geometry of a head dim: d is cut into chunks of CH columns
// (the swizzle width: 64 bf16 = 128 B, or 32 = 64 B where d is not a
// multiple of 64: d 32, and the 96 columns that head dim 80 runs in; d 256
// is four 128-byte chunks); each chunk region holds its rows at ROWB
// bytes, swizzled in 16-byte units.
template <int D>
struct Geo {
  static constexpr int CH = D % 64 ? 32 : 64;
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
  // the same in a tile of ROWS rows (a K or V tile of ROWS keys)
  template <int ROWS>
  __device__ static __forceinline__ int tile_off(int r, int c16) {
    const int ch = c16 / (CH / 8), o = r * ROWB + (c16 % (CH / 8)) * 16;
    return ch * ROWS * ROWB + (o ^ (((o >> 7) & MASK) << 4));
  }
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
  if constexpr (N == 96) hx::wgmma_rs_n96<TB>(d, a, db, accumulate);
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

// Whether a consumer keeps its Q rows in registers for a work item (A from
// registers in S = Q K^T). At head dim 256 they would take 64 registers
// beside O's 128, so Q K^T reads Q from its shared buffer as well
// (issue_qk_ss) and the Q fragments shrink to a placeholder.
template <int D>
constexpr bool QREG = D != 256;
template <int D>
constexpr int QFRAGS = QREG<D> ? D / 16 : 1;

// issue S = Q K^T over d in k-steps of 16 with Q from its shared buffer
// too (wgmma's SS form): the Q buffer's chunks are WG_ROWS rows apart, its
// rows swizzled like K's
template <int D, int BK>
__device__ __forceinline__ void issue_qk_ss(float (&s)[BK / 2],
                                            const unsigned char* q,
                                            const unsigned char* k) {
  using G = Geo<D>;
  static_assert(BK == 32, "the SS form runs the 32-key tiles only");
  hx::fence_regs(s);
  hx::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk / (G::CH / 16), kb = (kk % (G::CH / 16)) * 32;
    hx::wgmma_ss_n32(
        s,
        hx::gmma_desc(q + c * WG_ROWS * G::ROWB + kb, 16, 8 * G::ROWB,
                      G::SWZ),
        hx::gmma_desc(k + c * BK * G::ROWB + kb, 16, 8 * G::ROWB, G::SWZ),
        kk > 0);
  }
  hx::wgmma_commit();
}

// S = Q K^T with Q in registers (qf) or, where QREG is false, in its
// shared buffer qs
template <int D, int BK>
__device__ __forceinline__ void issue_s(float (&s)[BK / 2],
                                        const uint32_t (&qf)[QFRAGS<D>][4],
                                        const unsigned char* qs,
                                        const unsigned char* k) {
  if constexpr (QREG<D>)
    issue_qk<D, BK>(s, qf, k);
  else
    issue_qk_ss<D, BK>(s, qs, k);
}

// issue O += P V, 16 keys per k-step; V's next 16 rows are 2 swizzle atoms
// further on, its next d chunk BK rows further on. Head dim 256 is two
// n128 products a k-step (wgmma's widest is n256, whose 128 accumulators
// a thread are O whole): columns 0..127 from V's chunks 0, 1 into O's
// first 64 accumulators, 128..255 from chunks 2, 3 into the rest (the
// accumulators of an n256 product, in that order)
template <int D, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[BK / 16][4],
                                         const unsigned char* v) {
  using G = Geo<D>;
  hx::fence_regs(o);
  hx::wgmma_fence();
  if constexpr (D == 256) {
    float(&o0)[64] = *reinterpret_cast<float(*)[64]>(o);
    float(&o1)[64] = *reinterpret_cast<float(*)[64]>(o + 64);
#pragma unroll
    for (int kv = 0; kv < BK / 16; ++kv) {
      hx::wgmma_rs_n128<1>(o0, pa[kv],
                           hx::gmma_desc(v + kv * 16 * G::ROWB,
                                         BK * G::ROWB, 8 * G::ROWB, G::SWZ),
                           1);
      hx::wgmma_rs_n128<1>(o1, pa[kv],
                           hx::gmma_desc(v + 2 * BK * G::ROWB +
                                             kv * 16 * G::ROWB,
                                         BK * G::ROWB, 8 * G::ROWB, G::SWZ),
                           1);
    }
  } else {
#pragma unroll
    for (int kv = 0; kv < BK / 16; ++kv)
      mma_rs<D, 1>(o, pa[kv],
                   hx::gmma_desc(v + kv * 16 * G::ROWB, BK * G::ROWB,
                                 8 * G::ROWB, G::SWZ),
                   1);
  }
  hx::wgmma_commit();
}

// the same with P split in two (PSplit below): O += P_hi V + P_lo V
template <int D, int BK, class PS>
__device__ __forceinline__ void issue_pv_split(float (&o)[D / 2],
                                               const PS& pa,
                                               const unsigned char* v) {
  using G = Geo<D>;
  hx::fence_regs(o);
  hx::wgmma_fence();
#pragma unroll
  for (int kv = 0; kv < BK / 16; ++kv) {
    const uint64_t dv = hx::gmma_desc(v + kv * 16 * G::ROWB, BK * G::ROWB,
                                      8 * G::ROWB, G::SWZ);
    mma_rs<D, 1>(o, pa.hi[kv], dv, 1);
    mma_rs<D, 1>(o, pa.lo[kv], dv, 1);
  }
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

// P, rounded to bf16 once: A fragments of P V
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 16][4],
                                       const float (&s)[BK / 2]) {
  // the S accumulator layout is the A fragment layout of P V
#pragma unroll
  for (int kv = 0; kv < BK / 16; ++kv)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pa[kv][i] = pack_bf16(s[8 * kv + 2 * i], s[8 * kv + 2 * i + 1]);
}

// P split into a bf16 high part and the bf16 of what it leaves out (two
// P V products), so the product keeps ~16 bits of P
template <int BK>
struct PSplit {
  uint32_t hi[BK / 16][4], lo[BK / 16][4];
};
template <int BK>
__device__ __forceinline__ void pack_p(PSplit<BK>& pa,
                                       const float (&s)[BK / 2]) {
#pragma unroll
  for (int kv = 0; kv < BK / 16; ++kv)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x0 = s[8 * kv + 2 * i], x1 = s[8 * kv + 2 * i + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(h);
      pa.hi[kv][i] = *reinterpret_cast<const uint32_t*>(&h);
      pa.lo[kv][i] = pack_bf16(x0 - hf.x, x1 - hf.y);
    }
}

// Online softmax of one tile's scores s (raw, this thread's two rows) into
// the running max m, sum l and output o, leaving P as bf16 A fragments in
// pa (rounded once, or split in two: pack_p). Prm: the kernel's params
// (causal, window, scale_log2). Not FIRST: the previous tile's P V is in
// flight and is waited for (then its stage `release`d) before o is
// rescaled.
template <int D, int BK, bool FIRST, class PA, class Prm>
__device__ __forceinline__ void softmax_tile(
    float (&s)[BK / 2], float (&m)[2], float (&l)[2], float (&o)[D / 2],
    PA& pa, const Prm& p, const Rows& rw, int k0, uint64_t* release,
    int lane) {
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
  pack_p<BK>(pa, s);
}


}  // namespace fa
