// GQA decode attention body for Hopper (sm_90a): one query token per row
// against a K/V cache, shared by the contiguous-cache decode kernel
// (decode_attention.cu, the draft model's decode step), the paged decode
// kernel (paged_attention.cu, every decode iteration of the serving path),
// the paged verify kernel (paged_attention.cu, every speculative verify
// step) and their twins on int8 / fp8 pools (the quantized paged decode
// and verify, below). They differ in where key row j of batch row i lives
// (KEYS below):
//
//  - CONTIGUOUS: row i S + j of a (b, S, hkv, d) cache;
//  - PAGED16: row tables[i max_blocks + j / bs] bs + j % bs of a
//    (n_blocks, bs, hkv, d) pool, when bs is a multiple of 16: a warp's 16
//    keys then lie in one page, looked up once per 16-key group;
//  - PAGED: the same pool at any other block size, one lookup per key;
//
// and, for verify (decode_fwd on VParams), in what a query column is. A
// decode block's columns are <= 8 query heads of one kv head. A verify row
// holds T candidates, candidate t at position q_origin[i] + t (q_origin:
// the slot's committed length), and a block's 8 columns are (candidate,
// head) pairs of one kv head: cp = max(1, 8 / g) candidates of g heads
// each at g <= 8 (1 x 8 at g 8, 2 x 4 at g 4, 8 x 1 at g 1; cp capped by
// T), or one candidate and a group of 8 heads at g > 8 (VCols below).
// Column (t, h) reads q[i, t, h] and sees keys [0, min(kv_len[i],
// q_origin[i] + t + 1)): the committed keys and the candidates up to
// itself. So padding candidates (t >= the slot's real count, past kv_len)
// see the committed keys, a free slot (kv_len 0) is dead, and kv_len ==
// q_origin > 0 sees the committed keys, as the oracle does. The mask is per
// column; a block's keys end at the largest limit of its columns. The
// ceil(T / cp) column groups of one (row, kv head, split) are the fastest
// grid index, so the blocks that read the same keys run side by side and
// share them in L2. The decode instances compile as before: every verify
// step is behind if constexpr, decode's own statement in the else branch
// (VerifyState).
//
// Within a page the rows of one kv head are strided exactly as in the
// contiguous cache (hkv d elements apart), so the loads, the products and
// the merge are one code.
//
// Quantized pools (decode_fwd on QParams<KV>, the quantized paged decode;
// on QVParams<KV>, the quantized paged verify) hold one-byte K/V rows (KV:
// int8_t or __nv_fp8_e4m3) and fp32 per-token-per-head scales (n_blocks,
// bs, hkv). The rows are read as one-byte payloads and widened exactly to
// q's type in registers (every int8 and e4m3 value is exact in bf16), and
// the scales are folded into the arithmetic instead of dequantizing: a
// key's score times its k_scale before the running max, its probability
// times its v_scale before P V, the row sum l over the unscaled
// probabilities. A null page's scales are 0, so a free slot's row reads 0
// times its payload and stays finite. In bf16 a lane's K bytes are whole
// 16-byte loads (8 at d 32: qdim below), so the d permutation of K and Q
// differs from the unquantized one; each of them is again behind
// if constexpr, the unquantized statement in the else branch.
//
// Decode masks keys at positions >= kv_len[i] or < kv_start[i]; a column
// with no live key writes exact zeros. S (the cache width, or the table's
// capacity max_blocks bs) may be any length: loads stop at min(kv_len, S).
//
// Bound on the card: ~4 d hq n FLOPs per row on 2 d hkv n K/V elements (n
// live keys), a few FLOPs per byte, so it is bound by reading the live part
// of the cache (a verify step by the same bytes: T x g columns per kv head
// read each K/V row once from HBM). The design keeps that read wide and in
// flight:
//
//  - One block (4 warps) per (row, kv head, group of <= 8 columns, split).
//    The columns' queries sit in registers, no thread computes for a row
//    that does not exist, and each K/V row is read once for all of them.
//    Splits divide the block's keys ([kv_start, kv_len) for decode) into
//    16-key aligned shares of at least 64 keys (split_range below), so a
//    short row leaves its trailing splits empty. The host picks the count
//    from the cache width S (kernels/decode_attention.py:contiguous_splits):
//    the live lengths are on the device, and reading them would cost a
//    host sync per call. The merge counters are the caller's buffer of
//    n_counters entries, which the entry checks against b x hkv x head
//    groups x column groups.
//  - bf16: a warp takes 16 keys at a time and loads their K and V rows
//    straight into registers, 16 bytes per load, all before any
//    arithmetic (at head dim 256, paligemma-3b's contiguous decode, the V
//    rows after the scores: LATE_V below) (8 KB in flight per warp; on
//    one-byte pools 4 KB with the
//    keys' scales, and the quantized verify issues the next step's before
//    this step's arithmetic). S^T = K Q^T runs on mma.sync
//    m16n8k16 with the keys as M and the columns as N; the d axis is
//    permuted identically in K and Q so that each thread's fragments are
//    whole 16-byte loads. P^T goes back through movmatrix into the B
//    operand of O^T = V^T P^T (d as M), split into a bf16 high part and
//    remainder so P keeps ~16 bits. fp32 (the parity path): a warp takes
//    32 keys, one per lane, on scalar FMAs in the same structure.
//  - The warps' online-softmax states merge in shared memory; with several
//    splits each block writes its partial (m, l, acc) and the last block
//    of a (row, kv head, head group, column group) to finish, found by an
//    atomic counter that it resets, merges them in the same launch.
//
// Masking follows repro.kernels.ref: a masked score is NEG_INF, p = 0 where
// the score is <= NEG_INF / 2. Scores are kept in log2 units.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace dk {

using bf16 = __nv_bfloat16;
constexpr float NEG_INF = -1e30f;
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int HEADS = 8;           // query heads per block
constexpr int MIN_SPLIT_KEYS = 64;
constexpr int MAX_SPLITS = 64;

// where key row j of batch row i lives (see the top of this file)
enum Keys { CONTIGUOUS = 0, PAGED16 = 1, PAGED = 2 };

struct Params {
  const void* q;        // (b, 1, hq, d)
  const void* k;        // (b, S, hkv, d), or the pool (n_blocks, bs, hkv, d)
  const void* v;
  void* o;              // (b, 1, hq, d)
  const int* kv_len;    // (b,) or null
  const int* kv_start;  // (b,) or null
  int b, S, hq, hkv, g, groups, n_split;
  float scale_log2;
  float* part;          // (b, hq, n_split, d + 2) when n_split > 1
  int* counters;        // (b, hkv, groups), zero between launches
  const int* tables;    // paged: (b, max_blocks) page of each logical block
  int bs, max_blocks;   // paged: S = max_blocks bs
};

// Verify's parameters (decode_fwd on VParams): q and o are (b, T, hq, d),
// part (b, T, hq, n_split, d + 2) and counters (b, hkv, groups, cgroups);
// kv_len is required and kv_start unused
struct VParams : Params {
  const int* q_origin;  // (b,) position of candidate 0: the committed length
  int T, cp, cgroups;   // candidates; per column group; column groups
};

// Quantized pools (see the top of this file): k and v hold KV payloads
template <class KV>
struct QParams : Params {
  const float* k_scale;  // (n_blocks, bs, hkv)
  const float* v_scale;
};
template <class KV>
struct QVParams : VParams {
  const float* k_scale;  // (n_blocks, bs, hkv)
  const float* v_scale;
};

// the payload type of P's pools: void for pools in q's type
template <class P>
struct Payload {
  using type = void;
};
template <class KV>
struct Payload<QParams<KV>> {
  using type = KV;
};
template <class KV>
struct Payload<QVParams<KV>> {
  using type = KV;
};

template <class P>
constexpr bool is_verify = std::is_base_of<VParams, P>::value;
template <class P>
constexpr bool is_quant = !std::is_void<typename Payload<P>::type>::value;

// keys [ks, ke) of split s of a row whose live keys are [lo, hi): 16-key
// aligned shares of at least MIN_SPLIT_KEYS; empty past the end
__device__ __forceinline__ void split_range(int lo, int hi, int n_split,
                                            int s, int& ks, int& ke) {
  const int n = max(hi - lo, 0);
  const int per = max(MIN_SPLIT_KEYS,
                      (n + 16 * n_split - 1) / (16 * n_split) * 16);
  ks = lo + s * per;
  ke = min(hi, ks + per);
}

// pool row of key j of batch row bi (paged caches)
__device__ __forceinline__ int64_t page_row(const Params& p, int bi, int j) {
  return (int64_t)p.tables[(int64_t)bi * p.max_blocks + j / p.bs] * p.bs +
         j % p.bs;
}

// Verify's columns of one block (see the top of this file): column c is
// candidate t = cg cp + c / gb and head h = grp HEADS + c % gb of kv head
// kvh (gb = min(g, HEADS)); hi = min(kv_len, S) and origin = q_origin of
// row bi
struct VCols {
  int bi, kvh, grp, cg, hi, origin;
  VCols() = default;
  __device__ __forceinline__ VCols(const VParams& p, int bi_, int kvh_)
      : bi(bi_),
        kvh(kvh_),
        grp(blockIdx.y % p.groups),
        cg(blockIdx.x % p.cgroups),
        hi(min(p.kv_len[bi_], p.S)),
        origin(p.q_origin[bi_]) {}
  // the query and output row ((bi T + t) hq + kvh g + h) of column c and,
  // in lim, the keys it sees, [0, lim); -1 and 0 for a column past T or g
  __device__ __forceinline__ int64_t col(const VParams& p, int c,
                                         int& lim) const {
    const int gb = min(p.g, HEADS);
    const int t = cg * p.cp + c / gb, h = grp * HEADS + c % gb;
    if (c >= p.cp * gb || t >= p.T || h >= p.g) {
      lim = 0;
      return -1;
    }
    lim = min(hi, origin + t + 1);
    return ((int64_t)bi * p.T + t) * p.hq + kvh * p.g + h;
  }
  __device__ __forceinline__ int64_t row(const VParams& p, int c) const {
    int lim;
    return col(p, c, lim);
  }
  // the block's keys, [0, end): the largest limit of its columns
  __device__ __forceinline__ int end(const VParams& p) const {
    return max(0, min(hi, origin + min(p.T, (cg + 1) * p.cp)));
  }
};

// What verify keeps beside decode's state, and nothing for decode: the
// decode instances must compile exactly as before (their SASS is checked
// against the previous build), so every verify step below sits behind
// if constexpr with decode's own statement in the else branch
template <class P, int N, bool = is_verify<P>>
struct VerifyState {};
template <class P, int N>
struct VerifyState<P, N, true> {
  VCols vc;
  int lim[N];  // the keys the thread's columns see, below the split's end
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// (x0, x1) -> bf16 pair hi and bf16 pair of what hi leaves out
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
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

// transpose of an 8x8 b16 matrix held one 32-bit pair per lane
__device__ __forceinline__ uint32_t movmatrix_t(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

__device__ __forceinline__ uint4 ld16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// The V words of one key row a bf16 lane holds (dims gq D / 8 .. + D / 8
// from src), or zeros
template <int MT>
__device__ __forceinline__ void load_v(uint32_t (&vw)[MT], const bf16* src,
                                       bool live) {
  if constexpr (MT >= 4) {
#pragma unroll
    for (int w = 0; w < MT / 4; ++w) {
      const uint4 x = live ? ld16(src + 8 * w) : make_uint4(0, 0, 0, 0);
      vw[4 * w] = x.x;
      vw[4 * w + 1] = x.y;
      vw[4 * w + 2] = x.z;
      vw[4 * w + 3] = x.w;
    }
  } else {
    const uint2 x =
        live ? *reinterpret_cast<const uint2*>(src) : make_uint2(0, 0);
    vw[0] = x.x;
    vw[1] = x.y;
  }
}

// Head dim 80 (contiguous decode only, h2o-danube-1.8b's): a lane's V
// words are dims 8 gq .. + 7 (words 0..3, one 16-byte load) and dims
// 64 + 2 gq, + 1 (word 4), or zeros; so m-tile i < 4 of O^T covers dims
// 8 gq + 2i, + 1 and m-tile 4 dims 64 + 2 gq, + 1 (vdim below)
__device__ __forceinline__ void load_v80(uint32_t (&vw)[5], const bf16* row,
                                         int gq, bool live) {
  const uint4 x = live ? ld16(row + 8 * gq) : make_uint4(0, 0, 0, 0);
  vw[0] = x.x;
  vw[1] = x.y;
  vw[2] = x.z;
  vw[3] = x.w;
  vw[4] = live ? *reinterpret_cast<const uint32_t*>(row + 64 + 2 * gq) : 0u;
}

// the first of the two dims that m-tile i of O^T covers for lane row gq
template <int D>
__device__ __forceinline__ int vdim(int i, int gq) {
  if constexpr (D == 80)
    return i < 4 ? 8 * gq + 2 * i : 64 + 2 * gq;
  else
    return gq * (D / 8) + 2 * i;
}

// Two one-byte K/V elements (bytes 2h, 2h + 1 of w) -> a bf16 pair, exact,
// by way of an f16 pair: int8 byte x ^ 0x80 as the low byte of f16 1024 is
// 1024 + 128 + x, so one f16x2 subtraction leaves x; fp8 e4m3: the
// hardware's pair conversion. The pair to fp32, whose upper half is then
// its bf16 (at most 8 significant bits: one byte_perm, no rounding).
template <typename KV>
__device__ __forceinline__ uint32_t widen2(uint32_t w, int h);
template <>
__device__ __forceinline__ uint32_t widen2<int8_t>(uint32_t w, int h) {
  const uint32_t x = __byte_perm(w ^ 0x80808080u, 0x64646464u,
                                 h ? 0x4342 : 0x4140);
  const float2 f = __half22float2(__hsub2(
      *reinterpret_cast<const __half2*>(&x), __float2half2_rn(1152.f)));
  return __byte_perm(__float_as_uint(f.x), __float_as_uint(f.y), 0x7632);
}
template <>
__device__ __forceinline__ uint32_t widen2<__nv_fp8_e4m3>(uint32_t w,
                                                          int h) {
  const __nv_fp8x2_storage_t* x =
      reinterpret_cast<const __nv_fp8x2_storage_t*>(&w);
  const float2 f = __half22float2(
      __half2(__nv_cvt_fp8x2_to_halfraw2(x[h], __NV_E4M3)));
  return __byte_perm(__float_as_uint(f.x), __float_as_uint(f.y), 0x7632);
}

// One one-byte K/V element -> fp32, exact (the fp32 path)
template <typename KV>
__device__ __forceinline__ float widen1(uint8_t x);
template <>
__device__ __forceinline__ float widen1<int8_t>(uint8_t x) {
  return static_cast<float>(static_cast<int8_t>(x));
}
template <>
__device__ __forceinline__ float widen1<__nv_fp8_e4m3>(uint8_t x) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x, __NV_E4M3)));
}

// One-byte pools, bf16: a lane reads its D / 4 bytes of a K row as whole
// loads of KBYTES (16 dims, 8 at d 32), and 8 bytes widen into one 8-dim
// fragment. So fragment j of lane tq holds dims qdim(j, tq) .. + 7, in K
// and in Q alike (each whole 16-byte loads of bf16).
template <int D>
constexpr int KBYTES = D >= 64 ? 16 : 8;
template <int D>
__device__ __forceinline__ int qdim(int j, int tq) {
  constexpr int F = KBYTES<D> / 8;  // fragments per load
  return (j / F) * 4 * KBYTES<D> + tq * KBYTES<D> + 8 * (j % F);
}

// N bytes (4, 8 or 16) from src into w[0 .. N / 4), or zeros
template <int N>
__device__ __forceinline__ void ldn(uint32_t* w, const uint8_t* src,
                                    bool live) {
  if constexpr (N == 16) {
    const uint4 x = live ? ld16(src) : make_uint4(0, 0, 0, 0);
    w[0] = x.x;
    w[1] = x.y;
    w[2] = x.z;
    w[3] = x.w;
  } else if constexpr (N == 8) {
    const uint2 x =
        live ? *reinterpret_cast<const uint2*>(src) : make_uint2(0, 0);
    w[0] = x.x;
    w[1] = x.y;
  } else {
    w[0] = live ? *reinterpret_cast<const uint32_t*>(src) : 0u;
  }
}

// One 16-key step of the bf16 warp loop on a quantized pool, as loaded: K
// rows c0 + gq, c0 + gq + 8 (D / 4 bytes each, in qdim's order) with their
// K and V scales (the keys of the lane's scores), and V rows c0 + 2tq +
// {0, 1, 8, 9}, dims gq D / 8 .. + D / 8
template <int D>
struct QuantRows {
  uint32_t k[2][D / 16], v[4][D / 32];
  float ks[2], vs[2];
};

// PAGED16: the pool row of key 0 of the page that holds the 16-key group
// at c0, or 0 past ke
__device__ __forceinline__ int64_t group_base(const Params& p, int bi, int c0,
                                              int ke) {
  return c0 < ke ? page_row(p, bi, c0) - c0 : 0;
}

// Issue the loads of the step at c0 (P: QParams or QVParams; PAGED16: r16
// its group_base); keys past ke read as zeros, scale 0
template <int D, int KEYS, class P>
__device__ __forceinline__ void load_quant(const P& p, int bi, int kvh,
                                           int c0, int ke, int64_t r16,
                                           QuantRows<D>& q) {
  static_assert(KEYS != CONTIGUOUS, "one-byte K/V come in pages");
  constexpr int KB = KBYTES<D>, VB = D / 8;
  const int lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
  const uint8_t* K = static_cast<const uint8_t*>(p.k);
  const uint8_t* V = static_cast<const uint8_t*>(p.v);
  auto at = [&](int key) -> int64_t {  // pool row x hkv + kv head
    const int64_t r = KEYS == PAGED16 ? r16 + key : page_row(p, bi, key);
    return r * p.hkv + kvh;
  };
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = c0 + gq + 8 * r;
    const bool live = key < ke;
    const int64_t a = live ? at(key) : 0;
#pragma unroll
    for (int u = 0; u < D / 4 / KB; ++u)
      ldn<KB>(q.k[r] + KB / 4 * u, K + a * D + u * 4 * KB + tq * KB, live);
    q.ks[r] = live ? __ldg(p.k_scale + a) : 0.f;
    q.vs[r] = live ? __ldg(p.v_scale + a) : 0.f;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = c0 + 2 * tq + (r & 1) + 8 * (r >> 1);
    const bool live = key < ke;
    ldn<VB>(q.v[r], V + (live ? at(key) : 0) * D + gq * VB, live);
  }
}

// A step's K rows widened to bf16: fragment j is words 2j, 2j + 1
template <typename KV, int D>
__device__ __forceinline__ void widen_k(const QuantRows<D>& q,
                                        uint4 (&kr)[2][D / 32]) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < D / 32; ++j)
      kr[r][j] = make_uint4(widen2<KV>(q.k[r][2 * j], 0),
                            widen2<KV>(q.k[r][2 * j], 1),
                            widen2<KV>(q.k[r][2 * j + 1], 0),
                            widen2<KV>(q.k[r][2 * j + 1], 1));
}

// A step's V rows widened to bf16, as load_v leaves them: pair i of a row
// (dims gq D / 8 + 2i, + 1) is half i % 2 of word i / 2
template <typename KV, int D>
__device__ __forceinline__ void widen_v(const QuantRows<D>& q,
                                        uint32_t (&vw)[4][D / 16]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < D / 16; ++i)
      vw[r][i] = widen2<KV>(q.v[r][i / 2], i % 2);
}

// Shared memory of a block: each warp's online-softmax state, then the
// merge flag
template <int D>
struct Smem {
  float m[WARPS][HEADS], l[WARPS][HEADS];
  float o[WARPS][HEADS][D];
  float q[HEADS][D];  // fp32 path: the group's queries
  // the merge of the splits: per head and split m, then its weight; l
  float wm[HEADS][MAX_SPLITS], wl[HEADS][MAX_SPLITS], inv[HEADS];
  int last;
};

// The bf16 warp loop: keys [ks, ke) in 16-key steps strided over the warps.
// Leaves this warp's state (for columns 2tq, 2tq+1 and dims gq * D / 8 ...)
// in sm. Decode's columns are heads h0 .. h0 + ge - 1 of row bi; verify's
// (P = VParams) are VCols'.
template <int D, int KEYS, class P>
__device__ void warp_bf16(const P& p, int bi, int kvh, int h0, int ge,
                          int ks, int ke, Smem<D>& sm) {
  constexpr int QJ = D / 32;   // 16-byte K loads per row, Q loads per head
  constexpr int MT = D / 16;   // m-tiles of O^T; words of V per key
  // head dim 80: dims 64..79 are one more k-step of S, a lane's 4 of them
  // (dims 64 + 4 tq .. + 3) an 8-byte load of K and of Q
  constexpr bool TAIL = D % 32 != 0;
  static_assert(!TAIL || (D == 80 && KEYS == CONTIGUOUS && !is_verify<P> &&
                          !is_quant<P>),
                "head dim 80 is the contiguous decode's only");
  // head dim 256: a step's V rows are loaded after its scores, so that its
  // K and V rows (64 registers each at 8 words a lane and row) are not
  // live at once beside the accumulators (64) and Q (32)
  constexpr bool LATE_V = D == 256;
  static_assert(!LATE_V || (KEYS == CONTIGUOUS && !is_verify<P> &&
                            !is_quant<P>),
                "head dim 256 is the contiguous decode's only");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const bf16* Q = static_cast<const bf16*>(p.q);
  const bf16* K = static_cast<const bf16*>(p.k);
  const bf16* V = static_cast<const bf16*>(p.v);

  // B fragments of Q^T: column gq, dims 32 j + 8 tq .. + 7 (the same
  // permutation of d as the K fragments below)
  uint4 qb[QJ];
  VerifyState<P, 2> vs;  // verify: columns 2 tq, 2 tq + 1
  if constexpr (is_verify<P>) {
    vs.vc = VCols(p, bi, kvh);
    const int64_t r = vs.vc.row(p, gq);
#pragma unroll
    for (int j = 0; j < QJ; ++j)
      if constexpr (is_quant<P>)
        qb[j] = r >= 0 ? ld16(Q + r * D + qdim<D>(j, tq))
                       : make_uint4(0, 0, 0, 0);
      else
        qb[j] = r >= 0 ? ld16(Q + r * D + 32 * j + 8 * tq)
                       : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      vs.vc.col(p, 2 * tq + e, vs.lim[e]);
      vs.lim[e] = min(vs.lim[e], ke);
    }
  } else {
#pragma unroll
    for (int j = 0; j < QJ; ++j)
      if constexpr (is_quant<P>)
        qb[j] = gq < ge ? ld16(Q + ((int64_t)bi * p.hq + h0 + gq) * D +
                               qdim<D>(j, tq))
                        : make_uint4(0, 0, 0, 0);
      else
        qb[j] = gq < ge ? ld16(Q + ((int64_t)bi * p.hq + h0 + gq) * D +
                               32 * j + 8 * tq)
                        : make_uint4(0, 0, 0, 0);
  }
  uint2 qt = make_uint2(0, 0);  // TAIL: dims 32 QJ + 4 tq .. + 3 of Q
  if constexpr (TAIL) {
    if (gq < ge)
      qt = *reinterpret_cast<const uint2*>(
          Q + ((int64_t)bi * p.hq + h0 + gq) * D + 32 * QJ + 4 * tq);
  }

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  const int64_t row_stride = (int64_t)p.hkv * D;
  const bf16* Kb = K + ((int64_t)bi * p.S * p.hkv + kvh) * D;
  const bf16* Vb = V + ((int64_t)bi * p.S * p.hkv + kvh) * D;
  // Quantized pools: PAGED16's page of the warp's next 16-key step is
  // looked up a step ahead (r16n), so no step waits on the table before
  // its loads. Verify also has the next step's loads in flight (qn) while
  // this one computes: a verify block walks its row's keys alone (one
  // split at serving shapes), so its steps' loads would wait in line;
  // decode's splits keep enough blocks in flight instead, and the second
  // step's registers (~36 at d 128) would cost it a block per SM.
  int64_t r16n = 0;
  QuantRows<D> qn;
  if constexpr (is_quant<P>) {
    const int c = ks + 16 * warp;
    if constexpr (KEYS == PAGED16) r16n = group_base(p, bi, c, ke);
    if constexpr (is_verify<P>) {
      load_quant<D, KEYS>(p, bi, kvh, c, ke, r16n, qn);
      if constexpr (KEYS == PAGED16)
        r16n = group_base(p, bi, c + 16 * WARPS, ke);
    }
  }
  for (int c0 = ks + 16 * warp; c0 < ke; c0 += 16 * WARPS) {
    // K rows c0 + gq, c0 + gq + 8; V rows c0 + 2tq + {0, 1, 8, 9}, dims
    // gq * D / 8 .. + D / 8; rows past ke read as zeros
    uint4 kr[2][QJ];
    uint2 krt[2];  // TAIL: dims 32 QJ + 4 tq .. + 3 of the two K rows
    uint32_t vw[4][MT];
    // quantized: the step's one-byte rows and scales, K widened before S,
    // V after the softmax (fewer registers in flight)
    QuantRows<D> qr;
    if constexpr (is_quant<P>) {
      const int next = c0 + 16 * WARPS * (is_verify<P> ? 2 : 1);
      if constexpr (is_verify<P>) {
        qr = qn;  // issued a step ago; now the next step's
        load_quant<D, KEYS>(p, bi, kvh, c0 + 16 * WARPS, ke, r16n, qn);
      } else {
        load_quant<D, KEYS>(p, bi, kvh, c0, ke, r16n, qr);
      }
      if constexpr (KEYS == PAGED16) r16n = group_base(p, bi, next, ke);
      widen_k<typename Payload<P>::type, D>(qr, kr);
    } else if constexpr (KEYS == CONTIGUOUS && TAIL) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = c0 + gq + 8 * r;
        const bf16* row = Kb + key * row_stride;
#pragma unroll
        for (int j = 0; j < QJ; ++j)
          kr[r][j] = key < ke ? ld16(row + 32 * j + 8 * tq)
                              : make_uint4(0, 0, 0, 0);
        krt[r] = key < ke ? *reinterpret_cast<const uint2*>(row + 32 * QJ +
                                                            4 * tq)
                          : make_uint2(0, 0);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int key = c0 + 2 * tq + (r & 1) + 8 * (r >> 1);
        load_v80(vw[r], Vb + key * row_stride, gq, key < ke);
      }
    } else if constexpr (KEYS == CONTIGUOUS) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = c0 + gq + 8 * r;
#pragma unroll
        for (int j = 0; j < QJ; ++j)
          kr[r][j] = key < ke ? ld16(Kb + key * row_stride + 32 * j + 8 * tq)
                              : make_uint4(0, 0, 0, 0);
      }
      if constexpr (!LATE_V) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int key = c0 + 2 * tq + (r & 1) + 8 * (r >> 1);
          load_v<MT>(vw[r], Vb + key * row_stride + gq * (D / 8), key < ke);
        }
      }
    } else {
      // the pool row of key `key`: in the page of the group (PAGED16), or
      // looked up per key, for live keys only (PAGED)
      int64_t r16 = 0;
      if constexpr (KEYS == PAGED16) r16 = page_row(p, bi, c0) - c0;
      auto row = [&](const bf16* X, int key) -> const bf16* {
        const int64_t r = KEYS == PAGED16 ? r16 + key : page_row(p, bi, key);
        return X + (r * p.hkv + kvh) * D;
      };
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = c0 + gq + 8 * r;
#pragma unroll
        for (int j = 0; j < QJ; ++j)
          kr[r][j] = key < ke ? ld16(row(K, key) + 32 * j + 8 * tq)
                              : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int key = c0 + 2 * tq + (r & 1) + 8 * (r >> 1);
        load_v<MT>(vw[r], key < ke ? row(V, key) + gq * (D / 8) : V,
                   key < ke);
      }
    }

    // S^T (16 keys x 8 heads) = K Q^T
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < QJ; ++j) {
      const uint32_t* k0 = reinterpret_cast<const uint32_t*>(&kr[0][j]);
      const uint32_t* k1 = reinterpret_cast<const uint32_t*>(&kr[1][j]);
      const uint32_t* qw = reinterpret_cast<const uint32_t*>(&qb[j]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint32_t a[4] = {k0[2 * half], k1[2 * half], k0[2 * half + 1],
                               k1[2 * half + 1]};
        mma_bf16(s, a, qw[2 * half], qw[2 * half + 1]);
      }
    }
    if constexpr (TAIL) {  // dims 64..79: one more k-step
      const uint32_t a[4] = {krt[0].x, krt[1].x, krt[0].y, krt[1].y};
      mma_bf16(s, a, qt.x, qt.y);
    }
    if constexpr (is_quant<P>) {  // each score times its key's k_scale
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] *= qr.ks[i / 2];
    }

    // online softmax per column: s[e] is key gq, s[2 + e] key gq + 8,
    // column 2 tq + e
    float pr[4], m_new[2], rs[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool head = 2 * tq + e < ge;
      float mx = NEG_INF;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        bool ok;
        if constexpr (is_verify<P>)
          ok = c0 + gq + 8 * r < vs.lim[e];
        else
          ok = head && c0 + gq + 8 * r < ke;
        const float sv = ok ? s[2 * r + e] * p.scale_log2 : NEG_INF;
        s[2 * r + e] = sv;
        mx = fmaxf(mx, sv);
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      m_new[e] = fmaxf(m[e], mx);
      rs[e] = 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float sv = s[2 * r + e];
        pr[2 * r + e] = sv <= NEG_INF / 2 ? 0.f : exp2f(sv - m_new[e]);
        rs[e] += pr[2 * r + e];
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        rs[e] += __shfl_xor_sync(0xffffffffu, rs[e], off);
      const float corr = exp2f(m[e] - m_new[e]);
      l[e] = l[e] * corr + rs[e];
      m[e] = m_new[e];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        acc[i][e] *= corr;
        acc[i][2 + e] *= corr;
      }
    }

    if constexpr (is_quant<P>) {  // V row j weighed by p_j v_scale_j
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] *= qr.vs[i / 2];
    }
    if constexpr (LATE_V) {  // the step's V rows, as the other widths load
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int key = c0 + 2 * tq + (r & 1) + 8 * (r >> 1);
        load_v<MT>(vw[r], Vb + key * row_stride + gq * (D / 8), key < ke);
      }
    }

    // P^T as the B operand (keys x heads): transpose the two 8x8 halves
    uint32_t x0h, x0l, x1h, x1l;
    split_bf16(pr[0], pr[1], x0h, x0l);
    split_bf16(pr[2], pr[3], x1h, x1l);
    const uint32_t b0h = movmatrix_t(x0h), b1h = movmatrix_t(x1h);
    const uint32_t b0l = movmatrix_t(x0l), b1l = movmatrix_t(x1l);
    if constexpr (is_quant<P>) widen_v<typename Payload<P>::type, D>(qr, vw);

    // O^T (d x 8 heads) += V^T P^T; m-tile i covers dims gq D/8 + 2i, + 1
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const uint32_t a[4] = {__byte_perm(vw[0][i], vw[1][i], 0x5410),
                             __byte_perm(vw[0][i], vw[1][i], 0x7632),
                             __byte_perm(vw[2][i], vw[3][i], 0x5410),
                             __byte_perm(vw[2][i], vw[3][i], 0x7632)};
      mma_bf16(acc[i], a, b0h, b1h);
      mma_bf16(acc[i], a, b0l, b1l);
    }
  }

  if (gq == 0) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sm.m[warp][2 * tq + e] = m[e];
      sm.l[warp][2 * tq + e] = l[e];
    }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    int dim;
    if constexpr (TAIL)
      dim = vdim<D>(i, gq);
    else
      dim = gq * (D / 8) + 2 * i;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sm.o[warp][2 * tq + e][dim] = acc[i][e];
      sm.o[warp][2 * tq + e][dim + 1] = acc[i][2 + e];
    }
  }
}

// The fp32 warp loop: keys [ks, ke) in 32-key steps strided over the warps,
// one key per lane for the scores, dims lane + 32 i per lane for the output.
// A 32-key step may span pages, so a paged cache is looked up per key.
template <int D, int KEYS, class P>
__device__ void warp_f32(const P& p, int bi, int kvh, int h0, int ge,
                         int ks, int ke, Smem<D>& sm) {
  // dims lane + 32 i per lane; at head dim 80 the third holds dims 64..79
  // on lanes 0..15 only
  constexpr int DL = (D + 31) / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* Q = static_cast<const float*>(p.q);
  const float* K = static_cast<const float*>(p.k);
  const float* V = static_cast<const float*>(p.v);
  VerifyState<P, HEADS> vs;  // verify: every column
  if constexpr (is_verify<P>) {
    vs.vc = VCols(p, bi, kvh);
    for (int idx = threadIdx.x; idx < HEADS * D; idx += THREADS) {
      const int h = idx / D, dd = idx % D;
      const int64_t r = vs.vc.row(p, h);
      sm.q[h][dd] = r >= 0 ? Q[r * D + dd] : 0.f;
    }
#pragma unroll
    for (int h = 0; h < HEADS; ++h) {
      vs.vc.col(p, h, vs.lim[h]);
      vs.lim[h] = min(vs.lim[h], ke);
    }
  } else {
    for (int idx = threadIdx.x; idx < HEADS * D; idx += THREADS) {
      const int h = idx / D, dd = idx % D;
      sm.q[h][dd] = h < ge ? Q[((int64_t)bi * p.hq + h0 + h) * D + dd] : 0.f;
    }
  }
  __syncthreads();

  float m[HEADS], l[HEADS], acc[HEADS][DL];
#pragma unroll
  for (int h = 0; h < HEADS; ++h) {
    m[h] = NEG_INF;
    l[h] = 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[h][i] = 0.f;
  }
  const int64_t row_stride = (int64_t)p.hkv * D;
  const float* Kb = K + ((int64_t)bi * p.S * p.hkv + kvh) * D;
  const float* Vb = V + ((int64_t)bi * p.S * p.hkv + kvh) * D;
  auto row = [&](const float* X, const float* Xb, int key) -> const float* {
    if constexpr (KEYS == CONTIGUOUS) return Xb + key * row_stride;
    return X + (page_row(p, bi, key) * p.hkv + kvh) * D;
  };
  for (int c0 = ks + 32 * warp; c0 < ke; c0 += 32 * WARPS) {
    const int key = c0 + lane;
    float s[HEADS];
#pragma unroll
    for (int h = 0; h < HEADS; ++h) s[h] = 0.f;
    float vsc = 0.f;  // quantized: the v_scale of the lane's key
    if constexpr (is_quant<P>) {
      if (key < ke) {
        const int64_t a = page_row(p, bi, key) * p.hkv + kvh;
        const uint8_t* kr = static_cast<const uint8_t*>(p.k) + a * D;
#pragma unroll 2
        for (int dd = 0; dd < D; dd += 16) {
          const uint4 raw = ld16(kr + dd);
          const uint8_t* kb = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
          for (int t = 0; t < 16; ++t) {
            const float kv = widen1<typename Payload<P>::type>(kb[t]);
#pragma unroll
            for (int h = 0; h < HEADS; ++h) s[h] += sm.q[h][dd + t] * kv;
          }
        }
        const float ksc = p.k_scale[a];
#pragma unroll
        for (int h = 0; h < HEADS; ++h) s[h] *= ksc;
        vsc = p.v_scale[a];
      }
    } else {
      if (key < ke) {
        const float* kr = row(K, Kb, key);
#pragma unroll 4
        for (int dd = 0; dd < D; dd += 4) {
          const float4 kv = *reinterpret_cast<const float4*>(kr + dd);
#pragma unroll
          for (int h = 0; h < HEADS; ++h)
            s[h] += sm.q[h][dd] * kv.x + sm.q[h][dd + 1] * kv.y +
                    sm.q[h][dd + 2] * kv.z + sm.q[h][dd + 3] * kv.w;
        }
      }
    }
    float pr[HEADS];
#pragma unroll
    for (int h = 0; h < HEADS; ++h) {
      float sv;
      if constexpr (is_verify<P>)
        sv = key < vs.lim[h] ? s[h] * p.scale_log2 : NEG_INF;
      else
        sv = key < ke && h < ge ? s[h] * p.scale_log2 : NEG_INF;
      float mx = sv;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[h], mx);
      pr[h] = sv <= NEG_INF / 2 ? 0.f : exp2f(sv - m_new);
      float rs = pr[h];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = exp2f(m[h] - m_new);
      l[h] = l[h] * corr + rs;
      m[h] = m_new;
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[h][i] *= corr;
    }
    if constexpr (is_quant<P>) {  // V row j weighed by p_j v_scale_j
#pragma unroll
      for (int h = 0; h < HEADS; ++h) pr[h] *= vsc;
    }
    const int n = min(32, ke - c0);
    for (int j = 0; j < n; ++j) {
      if constexpr (is_quant<P>) {
        const uint8_t* vr = static_cast<const uint8_t*>(p.v) +
                            (page_row(p, bi, c0 + j) * p.hkv + kvh) * D;
        float vv[DL];
#pragma unroll
        for (int i = 0; i < DL; ++i)
          vv[i] = widen1<typename Payload<P>::type>(vr[lane + 32 * i]);
#pragma unroll
        for (int h = 0; h < HEADS; ++h) {
          const float pj = __shfl_sync(0xffffffffu, pr[h], j);
#pragma unroll
          for (int i = 0; i < DL; ++i) acc[h][i] += pj * vv[i];
        }
        continue;
      }
      const float* vr = row(V, Vb, c0 + j);
      float vv[DL];
#pragma unroll
      for (int i = 0; i < DL; ++i)
        if constexpr (D % 32 == 0)
          vv[i] = vr[lane + 32 * i];
        else
          vv[i] = lane + 32 * i < D ? vr[lane + 32 * i] : 0.f;
#pragma unroll
      for (int h = 0; h < HEADS; ++h) {
        const float pj = __shfl_sync(0xffffffffu, pr[h], j);
#pragma unroll
        for (int i = 0; i < DL; ++i) acc[h][i] += pj * vv[i];
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < HEADS; ++h) {
      sm.m[warp][h] = m[h];
      sm.l[warp][h] = l[h];
    }
  }
#pragma unroll
  for (int h = 0; h < HEADS; ++h)
#pragma unroll
    for (int i = 0; i < DL; ++i)
      if constexpr (D % 32 == 0)
        sm.o[warp][h][lane + 32 * i] = acc[h][i];
      else if (lane + 32 * i < D)
        sm.o[warp][h][lane + 32 * i] = acc[h][i];
}

// One block of decode (P = Params, QParams) or verify (P = VParams,
// QVParams). Grid (column groups x splits, hkv x head groups, b), the
// column group fastest (decode: one).
template <typename T, int D, int KEYS, class P>
__device__ __forceinline__ void decode_block(const P& p) {
  __shared__ Smem<D> sm;
  int split;
  if constexpr (is_verify<P>)
    split = blockIdx.x / p.cgroups;
  else
    split = blockIdx.x;
  const int kvh = blockIdx.y / p.groups, grp = blockIdx.y % p.groups;
  const int bi = blockIdx.z;
  const int h0 = kvh * p.g + grp * HEADS;            // first query head
  int ge;  // heads in this group; verify: its HEADS columns
  if constexpr (is_verify<P>)
    ge = HEADS;
  else
    ge = min(HEADS, p.g - grp * HEADS);
  const int lo = p.kv_start ? max(p.kv_start[bi], 0) : 0;
  const int hi = p.kv_len ? min(p.kv_len[bi], p.S) : p.S;
  VerifyState<P, 1> vs;
  int ks, ke;
  if constexpr (is_verify<P>) {
    vs.vc = VCols(p, bi, kvh);
    split_range(0, vs.vc.end(p), p.n_split, split, ks, ke);
  } else {
    split_range(lo, hi, p.n_split, split, ks, ke);
  }

  if constexpr (sizeof(T) == 2)
    warp_bf16<D, KEYS>(p, bi, kvh, h0, ge, ks, ke, sm);
  else
    warp_f32<D, KEYS>(p, bi, kvh, h0, ge, ks, ke, sm);
  __syncthreads();

  // merge the warps: one (column, dim) per thread and step
  T* O = static_cast<T*>(p.o);
  for (int idx = threadIdx.x; idx < ge * D; idx += THREADS) {
    const int h = idx / D, dd = idx % D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm.m[w][h]);
    float l = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = sm.m[w][h] <= NEG_INF / 2 ? 0.f : exp2f(sm.m[w][h] - mx);
      l += sm.l[w][h] * wt;
      o += sm.o[w][h][dd] * wt;
    }
    int64_t r;
    if constexpr (is_verify<P>) {
      r = vs.vc.row(p, h);
      if (r < 0) continue;  // a column past T or g
    } else {
      r = (int64_t)bi * p.hq + h0 + h;
    }
    if (p.n_split == 1) {
      store(O + r * D + dd, mx <= NEG_INF / 2 ? 0.f : o / fmaxf(l, 1e-30f));
      continue;
    }
    float* part = p.part + (r * p.n_split + split) * (D + 2);
    if (dd == 0) {
      part[0] = mx;
      part[1] = l;
    }
    part[2 + dd] = o;
  }
  if (p.n_split == 1) return;

  // the last split of this (row, kv head, group, column group) to finish
  // merges them all
  __threadfence();
  __syncthreads();
  int* counter;
  if constexpr (is_verify<P>)
    counter = p.counters +
              (((int64_t)bi * p.hkv + kvh) * p.groups + grp) * p.cgroups +
              vs.vc.cg;
  else
    counter = p.counters + ((int64_t)bi * p.hkv + kvh) * p.groups + grp;
  if (threadIdx.x == 0)
    sm.last = atomicAdd(counter, 1) == p.n_split - 1;
  __syncthreads();
  if (!sm.last) return;
  __threadfence();
  // each split's weight per head (its m against the heads' max; its l
  // summed), then every output column as one pass of independent loads
  const int64_t r0 = (int64_t)bi * p.hq + h0;  // the group's first row
  for (int idx = threadIdx.x; idx < ge * p.n_split; idx += THREADS) {
    const int h = idx / p.n_split, s = idx % p.n_split;
    const float* ps;
    if constexpr (is_verify<P>) {
      const int64_t r = vs.vc.row(p, h);
      if (r < 0) continue;
      ps = p.part + (r * p.n_split + s) * (D + 2);
    } else {
      ps = p.part + ((r0 + h) * p.n_split + s) * (D + 2);
    }
    sm.wm[h][s] = __ldcg(ps);
    sm.wl[h][s] = __ldcg(ps + 1);
  }
  __syncthreads();
  if (threadIdx.x < ge) {
    const int h = threadIdx.x;
    float mx = NEG_INF, l = 0.f;
    for (int s = 0; s < p.n_split; ++s) mx = fmaxf(mx, sm.wm[h][s]);
    for (int s = 0; s < p.n_split; ++s) {
      const float w = sm.wm[h][s] <= NEG_INF / 2 ? 0.f
                                                 : exp2f(sm.wm[h][s] - mx);
      sm.wm[h][s] = w;
      l += sm.wl[h][s] * w;
    }
    sm.inv[h] = mx <= NEG_INF / 2 ? 0.f : 1.f / fmaxf(l, 1e-30f);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < ge * D; idx += THREADS) {
    const int h = idx / D, dd = idx % D;
    int64_t vr = 0;  // verify: the output row
    const float* ps;
    if constexpr (is_verify<P>) {
      vr = vs.vc.row(p, h);
      if (vr < 0) continue;
      ps = p.part + vr * p.n_split * (D + 2) + 2 + dd;
    } else {
      ps = p.part + (r0 + h) * p.n_split * (D + 2) + 2 + dd;
    }
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    int s = 0;
    for (; s + 4 <= p.n_split; s += 4)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        o[u] += sm.wm[h][s + u] * __ldcg(ps + (s + u) * (D + 2));
    for (; s < p.n_split; ++s) o[0] += sm.wm[h][s] * __ldcg(ps + s * (D + 2));
    if constexpr (is_verify<P>)
      store(O + vr * D + dd, (o[0] + o[1] + o[2] + o[3]) * sm.inv[h]);
    else
      store(O + (r0 + h) * D + dd, (o[0] + o[1] + o[2] + o[3]) * sm.inv[h]);
  }
  if (threadIdx.x == 0) *counter = 0;  // ready for the next launch
}

template <typename T, int D, int KEYS, class P = Params>
__global__ void __launch_bounds__(THREADS) decode_fwd(const P p) {
  decode_block<T, D, KEYS>(p);
}

// Quantized pools: minBlocksPerMultiprocessor 1 keeps ptxas from trading a
// few bytes of spills for one more resident block at its occupancy
// thresholds, which it does on some of these instances without it
template <typename T, int D, int KEYS, class KV>
__global__ void __launch_bounds__(THREADS, 1)
    decode_fwd(const QParams<KV> p) {
  decode_block<T, D, KEYS>(p);
}
template <typename T, int D, int KEYS, class KV>
__global__ void __launch_bounds__(THREADS, 1)
    decode_fwd(const QVParams<KV> p) {
  decode_block<T, D, KEYS>(p);
}

// Head dim 80 (the contiguous decode only): minBlocksPerMultiprocessor 1,
// as the quantized kernels have; without it ptxas caps the bf16 instance
// at 96 registers and spills 8 bytes
template <typename T, int KEYS>
__global__ void __launch_bounds__(THREADS, 1) decode_fwd80(const Params p) {
  decode_block<T, 80, KEYS>(p);
}

// Head dim 256 (the contiguous decode only, paligemma-3b's):
// minBlocksPerMultiprocessor 1 too, so ptxas may give a thread up to 255
// registers
template <typename T, int KEYS>
__global__ void __launch_bounds__(THREADS, 1) decode_fwd256(const Params p) {
  decode_block<T, 256, KEYS>(p);
}

template <typename T, int KEYS, class P>
cudaError_t launch_t(const P& p, int d, cudaStream_t stream) {
  int cgroups = 1;  // verify's column groups
  if constexpr (is_verify<P>) cgroups = p.cgroups;
  dim3 grid(p.n_split * cgroups, p.hkv * p.groups, p.b);
  switch (d) {
    case 32:
      decode_fwd<T, 32, KEYS><<<grid, THREADS, 0, stream>>>(p);
      break;
    case 64:
      decode_fwd<T, 64, KEYS><<<grid, THREADS, 0, stream>>>(p);
      break;
    case 80:  // h2o-danube-1.8b: the contiguous decode only
      if constexpr (KEYS == CONTIGUOUS && std::is_same<P, Params>::value)
        decode_fwd80<T, KEYS><<<grid, THREADS, 0, stream>>>(p);
      else
        return cudaErrorInvalidValue;
      break;
    case 128:
      decode_fwd<T, 128, KEYS><<<grid, THREADS, 0, stream>>>(p);
      break;
    case 256:  // paligemma-3b: the contiguous decode only
      if constexpr (KEYS == CONTIGUOUS && std::is_same<P, Params>::value)
        decode_fwd256<T, KEYS><<<grid, THREADS, 0, stream>>>(p);
      else
        return cudaErrorInvalidValue;
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Checks shared by the entries; fills the head grouping and the scale.
// n_counters: the merge counters' entries (needed when n_split > 1).
inline cudaError_t prepare(Params& p, float scale, int n_counters) {
  if (p.hkv <= 0 || p.hq % p.hkv != 0 || p.n_split < 1 ||
      p.n_split > MAX_SPLITS)
    return cudaErrorInvalidValue;
  p.g = p.hq / p.hkv;
  p.groups = (p.g + HEADS - 1) / HEADS;
  if (p.n_split > 1 &&
      (!p.part || !p.counters ||
       (int64_t)p.b * p.hkv * p.groups > (int64_t)n_counters))
    return cudaErrorInvalidValue;
  p.scale_log2 = scale * 1.4426950408889634f;
  return cudaSuccess;
}

// prepare for verify: the column packing (cp candidates of a block's
// HEADS columns, cgroups column groups) and its merge counters
inline cudaError_t prepare_verify(VParams& p, float scale, int n_counters) {
  if (!p.q_origin || !p.kv_len || p.T < 1 || p.kv_start)
    return cudaErrorInvalidValue;
  const cudaError_t e = prepare(p, scale, n_counters);
  if (e != cudaSuccess) return e;
  p.cp = 1;  // at g >= HEADS: one candidate, a head group per block
  if (p.g < HEADS) p.cp = p.T < HEADS / p.g ? p.T : HEADS / p.g;
  p.cgroups = (p.T + p.cp - 1) / p.cp;
  if (p.n_split > 1 &&
      (int64_t)p.b * p.hkv * p.groups * p.cgroups > (int64_t)n_counters)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace dk
