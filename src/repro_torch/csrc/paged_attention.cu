// Paged attention for Hopper (sm_90a): decode, context prefill and
// speculative verification against a block-paged KV pool
// (n_blocks, block_size, hkv, d) read through per-row block tables
// (b, max_blocks), with the pool in q's dtype or quantized (int8 / fp8 e4m3
// payload plus fp32 per-token-per-head scale pools (n_blocks, block_size,
// hkv)).
//
// Replaces, in src/repro/kernels/paged_attention.py:
//  - paged_decode_attention_pallas (one query token per row, kv_len mask):
//    paged_decode_attention_fwd, bf16 and fp32, on the GQA decode body of
//    decode.cuh (dk::decode_fwd) with its keys read through the block
//    table: one block of 4 warps per (row, kv head, <= 8 query heads,
//    split), K and V rows straight to registers, S^T and O^T on mma.sync,
//    the splits merged in the same launch. Any block size: a page holds
//    whole 16-key groups when bs % 16 == 0 (one lookup per group), else
//    each key is looked up. Its split count comes from the table's
//    capacity (kernels/decode_attention.py:contiguous_splits) and its merge
//    counters are its own buffer, checked against b x hkv x head groups.
//  - paged_verify_attention_pallas (T = k + 1 candidates per slot at the
//    slot's committed length kv_start, the output kept at every position):
//    paged_verify_attention_fwd, bf16 and fp32, on the same decode body
//    with query columns that are (candidate, head) pairs (decode.cuh,
//    dk::VParams): candidate t sees keys [0, min(kv_len, kv_start + t + 1)),
//    each block's 8 columns are max(1, 8 / g) candidates of g heads, its
//    split count counts the column groups (kernels/paged_attention.py:
//    paged_verify_splits) and its merge counters are its own.
//  - paged_context_attention_pallas (a C-token chunk at absolute offset
//    q_start, causal over the prior pages and itself; rows that see no key
//    give exact zeros): paged_context_attention_fwd in bf16 on the wgmma
//    body below (pc::context_fwd); in fp32 on attention.cuh's scalar body.
//  - #2, #3 and #4 on pools of the other unquantized width (an fp32 model
//    on a bf16 pool, a bf16 model on an fp32 pool; kv_type 3 and 4 of the
//    unquantized entries): decode and verify on the decode body's MParams /
//    MVParams (decode.cuh), fp32 context on attention.cuh's scalar body
//    with bf16 K/V widened in the load, bf16 context on context_fwd<float>,
//    whose gathering threads narrow each fp32 key row to bf16 on its way
//    into the tile.
//  - paged_context_attention_quant_pallas (#3 on int8 / fp8 pools):
//    paged_context_attention_quant_fwd in bf16 on the same wgmma body, its
//    one-byte K/V widened to bf16 by the gathering warps and the scales
//    folded into scores and probabilities; in fp32 on attention.cuh's
//    scalar body.
//  - paged_decode_attention_quant_pallas and paged_verify_attention_quant_
//    pallas (#2 and #4 on int8 / fp8 pools): the *_quant_fwd entries, bf16
//    and fp32, on the same decode body (dk::QParams / dk::QVParams: the
//    payload type and the scale pools), which reads each key row's
//    one-byte K and V, widens them exactly in registers and folds the
//    scales into scores and probabilities; never a dequantized page. Split
//    counts and merge counters as #2's and #4's, the counters a buffer of
//    each kernel's own.
//
// Bound on the card: a decode step does ~4 d hq kv_len FLOPs per row on
// 2 d hkv kv_len K/V elements, a few FLOPs per byte, so it is bound by bytes
// (reading the live pages); decode.cuh keeps 8 KB of them in flight per
// warp. A context chunk does C / 2 times more work per key row and is bound
// by operations at serving lengths; only wgmma reaches the tensor cores'
// rate, so context_fwd is flash_fwd's design (flash.cuh) with its K/V tiles
// gathered through the block table:
//
//  - A CTA is three warpgroups. In the producer warpgroup one thread TMA-
//    loads each work item's Q rows (two Q buffers), another TMA-stores its
//    O, and two warps gather the K and V tiles (TILE_KEYS keys, one key row
//    per thread: one table lookup, then 16-byte cp.async copies into the
//    same 128-byte (64-byte at d 32) swizzle the wgmma descriptors read,
//    zero-filled past the item's last key) into a ring of STAGES, each
//    stage with full / empty mbarriers for K and for V. TMA cannot gather
//    rows, and one TMA per page would leave block sizes that do not divide
//    the tile to another body; the gather takes every bs >= 1.
//  - One-byte pools (#6): the gathering threads cannot cp.async, which
//    copies bytes. Each issues its key row's 16-byte loads (D / 16 of K
//    and of V, and both scales) before waiting for the stage, widens them
//    exactly to bf16 (widen16), stores them with st.shared into the same
//    swizzle, writes the key's scales into the stage's scale arrays (zeros
//    and scale 0 past the item's last key), fences to the async proxy and
//    arrives on the full barrier. The K and V rows in registers need a
//    larger share of the register file (WIDE_PRODUCER_REGS). Consumers
//    multiply S's
//    column j by k_scale[j] before the running max and P's column j by
//    v_scale[j] before its high / low split (the row sum keeps the
//    unscaled P), as attention.cuh does; they wait for a tile's V (and its
//    scales) before its softmax.
//  - Consumer warpgroups 1 and 2 own 64 rows each: P = 64 / g positions x
//    the g query heads of ONE kv head. S = Q K^T as wgmma (Q in registers,
//    K from shared memory), the online softmax on the accumulators, and
//    O += P V with P in registers; tile t's S is issued with tile t - 1's
//    P V. P is split into a bf16 high part and the bf16 of its remainder
//    (two P V products, ~16 bits of P) as attention.cuh's mma.sync body
//    does, so the prefix path's numerics stay where they were.
//  - Query j of row i sits at q_start[i] + j and sees keys <= its position
//    and < kv_len[i]; an item's key loop ends at min(kv_len, q_start + its
//    last position + 1).
//  - CTAs are persistent, one per SM, and walk the items (row tile, b, kv
//    head) longest first: the lengths depend on q_start and kv_len, which
//    are on the device, so every CTA ranks the (row tile, b) units itself
//    at the start (O(b) per unit: a row's lengths grow with its row tile)
//    into the same order.
//
// Rows of free slots (all-null tables) read the trash page and come out
// finite; their values are discarded by the caller.
#include <type_traits>

#include "attention.cuh"
#include "decode.cuh"
#include "flash.cuh"

namespace pc {

using bf16 = __nv_bfloat16;
using fa::NC;
using fa::NEG_INF;
using fa::WG_ROWS;
constexpr int TILE_KEYS = 64;   // keys per K/V tile
constexpr int STAGES = 3;       // K (and V) tiles in flight
constexpr int GATHER = 64;      // producer threads that gather K/V (warps 2-3)
static_assert(GATHER == TILE_KEYS, "one key row per gathering thread");
// registers a thread: the producer warpgroup gives its to the consumers
// (PRODUCER_REGS + NC CONSUMER_REGS <= 3 x 168, what the launch gives the
// three warpgroups); on one-byte pools the gathering threads hold a key
// row's loads, so the producer keeps more
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;
constexpr int WIDE_PRODUCER_REGS = 104, WIDE_CONSUMER_REGS = 192;
// (row tile, b) units ranked in shared memory; past this many the items
// run row tiles longest first without ranking the rows
constexpr int ORDER_CAP = 2048;

struct Params {
  const void* k;        // pools (n_blocks, bs, hkv, d)
  const void* v;
  const int* tables;    // (b, max_blocks)
  const int* q_start;   // (b,)
  const int* kv_len;    // (b,)
  int b, C, hq, hkv, g, P, bs, max_blocks;
  int causal, window;   // 1 and 0: what fa::softmax_tile reads
  float scale_log2;
  int n_mtiles, units, items;  // units: n_mtiles x b; items: units x hkv
  const float* k_scale;  // one-byte pools: (n_blocks, bs, hkv) fp32 scales
  const float* v_scale;
};

// Live keys of row bi: [0, kv_end)
__device__ __forceinline__ int kv_end_of(const Params& p, int bi) {
  return min(max(p.kv_len[bi], 0), p.max_blocks * p.bs);
}

// Keys that row tile mt of row bi may see: [0, len)
__device__ __forceinline__ int unit_len(const Params& p, int bi, int mt) {
  return max(0, min(kv_end_of(p, bi),
                    p.q_start[bi] + min((mt + 1) * NC * p.P, p.C)));
}

// The first row tile of row bi that sees more than L >= 0 keys (n_mtiles if
// none): a row tile's length grows with mt
__device__ __forceinline__ int first_longer(const Params& p, int bi, int L) {
  const int qs = p.q_start[bi];
  if (kv_end_of(p, bi) <= L || qs + p.C <= L) return p.n_mtiles;
  return L < qs ? 0 : (L - qs) / (NC * p.P);
}

// order[t]: the unit (bi n_mtiles + mt) of rank t, longest first; ties go
// to the lower row, then to the later row tile. Every CTA computes the
// same order.
__device__ void rank_units(const Params& p, int* order) {
  if (p.units > ORDER_CAP) return;
  for (int u = threadIdx.x; u < p.units; u += blockDim.x) {
    const int bi = u / p.n_mtiles, mt = u % p.n_mtiles;
    const int L = unit_len(p, bi, mt);
    int rank = p.n_mtiles - 1 - mt;  // this row's later tiles
    for (int b2 = 0; b2 < p.b; ++b2) {
      if (b2 == bi) continue;
      // units of a lower row at least as long, of a higher row longer
      const int first = b2 < bi ? (L > 0 ? first_longer(p, b2, L - 1) : 0)
                                : first_longer(p, b2, L);
      rank += p.n_mtiles - first;
    }
    order[rank] = u;
  }
}

__device__ __forceinline__ int unit_of(const Params& p, const int* order,
                                       int t) {
  if (p.units <= ORDER_CAP) return order[t];
  const int mt = p.n_mtiles - 1 - t / p.b, bi = t % p.b;
  return bi * p.n_mtiles + mt;
}

// One work item: positions [pos0, pos0 + NC P) of kv head kvh of row bi,
// whose query 0 sits at qs; the row's live keys [0, kv_end), of which the
// item's rows see [0, hi)
struct Item {
  int bi, kvh, pos0, qs, kv_end, hi;
};

__device__ __forceinline__ Item item_at(const Params& p, const int* order,
                                        int t) {
  Item it;
  const int u = unit_of(p, order, t / p.hkv);
  it.kvh = t % p.hkv;
  it.bi = u / p.n_mtiles;
  it.pos0 = (u % p.n_mtiles) * NC * p.P;
  it.qs = p.q_start[it.bi];
  it.kv_end = kv_end_of(p, it.bi);
  const int last = min(it.pos0 + NC * p.P, p.C) - 1;
  it.hi = max(0, min(it.kv_end, it.qs + last + 1));
  return it;
}

// KV: the pools' payload (bf16, or one byte: int8_t, __nv_fp8_e4m3, whose
// tiles are widened to bf16 and whose scales sit per stage after the
// barriers; or float, whose tiles are narrowed to bf16)
template <typename KV, int D>
struct Smem {
  static constexpr int TILE = TILE_KEYS * D * 2;  // one bf16 K (or V) tile
  static constexpr size_t K = 0;
  static constexpr size_t V = K + (size_t)STAGES * TILE;
  static constexpr size_t Q = V + (size_t)STAGES * TILE;  // [2][NC] buffers
  static constexpr size_t ORDER = Q + (size_t)2 * NC * fa::Geo<D>::QBYTES;
  static constexpr size_t BAR = ORDER + (size_t)ORDER_CAP * 4;
  // one-byte pools: [STAGES][TILE_KEYS] K scales, then V scales
  static constexpr size_t SCALE = BAR + (4 * STAGES + 6) * 8;
  static constexpr size_t BYTES =
      SCALE + (sizeof(KV) == 1 ? 2 * STAGES * TILE_KEYS * 4 : 0) + 1024;
};

// Gather one K or V tile: key k0 + j (j: this thread) of row `it` from the
// pool X into the swizzled tile at dst; keys past the item's last read as
// zeros
template <int D>
__device__ __forceinline__ void gather(unsigned char* dst, const bf16* X,
                                       const Params& p, const Item& it,
                                       int64_t row, bool live, int j) {
  using G = fa::Geo<D>;
  const bf16* src = X + (row * p.hkv + it.kvh) * D;
#pragma unroll
  for (int u = 0; u < D / 8; ++u)
    hx::cp_async16(dst + G::template tile_off<TILE_KEYS>(j, u),
                   live ? src + 8 * u : X, live ? 16 : 0);
}

// 16 one-byte K/V elements -> 16 bf16 (two 16-byte units), exact
// (dk::widen2)
template <typename KV>
__device__ __forceinline__ void widen16(const uint4& raw, uint4 (&out)[2]) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&raw);
  uint32_t* o = reinterpret_cast<uint32_t*>(out);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = dk::widen2<KV>(w[i / 2], i % 2);
}

// fp32 pools: key row `row` (of kv head it.kvh) of X narrowed to bf16 into
// row j of the swizzled tile at dst (zeros for a key past the item's last),
// 16 bytes of the tile at a time, then one arrival on full; the stage must
// be free (the caller waited on its empty barrier)
template <int D>
__device__ __forceinline__ void narrow_row(unsigned char* dst,
                                           const float* X, const Params& p,
                                           const Item& it, int64_t row,
                                           bool live, int j, uint64_t* full) {
  using G = fa::Geo<D>;
  const float4* src = reinterpret_cast<const float4*>(
      X + (row * p.hkv + it.kvh) * D);
  const uint32_t tile = hx::smem_u32(dst);
#pragma unroll 4
  for (int u = 0; u < D / 8; ++u) {
    const float4 a = live ? __ldg(src + 2 * u) : make_float4(0, 0, 0, 0);
    const float4 b = live ? __ldg(src + 2 * u + 1) : make_float4(0, 0, 0, 0);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                     tile + G::template tile_off<TILE_KEYS>(j, u)),
                 "r"(fa::pack_bf16(a.x, a.y)), "r"(fa::pack_bf16(a.z, a.w)),
                 "r"(fa::pack_bf16(b.x, b.y)), "r"(fa::pack_bf16(b.z, b.w))
                 : "memory");
  }
  hx::fence_proxy_async();  // the stores, to the consumers' wgmma
  hx::mbar_arrive(full);
}

// Pool row of key `key` of item `it`, or 0 past its last key
__device__ __forceinline__ int key_row(const Params& p, const Item& it,
                                       int key) {
  return key < it.hi ? p.tables[(int64_t)it.bi * p.max_blocks + key / p.bs] *
                               p.bs + key % p.bs
                     : 0;
}

// One-byte pools: a key row's payload (D / 16 16-byte loads) and scale
template <int D>
struct RawRow {
  uint4 u[D / 16];
  float scale;
};

// Load key row `row` (of kv head it.kvh) from the payload pool X and the
// scale pool XS, or zeros and scale 0 for a key past the item's last
template <typename KV, int D>
__device__ __forceinline__ void load_row(RawRow<D>& r, const KV* X,
                                         const float* XS, const Params& p,
                                         const Item& it, int row, bool live) {
  const int64_t at = (int64_t)row * p.hkv + it.kvh;
  const uint4* src = reinterpret_cast<const uint4*>(X + at * D);
#pragma unroll
  for (int u = 0; u < D / 16; ++u)
    r.u[u] = live ? __ldg(src + u) : make_uint4(0, 0, 0, 0);
  r.scale = live ? __ldg(XS + at) : 0.f;
}

// Widen row r into row j of the swizzled bf16 tile at dst and its scale
// into the stage's scales sc, once the consumers have released the stage
// (empty, parity); then one arrival on full. Shared-space addresses and
// st.shared keep the producer's registers for the rows in flight.
template <typename KV, int D>
__device__ __forceinline__ void store_row(unsigned char* dst, float* sc,
                                          const RawRow<D>& r, int j,
                                          uint64_t* empty, int parity,
                                          uint64_t* full) {
  using G = fa::Geo<D>;
  hx::mbar_wait(empty, parity);
  // j, opaque to the compiler: the tile offsets that follow from it are
  // computed here, not held in registers across the producer's loop
  asm volatile("" : "+r"(j));
  const uint32_t tile = hx::smem_u32(dst);
#pragma unroll
  for (int u = 0; u < D / 16; ++u) {
    // one 16-byte unit at a time: the opaque copy keeps the compiler from
    // widening the next units (and holding their results) ahead of these
    // stores
    uint4 x = r.u[u];
    asm volatile("" : "+r"(x.x), "+r"(x.y), "+r"(x.z), "+r"(x.w));
    uint4 w[2];
    widen16<KV>(x, w);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                       tile + G::template tile_off<TILE_KEYS>(j, 2 * u + h)),
                   "r"(w[h].x), "r"(w[h].y), "r"(w[h].z), "r"(w[h].w)
                   : "memory");
  }
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(hx::smem_u32(sc + j)),
               "f"(r.scale)
               : "memory");
  hx::fence_proxy_async();  // the stores, to the consumers' wgmma
  hx::mbar_arrive(full);
}

// s (a consumer thread's S or P accumulators of one tile) times the scale
// of each column's key, from the tile's scales at shared-space address sc:
// column pair (i, i + 1) is keys 8 (i / 4) + 2 tq, + 1 of the tile
// (fa::softmax_tile's layout)
template <int BK>
__device__ __forceinline__ void scale_cols(float (&s)[BK / 2], uint32_t sc) {
  const uint32_t at = sc + 8 * (threadIdx.x % 4);  // 2 tq floats on
#pragma unroll
  for (int i = 0; i < BK / 2; i += 2) {
    float2 f;
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                 : "=f"(f.x), "=f"(f.y)
                 : "r"(at + 32 * (i / 4)));
    s[i] *= f.x;
    s[i + 1] *= f.y;
  }
}

// One-byte pools: P split in two (fa::PSplit) after its column j is
// weighed by key j's V scale; fa::softmax_tile packs it through pack_p
// below, after the row sums took the unscaled P
template <int BK>
struct PScaled : fa::PSplit<BK> {
  uint32_t vs;  // the tile's V scales (shared-space address)
};
template <int BK>
__device__ __forceinline__ void pack_p(PScaled<BK>& pa,
                                       float (&s)[BK / 2]) {
  scale_cols<BK>(s, pa.vs);
  fa::pack_p<BK>(static_cast<fa::PSplit<BK>&>(pa), s);
}

template <typename KV, int D>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
    context_fwd(const Params p, const __grid_constant__ CUtensorMap tmq,
                const __grid_constant__ CUtensorMap tmo) {
  using G = fa::Geo<D>;
  using S = Smem<KV, D>;
  constexpr int BK = TILE_KEYS;
  constexpr bool WIDE = sizeof(KV) == 1;  // a one-byte pool
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  int* order = reinterpret_cast<int*>(smem + S::ORDER);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::BAR);
  const fa::Ring rg{bars, bars + STAGES, bars + 2 * STAGES,
                    bars + 3 * STAGES};
  uint64_t* qfull = bars + 4 * STAGES;  // a Q buffer holds its item's Q
  uint64_t* staged = qfull + 2;         // ... its item's O
  uint64_t* qempty = staged + 2;        // ... nothing: O is stored
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hx::mbar_init(&rg.kfull[s], GATHER);   // one per gathering thread
      hx::mbar_init(&rg.vfull[s], GATHER);
      hx::mbar_init(&rg.kempty[s], 4 * NC);  // one per consumer warp
      hx::mbar_init(&rg.vempty[s], 4 * NC);
    }
    for (int b = 0; b < 2; ++b) {
      hx::mbar_init(&qfull[b], 1);
      hx::mbar_init(&staged[b], 4 * NC);
      hx::mbar_init(&qempty[b], 1);
    }
    hx::mbar_fence_init();
  }
  rank_units(p, order);
  __syncthreads();

  if (wgi == 0) {
    // producer: thread 0 TMA-loads each item's Q, thread 32 TMA-stores
    // its O once the consumers staged it, warps 2 and 3 gather K and V
    hx::setmaxnreg_dec<WIDE ? WIDE_PRODUCER_REGS : PRODUCER_REGS>();
    if (threadIdx.x == 32) {
      int j = 0;
      for (int r = 0; r * (int)gridDim.x < p.items; ++r) {
        const int t = fa::item_of_round(r);
        if (t >= p.items) continue;
        const Item it = item_at(p, order, t);
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
    if (threadIdx.x == 0) {
      int n = 0;
      for (int r = 0; r * (int)gridDim.x < p.items; ++r) {
        const int t = fa::item_of_round(r);
        if (t >= p.items) continue;
        const Item it = item_at(p, order, t);
        const int qb = n & 1;
        hx::mbar_wait(&qempty[qb], ((n >> 1) & 1) ^ 1);
        hx::mbar_arrive_tx(&qfull[qb], NC * p.P * p.g * D * 2);
        for (int w = 0; w < NC; ++w) {
          unsigned char* q = smem + S::Q + (size_t)(qb * NC + w) * G::QBYTES;
#pragma unroll
          for (int c = 0; c < G::NCH; ++c)
            hx::tma_load_4d(q + c * WG_ROWS * G::ROWB, &tmq, &qfull[qb],
                            c * G::CH, it.kvh * p.g, it.pos0 + w * p.P,
                            it.bi);
        }
        ++n;
      }
      return;
    }
    if (threadIdx.x < 64) return;
    const int j = threadIdx.x - 64;  // this thread's key of every tile
    if constexpr (WIDE) {
      float* ksc = reinterpret_cast<float*>(smem + S::SCALE);
      float* vsc = ksc + STAGES * BK;
      int stage = 0, phase = 0;
      for (int r = 0; r * (int)gridDim.x < p.items; ++r) {
        const int t = fa::item_of_round(r);
        if (t >= p.items) continue;
        const Item it = item_at(p, order, t);
        for (int k0 = 0; k0 < it.hi; k0 += BK) {
          const bool live = k0 + j < it.hi;
          const int row = key_row(p, it, k0 + j);
          RawRow<D> kr, vr;  // both rows in flight before either waits
          load_row<KV, D>(kr, static_cast<const KV*>(p.k), p.k_scale, p, it,
                          row, live);
          load_row<KV, D>(vr, static_cast<const KV*>(p.v), p.v_scale, p, it,
                          row, live);
          store_row<KV, D>(smem + S::K + (size_t)stage * S::TILE,
                           ksc + stage * BK, kr, j, &rg.kempty[stage],
                           phase ^ 1, &rg.kfull[stage]);
          store_row<KV, D>(smem + S::V + (size_t)stage * S::TILE,
                           vsc + stage * BK, vr, j, &rg.vempty[stage],
                           phase ^ 1, &rg.vfull[stage]);
          fa::advance<STAGES>(stage, phase);
        }
      }
      return;
    }
    if constexpr (std::is_same<KV, float>::value) {
      const float* K = static_cast<const float*>(p.k);
      const float* V = static_cast<const float*>(p.v);
      int stage = 0, phase = 0;
      for (int r = 0; r * (int)gridDim.x < p.items; ++r) {
        const int t = fa::item_of_round(r);
        if (t >= p.items) continue;
        const Item it = item_at(p, order, t);
        for (int k0 = 0; k0 < it.hi; k0 += BK) {
          const bool live = k0 + j < it.hi;
          const int64_t row = key_row(p, it, k0 + j);
          hx::mbar_wait(&rg.kempty[stage], phase ^ 1);
          narrow_row<D>(smem + S::K + (size_t)stage * S::TILE, K, p, it, row,
                        live, j, &rg.kfull[stage]);
          hx::mbar_wait(&rg.vempty[stage], phase ^ 1);
          narrow_row<D>(smem + S::V + (size_t)stage * S::TILE, V, p, it, row,
                        live, j, &rg.vfull[stage]);
          fa::advance<STAGES>(stage, phase);
        }
      }
      return;
    }
    const bf16* K = static_cast<const bf16*>(p.k);
    const bf16* V = static_cast<const bf16*>(p.v);
    int stage = 0, phase = 0;
    for (int r = 0; r * (int)gridDim.x < p.items; ++r) {
      const int t = fa::item_of_round(r);
      if (t >= p.items) continue;
      const Item it = item_at(p, order, t);
      for (int k0 = 0; k0 < it.hi; k0 += BK) {
        const int key = k0 + j;
        const bool live = key < it.hi;
        const int64_t row =
            live ? (int64_t)p.tables[(int64_t)it.bi * p.max_blocks +
                                     key / p.bs] * p.bs + key % p.bs
                 : 0;
        hx::mbar_wait(&rg.kempty[stage], phase ^ 1);
        gather<D>(smem + S::K + (size_t)stage * S::TILE, K, p, it, row,
                  live, j);
        hx::cp_async_arrive(&rg.kfull[stage]);
        hx::mbar_wait(&rg.vempty[stage], phase ^ 1);
        gather<D>(smem + S::V + (size_t)stage * S::TILE, V, p, it, row,
                  live, j);
        hx::cp_async_arrive(&rg.vfull[stage]);
        fa::advance<STAGES>(stage, phase);
      }
    }
    hx::cp_async_wait_all();
    return;
  }

  // consumers
  hx::setmaxnreg_inc<WIDE ? WIDE_CONSUMER_REGS : CONSUMER_REGS>();
  const int wg = wgi - 1;
  const int tid = threadIdx.x - 128 * wgi;
  const int warp = tid / 32, lane = tid % 32, gq = lane / 4, tq = lane % 4;
  const fa::Turns turn{wg};
  if (wg == NC - 1) turn.end();  // warpgroup 0 issues first
  int stage = 0, phase = 0, n = 0;
  for (int r = 0; r * (int)gridDim.x < p.items; ++r) {
    const int t = fa::item_of_round(r);
    if (t >= p.items) continue;
    const Item it = item_at(p, order, t);
    const int qb = n & 1;
    unsigned char* qs = smem + S::Q + (size_t)(qb * NC + wg) * G::QBYTES;

    // this warpgroup's positions (absolute: q_start + position) and the
    // keys they may see
    const int pos0 = it.pos0 + wg * p.P;
    const bool any = pos0 < p.C;
    const int last = min(pos0 + p.P, p.C) - 1;
    const int hi_w = max(0, min(it.kv_end, it.qs + last + 1));
    const int ra = warp * 16 + gq;
    const fa::Rows rw{0,
                      it.kv_end,
                      it.qs + pos0,
                      it.qs + last,
                      {it.qs + pos0 + ra / p.g, it.qs + pos0 + (ra + 8) / p.g},
                      tq};

    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    // P of the previous tile, high and low parts
    std::conditional_t<WIDE, PScaled<BK>, fa::PSplit<BK>> pa;
    // one-byte pools: S of the tile at stage st (phase ph) times its K
    // scales, before the stage's K is released; and its V scales for
    // pack_p, which the producer writes with the V tile: so the V tile is
    // waited for here, before the softmax, not before its P V
    auto fold = [&](float (&s)[BK / 2], int st, int ph) {
      if constexpr (WIDE) {
        const uint32_t ksc = hx::smem_u32(smem + S::SCALE) + 4 * st * BK;
        scale_cols<BK>(s, ksc);
        hx::mbar_wait(&rg.vfull[st], ph);
        pa.vs = ksc + 4 * STAGES * BK;
      }
    };

    // tiles [0, it.hi): the run this warpgroup's rows see is computed, each
    // tile's S issued with the previous tile's P V, so no wgmma sits in a
    // branch; the trailing run (the item's other rows see it) only passes
    const int c_hi = any ? min(it.hi, hi_w) : 0;
    int k0 = 0;
    hx::mbar_wait(&qfull[qb], (n >> 1) & 1);
    uint32_t qf[D / 16][4];  // Q's A fragments, for the whole item
    fa::load_q_frags<D>(qf, qs, warp, lane);
    if (k0 < c_hi) {
      float s[BK / 2];
      const unsigned char* kt = smem + S::K + (size_t)stage * S::TILE;
      hx::mbar_wait(&rg.kfull[stage], phase);
      hx::fence_proxy_async();  // the gathered tile, to the async proxy
      turn.begin();
      fa::issue_qk<D, BK>(s, qf, kt);
      turn.end();
      hx::wgmma_wait<0>();
      hx::fence_regs(s);
      fold(s, stage, phase);
      if (lane == 0) hx::mbar_arrive(&rg.kempty[stage]);
      fa::softmax_tile<D, BK, true>(s, m, l, o, pa, p, rw, k0, nullptr,
                                    lane);
      int prev = stage, prev_phase = phase;
      fa::advance<STAGES>(stage, phase);
      for (k0 += BK; k0 < c_hi; k0 += BK) {
        kt = smem + S::K + (size_t)stage * S::TILE;
        hx::mbar_wait(&rg.kfull[stage], phase);
        hx::mbar_wait(&rg.vfull[prev], prev_phase);
        hx::fence_proxy_async();
        turn.begin();
        fa::issue_qk<D, BK>(s, qf, kt);
        fa::issue_pv_split<D, BK>(o, pa,
                                  smem + S::V + (size_t)prev * S::TILE);
        turn.end();
        hx::wgmma_wait<1>();
        hx::fence_regs(s);
        fold(s, stage, phase);
        if (lane == 0) hx::mbar_arrive(&rg.kempty[stage]);
        fa::softmax_tile<D, BK, false>(s, m, l, o, pa, p, rw, k0,
                                       &rg.vempty[prev], lane);
        prev = stage;
        prev_phase = phase;
        fa::advance<STAGES>(stage, phase);
      }
      hx::mbar_wait(&rg.vfull[prev], prev_phase);
      hx::fence_proxy_async();
      turn.begin();
      fa::issue_pv_split<D, BK>(o, pa,
                                smem + S::V + (size_t)prev * S::TILE);
      turn.end();
      hx::wgmma_wait<0>();
      hx::fence_regs(o);
      if (lane == 0) hx::mbar_arrive(&rg.vempty[prev]);
    } else {
      turn.idle();  // every warpgroup takes tiles + 1 turns per item
    }
    for (; k0 < it.hi; k0 += BK) {
      fa::pass_tile<STAGES>(rg, stage, phase, lane);
      turn.idle();
    }

    // epilogue: normalise into the Q buffer for the TMA store, which clips
    // rows past C
    hx::named_barrier(1 + wg, 128);  // every warp is done reading Q
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      inv[h] = m[h] <= NEG_INF / 2 ? 0.f : 1.f / fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 8 * jj + 2 * tq;
        *reinterpret_cast<uint32_t*>(qs + G::off(ra + 8 * h, c / 8) +
                                     (c % 8) * 2) =
            fa::pack_bf16(o[4 * jj + 2 * h] * inv[h],
                          o[4 * jj + 2 * h + 1] * inv[h]);
      }
    }
    hx::fence_proxy_async();
    __syncwarp();
    if (lane == 0) hx::mbar_arrive(&staged[qb]);
    ++n;
  }
}

template <typename KV, int D>
cudaError_t launch(Params p, const void* q, void* o, cudaStream_t stream) {
  using G = fa::Geo<D>;
  constexpr size_t smem = Smem<KV, D>::BYTES;
  const CUtensorMapSwizzle swz = G::ROWB == 128
                                     ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap tmq, tmo;
  cudaError_t e = hx::bf16_map_4d(&tmq, q, D, p.hq, p.C, p.b, G::CH, p.g,
                                  p.P, 1, swz);
  if (e == cudaSuccess)
    e = hx::bf16_map_4d(&tmo, o, D, p.hq, p.C, p.b, G::CH, p.g, p.P, 1, swz);
  if (e != cudaSuccess) return e;
  auto kern = context_fwd<KV, D>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  kern<<<min(p.items, sms), 128 * (NC + 1), smem, stream>>>(p, tmq, tmo);
  return cudaGetLastError();
}

// bf16 context chunks on KV pools (bf16; int8_t or __nv_fp8_e4m3 with
// their scale pools): a consumer warpgroup's rows are whole GQA groups, so
// g <= 64
template <typename KV>
cudaError_t launch_bf16(const void* q, const void* k_pages,
                        const void* v_pages, const float* k_scale,
                        const float* v_scale, void* o, const int* tables,
                        const int* q_start, const int* kv_len, int b, int C,
                        int hq, int hkv, int d, int block_size,
                        int max_blocks, float scale, cudaStream_t st) {
  if (hkv <= 0 || hq % hkv != 0 || block_size < 1 || !q_start || !kv_len ||
      (sizeof(KV) == 1 && (!k_scale || !v_scale)))
    return cudaErrorInvalidValue;
  Params p{};
  p.k = k_pages;
  p.v = v_pages;
  p.k_scale = k_scale;
  p.v_scale = v_scale;
  p.tables = tables;
  p.q_start = q_start;
  p.kv_len = kv_len;
  p.b = b;
  p.C = C;
  p.hq = hq;
  p.hkv = hkv;
  p.g = hq / hkv;
  p.P = WG_ROWS / p.g;
  p.bs = block_size;
  p.max_blocks = max_blocks;
  p.causal = 1;
  p.window = 0;
  p.scale_log2 = scale * 1.4426950408889634f;
  if (p.P < 1) return cudaErrorInvalidValue;
  if (b <= 0 || C <= 0) return cudaSuccess;
  p.n_mtiles = (C + NC * p.P - 1) / (NC * p.P);
  p.units = p.n_mtiles * b;
  p.items = p.units * hkv;
  switch (d) {
    case 32:
      return launch<KV, 32>(p, q, o, st);
    case 64:
      return launch<KV, 64>(p, q, o, st);
    case 128:
      return launch<KV, 128>(p, q, o, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace pc

namespace {

// fp32 paged context on attention.cuh's scalar body: K/V in q's dtype
// (kv_type 0), bf16 (3) or one-byte (1 = int8, 2 = fp8 e4m3, with both
// scale pools)
int paged_context(const void* q, const void* k_pages, const void* v_pages,
                  const float* k_scale, const float* v_scale, void* o,
                  const int* tables, const int* q_start, const int* kv_len,
                  int b, int C, int hq, int hkv, int d, int block_size,
                  int max_blocks, float scale, int kv_type, void* stream) {
  rt::AttnParams p{};
  p.q = q;
  p.k = k_pages;
  p.v = v_pages;
  p.k_scale = k_scale;
  p.v_scale = v_scale;
  p.o = o;
  p.tables = tables;
  p.q_start = q_start;
  p.kv_len = kv_len;
  p.b = b;
  p.sq = C;
  p.hq = hq;
  p.hkv = hkv;
  p.bs = block_size;
  p.max_blocks = max_blocks;
  p.causal = 1;
  p.scale = scale;
  if (hkv <= 0 || hq % hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (kv_type == 0) return (int)rt::dispatch_d<float, true>(p, d, st);
  if (kv_type == 3) return (int)rt::dispatch_d<__nv_bfloat16, true>(p, d, st);
  if (!k_scale || !v_scale) return (int)cudaErrorInvalidValue;
  if (kv_type == 1) return (int)rt::dispatch_d<int8_t, true>(p, d, st);
  if (kv_type == 2) return (int)rt::dispatch_d<__nv_fp8_e4m3, true>(p, d, st);
  return (int)cudaErrorInvalidValue;
}

// The decode body's instances on P (dtype of q, o: 0 = float32, 1 =
// bfloat16): bf16 takes one table lookup per 16-key group when a page
// holds whole groups (bs % 16 == 0), else one per key; fp32 always one per
// key (a 32-key step may span pages)
template <class P>
cudaError_t launch_paged(const P& p, int d, int dtype, cudaStream_t st) {
  // pools of the other width (dk::MParams, dk::MVParams): q takes the
  // width the pools do not have
  using W = typename dk::Width<P>::type;
  if constexpr (std::is_same<W, dk::bf16>::value) {
    if (dtype == 0) return dk::launch_t<float, dk::PAGED>(p, d, st);
  } else if constexpr (std::is_same<W, float>::value) {
    if (dtype == 1)
      return p.bs % 16 == 0 ? dk::launch_t<dk::bf16, dk::PAGED16>(p, d, st)
                            : dk::launch_t<dk::bf16, dk::PAGED>(p, d, st);
  } else {
    if (dtype == 0) return dk::launch_t<float, dk::PAGED>(p, d, st);
    if (dtype == 1)
      return p.bs % 16 == 0 ? dk::launch_t<dk::bf16, dk::PAGED16>(p, d, st)
                            : dk::launch_t<dk::bf16, dk::PAGED>(p, d, st);
  }
  return cudaErrorInvalidValue;
}

// Decode (#2 on dk::Params, #5 on dk::QParams<KV> with its scales set):
// kv_len (b,) or null (every table slot full). counters: the kernel's
// merge counters, n_counters entries, zero between launches (needed when
// n_split > 1).
template <class P>
int paged_decode(P p, const void* q, const void* k_pages,
                 const void* v_pages, void* o, const int* tables,
                 const int* kv_len, int b, int hq, int hkv, int d,
                 int block_size, int max_blocks, float scale, int n_split,
                 float* part, int* counters, int n_counters, int dtype,
                 void* stream) {
  if (block_size < 1 || max_blocks < 0) return (int)cudaErrorInvalidValue;
  p.q = q;
  p.k = k_pages;
  p.v = v_pages;
  p.o = o;
  p.kv_len = kv_len;
  p.b = b;
  p.S = max_blocks * block_size;
  p.hq = hq;
  p.hkv = hkv;
  p.n_split = n_split;
  p.part = part;
  p.counters = counters;
  p.tables = tables;
  p.bs = block_size;
  p.max_blocks = max_blocks;
  const cudaError_t e = dk::prepare(p, scale, n_counters);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_paged(p, d, dtype, (cudaStream_t)stream);
}

// Verification (#4 on dk::VParams, #7 on dk::QVParams<KV>): the decode
// body with (candidate, head) columns, candidate t of row i at kv_start[i]
// + t seeing keys [0, min(kv_len, kv_start + t + 1)). Padding candidates
// (t >= the slot's real count) sit past kv_len and still see the committed
// keys [0, kv_len); a row with kv_len == 0 (a free slot on an all-null
// table) writes exact zeros. part: (b, T, hq, n_split, d + 2) fp32;
// counters: the kernel's merge counters, n_counters entries, zero between
// launches (both needed when n_split > 1).
template <class P>
int paged_verify(P p, const void* q, const void* k_pages,
                 const void* v_pages, void* o, const int* tables,
                 const int* kv_start, const int* kv_len, int b, int T, int hq,
                 int hkv, int d, int block_size, int max_blocks, float scale,
                 int n_split, float* part, int* counters, int n_counters,
                 int dtype, void* stream) {
  if (block_size < 1 || max_blocks < 0) return (int)cudaErrorInvalidValue;
  p.q = q;
  p.k = k_pages;
  p.v = v_pages;
  p.o = o;
  p.kv_len = kv_len;
  p.q_origin = kv_start;
  p.T = T;
  p.b = b;
  p.S = max_blocks * block_size;
  p.hq = hq;
  p.hkv = hkv;
  p.n_split = n_split;
  p.part = part;
  p.counters = counters;
  p.tables = tables;
  p.bs = block_size;
  p.max_blocks = max_blocks;
  const cudaError_t e = dk::prepare_verify(p, scale, n_counters);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_paged(p, d, dtype, (cudaStream_t)stream);
}

// Q<KV> with the scale pools set, for kv_type 1 (int8) and 2 (fp8 e4m3):
// f(params) of the quantized entries, or an error for another code or a
// missing scale pool
template <template <class> class Q, class F>
int with_payload(int kv_type, const float* k_scale, const float* v_scale,
                 F f) {
  if (!k_scale || !v_scale) return (int)cudaErrorInvalidValue;
  auto run = [&](auto p) {
    p.k_scale = k_scale;
    p.v_scale = v_scale;
    return f(p);
  };
  if (kv_type == 1) return run(Q<int8_t>{});
  if (kv_type == 2) return run(Q<__nv_fp8_e4m3>{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace

namespace {

// Unquantized pools: f(params) with Base for kv_type 0 (K/V in q's dtype),
// or M<KV> for the other width: 3 = bf16 pools under fp32 q, 4 = fp32 pools
// under bf16 q
template <template <class> class M, class Base, class F>
int with_width(int kv_type, F f) {
  if (kv_type == 0) return f(Base{});
  if (kv_type == 3) return f(M<dk::bf16>{});
  if (kv_type == 4) return f(M<float>{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int paged_decode_attention_fwd(
    const void* q, const void* k_pages, const void* v_pages, void* o,
    const int* tables, const int* kv_len, int b, int hq, int hkv, int d,
    int block_size, int max_blocks, float scale, int n_split, float* part,
    int* counters, int n_counters, int dtype, int kv_type, void* stream) {
  return with_width<dk::MParams, dk::Params>(kv_type, [&](auto p) {
    return paged_decode(p, q, k_pages, v_pages, o, tables, kv_len, b, hq,
                        hkv, d, block_size, max_blocks, scale, n_split, part,
                        counters, n_counters, dtype, stream);
  });
}

// kv_type as paged_decode_attention_fwd's
extern "C" int paged_context_attention_fwd(
    const void* q, const void* k_pages, const void* v_pages, void* o,
    const int* tables, const int* q_start, const int* kv_len, int b, int C,
    int hq, int hkv, int d, int block_size, int max_blocks, float scale,
    int dtype, int kv_type, void* stream) {
  if (dtype == 1 && kv_type == 0)
    return (int)pc::launch_bf16<pc::bf16>(
        q, k_pages, v_pages, nullptr, nullptr, o, tables, q_start, kv_len, b,
        C, hq, hkv, d, block_size, max_blocks, scale, (cudaStream_t)stream);
  if (dtype == 1 && kv_type == 4)
    return (int)pc::launch_bf16<float>(
        q, k_pages, v_pages, nullptr, nullptr, o, tables, q_start, kv_len, b,
        C, hq, hkv, d, block_size, max_blocks, scale, (cudaStream_t)stream);
  if (dtype != 0 || (kv_type != 0 && kv_type != 3))
    return (int)cudaErrorInvalidValue;
  return paged_context(q, k_pages, v_pages, nullptr, nullptr, o, tables,
                       q_start, kv_len, b, C, hq, hkv, d, block_size,
                       max_blocks, scale, kv_type, stream);
}

extern "C" int paged_verify_attention_fwd(
    const void* q, const void* k_pages, const void* v_pages, void* o,
    const int* tables, const int* kv_start, const int* kv_len, int b, int T,
    int hq, int hkv, int d, int block_size, int max_blocks, float scale,
    int n_split, float* part, int* counters, int n_counters, int dtype,
    int kv_type, void* stream) {
  return with_width<dk::MVParams, dk::VParams>(kv_type, [&](auto p) {
    return paged_verify(p, q, k_pages, v_pages, o, tables, kv_start, kv_len,
                        b, T, hq, hkv, d, block_size, max_blocks, scale,
                        n_split, part, counters, n_counters, dtype, stream);
  });
}

// Quantized pools: kv_type 1 = int8, 2 = fp8 e4m3 payloads (n_blocks,
// block_size, hkv, d), k_scale / v_scale (n_blocks, block_size, hkv) fp32;
// otherwise the arguments of the unquantized entries.
extern "C" int paged_decode_attention_quant_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const float* k_scale, const float* v_scale, void* o, const int* tables,
    const int* kv_len, int b, int hq, int hkv, int d, int block_size,
    int max_blocks, float scale, int n_split, float* part, int* counters,
    int n_counters, int dtype, int kv_type, void* stream) {
  return with_payload<dk::QParams>(kv_type, k_scale, v_scale, [&](auto p) {
    return paged_decode(p, q, k_pages, v_pages, o, tables, kv_len, b, hq,
                        hkv, d, block_size, max_blocks, scale, n_split, part,
                        counters, n_counters, dtype, stream);
  });
}

extern "C" int paged_context_attention_quant_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const float* k_scale, const float* v_scale, void* o, const int* tables,
    const int* q_start, const int* kv_len, int b, int C, int hq, int hkv,
    int d, int block_size, int max_blocks, float scale, int dtype,
    int kv_type, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1 && kv_type == 1)
    return (int)pc::launch_bf16<int8_t>(
        q, k_pages, v_pages, k_scale, v_scale, o, tables, q_start, kv_len, b,
        C, hq, hkv, d, block_size, max_blocks, scale, st);
  if (dtype == 1 && kv_type == 2)
    return (int)pc::launch_bf16<__nv_fp8_e4m3>(
        q, k_pages, v_pages, k_scale, v_scale, o, tables, q_start, kv_len, b,
        C, hq, hkv, d, block_size, max_blocks, scale, st);
  if (dtype != 0 || kv_type == 0) return (int)cudaErrorInvalidValue;
  return paged_context(q, k_pages, v_pages, k_scale, v_scale, o, tables,
                       q_start, kv_len, b, C, hq, hkv, d, block_size,
                       max_blocks, scale, kv_type, stream);
}

extern "C" int paged_verify_attention_quant_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const float* k_scale, const float* v_scale, void* o, const int* tables,
    const int* kv_start, const int* kv_len, int b, int T, int hq, int hkv,
    int d, int block_size, int max_blocks, float scale, int n_split,
    float* part, int* counters, int n_counters, int dtype, int kv_type,
    void* stream) {
  return with_payload<dk::QVParams>(kv_type, k_scale, v_scale, [&](auto p) {
    return paged_verify(p, q, k_pages, v_pages, o, tables, kv_start, kv_len,
                        b, T, hq, hkv, d, block_size, max_blocks, scale,
                        n_split, part, counters, n_counters, dtype, stream);
  });
}
