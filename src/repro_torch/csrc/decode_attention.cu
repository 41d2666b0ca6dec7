// Contiguous-cache decode attention for Hopper (sm_90a): one query token per
// row against a (b, S, hkv, d) cache, the draft model's decode step under
// speculative decoding.
//
// Replaces: src/repro/kernels/decode_attention.py:decode_attention_pallas.
// Keys at positions >= kv_len[i] or < kv_start[i] are masked; a row with no
// live key writes exact zeros. S may be any length (the TPU kernel padded
// a ragged last block; here the tile loop stops at min(kv_len, S)).
//
// Bound on the card: like paged decode, ~4 d hq n FLOPs per row on
// 2 d hkv n K/V elements (n live keys), a few FLOPs per byte, so it is bound
// by reading the live part of the cache. The body is attention.cuh's: one
// block serves all g query heads of one kv head (a K/V tile is read once,
// not g times), it loops only over the live tiles of [kv_start, kv_len),
// never over the rest of S, and the keys of a row split over n_split
// blocks (chosen by the wrapper to fill the SMs) whose partial softmax
// states combine_splits merges. A split whose share of the tiles lies
// outside [kv_start, kv_len) writes m = NEG_INF, l = 0 and weighs nothing
// in the merge; a fully masked row merges to exact zeros.
#include "attention.cuh"

extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, void* o, const int* kv_len,
                                    const int* kv_start, int b, int S, int hq,
                                    int hkv, int d, float scale, int n_split,
                                    float* part, int dtype, void* stream) {
  rt::AttnParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.kv_len = kv_len;
  p.kv_start = kv_start;
  p.b = b;
  p.sq = 1;
  p.skv = S;  // key_row of a contiguous cache strides rows by skv
  p.hq = hq;
  p.hkv = hkv;
  p.scale = scale;
  p.n_split = n_split;
  p.part = part;
  return (int)rt::dispatch<false>(p, d, dtype, (cudaStream_t)stream);
}
