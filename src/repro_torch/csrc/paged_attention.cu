// Paged attention for Hopper (sm_90a): decode, context prefill and
// speculative verification against a block-paged KV pool
// (n_blocks, block_size, hkv, d) read through per-row block tables
// (b, max_blocks), with the pool in q's dtype or quantized (int8 / fp8 e4m3
// payload plus fp32 per-token-per-head scale pools (n_blocks, block_size,
// hkv)).
//
// Replaces: src/repro/kernels/paged_attention.py:paged_decode_attention_pallas
// (one query token per row, kv_len mask) and
// src/repro/kernels/paged_attention.py:paged_context_attention_pallas (a
// C-token chunk at absolute offset q_start, causal over the prior pages and
// itself; fully masked rows give exact zeros) and
// src/repro/kernels/paged_attention.py:paged_verify_attention_pallas (T =
// k + 1 candidates per slot at the slot's committed length kv_start, the
// output kept at every position). Decode is the C = 1 case of the same body
// with no causal term; verification is the context body with
// q_start = kv_start, as the TPU kernel rode the context grid.
//
// The *_quant_fwd entries replace the quantized-pool kernels of the same
// file, paged_decode_attention_quant_pallas,
// paged_context_attention_quant_pallas and
// paged_verify_attention_quant_pallas (dequantization fused per tile): the
// same three entries with a K/V type code and the scale pools, on the same
// bodies (attention.cuh folds the scales into scores and probabilities).
//
// Bound on the card: a decode step does ~4 d hq kv_len FLOPs per row on
// 2 d hkv kv_len K/V elements, a few FLOPs per byte, so it is bound by bytes
// (reading the live pages). Each block serves all g query heads of one kv
// head, so a page is read once per block instead of g times, and it loops
// only over the ceil(kv_len / 32) live key tiles, never over the table's
// null tail, loading each key row with 16-byte vector loads after one table
// lookup. A decode step has few blocks (rows x kv heads) and each is bound
// by memory latency, so the keys of a row split over n_split blocks
// (chosen by the wrapper to fill the SMs) and a second small kernel merges
// their partial softmax states (split-KV, "flash-decoding"). Context
// chunks (C x g rows per kv head) sit between the two regimes and, in
// bf16, run on the tensor-core body (attn_fwd_mma). Rows of free slots
// (all-null tables) read the trash page and come out finite; their values
// are discarded by the caller.
//
// A quantized pool moves 2 d + 8 bytes per key and kv head (one-byte K and
// V rows plus their two fp32 scales) instead of 4 d in bf16, so its decode
// bound is about half; the bodies widen the payload in registers and never
// write a dequantized page to memory.
#include "attention.cuh"

namespace {

// dtype (of q, o): 0 = float32, 1 = bfloat16. kv_type (of the K/V pools):
// 0 = q's dtype, 1 = int8, 2 = fp8 e4m3; the quantized types need both
// scale pools.
cudaError_t dispatch(const rt::AttnParams& p, int d, int dtype,
                     cudaStream_t stream, int kv_type) {
  if (p.hkv <= 0 || p.hq % p.hkv != 0) return cudaErrorInvalidValue;
  if (kv_type == 0) {
    if (dtype == 0) return rt::dispatch_d<float, float, true>(p, d, stream);
    if (dtype == 1)
      return rt::dispatch_d<__nv_bfloat16, __nv_bfloat16, true>(p, d,
                                                                stream);
    return cudaErrorInvalidValue;
  }
  if (!p.k_scale || !p.v_scale) return cudaErrorInvalidValue;
  if (kv_type == 1) return rt::dispatch_q<int8_t>(p, d, dtype, stream);
  if (kv_type == 2) return rt::dispatch_q<__nv_fp8_e4m3>(p, d, dtype, stream);
  return cudaErrorInvalidValue;
}

int paged_decode(const void* q, const void* k_pages, const void* v_pages,
                 const float* k_scale, const float* v_scale, void* o,
                 const int* tables, const int* kv_len, int b, int hq, int hkv,
                 int d, int block_size, int max_blocks, float scale,
                 int n_split, float* part, int dtype, int kv_type,
                 void* stream) {
  rt::AttnParams p{};
  p.q = q;
  p.k = k_pages;
  p.v = v_pages;
  p.k_scale = k_scale;
  p.v_scale = v_scale;
  p.o = o;
  p.tables = tables;
  p.kv_len = kv_len;
  p.b = b;
  p.sq = 1;
  p.hq = hq;
  p.hkv = hkv;
  p.bs = block_size;
  p.max_blocks = max_blocks;
  p.scale = scale;
  p.n_split = n_split;
  p.part = part;
  return (int)dispatch(p, d, dtype, (cudaStream_t)stream, kv_type);
}

int paged_context(const void* q, const void* k_pages, const void* v_pages,
                  const float* k_scale, const float* v_scale, void* o,
                  const int* tables, const int* q_start, const int* kv_len,
                  int b, int C, int hq, int hkv, int d, int block_size,
                  int max_blocks, float scale, int dtype, int kv_type,
                  void* stream) {
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
  return (int)dispatch(p, d, dtype, (cudaStream_t)stream, kv_type);
}

}  // namespace

extern "C" int paged_decode_attention_fwd(const void* q, const void* k_pages,
                                          const void* v_pages, void* o,
                                          const int* tables, const int* kv_len,
                                          int b, int hq, int hkv, int d,
                                          int block_size, int max_blocks,
                                          float scale, int n_split,
                                          float* part, int dtype,
                                          void* stream) {
  return paged_decode(q, k_pages, v_pages, nullptr, nullptr, o, tables,
                      kv_len, b, hq, hkv, d, block_size, max_blocks, scale,
                      n_split, part, dtype, 0, stream);
}

extern "C" int paged_context_attention_fwd(
    const void* q, const void* k_pages, const void* v_pages, void* o,
    const int* tables, const int* q_start, const int* kv_len, int b, int C,
    int hq, int hkv, int d, int block_size, int max_blocks, float scale,
    int dtype, void* stream) {
  return paged_context(q, k_pages, v_pages, nullptr, nullptr, o, tables,
                       q_start, kv_len, b, C, hq, hkv, d, block_size,
                       max_blocks, scale, dtype, 0, stream);
}

// Verification rows are T x g per kv head (40 at k = 4, g = 8: ragged for
// the 64-row tensor-core block, whose dead rows are masked like a context
// chunk's). Padding candidates (j >= the slot's real count) sit past
// kv_len and still see the committed keys [0, kv_len); a row with
// kv_len == 0 (a free slot on an all-null table) writes exact zeros. No
// split-KV: a verify step has T times decode's rows.
extern "C" int paged_verify_attention_fwd(
    const void* q, const void* k_pages, const void* v_pages, void* o,
    const int* tables, const int* kv_start, const int* kv_len, int b, int T,
    int hq, int hkv, int d, int block_size, int max_blocks, float scale,
    int dtype, void* stream) {
  return paged_context(q, k_pages, v_pages, nullptr, nullptr, o, tables,
                       kv_start, kv_len, b, T, hq, hkv, d, block_size,
                       max_blocks, scale, dtype, 0, stream);
}

// Quantized pools: kv_type 1 = int8, 2 = fp8 e4m3 payloads (n_blocks,
// block_size, hkv, d), k_scale / v_scale (n_blocks, block_size, hkv) fp32.
extern "C" int paged_decode_attention_quant_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const float* k_scale, const float* v_scale, void* o, const int* tables,
    const int* kv_len, int b, int hq, int hkv, int d, int block_size,
    int max_blocks, float scale, int n_split, float* part, int dtype,
    int kv_type, void* stream) {
  if (kv_type == 0) return (int)cudaErrorInvalidValue;
  return paged_decode(q, k_pages, v_pages, k_scale, v_scale, o, tables,
                      kv_len, b, hq, hkv, d, block_size, max_blocks, scale,
                      n_split, part, dtype, kv_type, stream);
}

extern "C" int paged_context_attention_quant_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const float* k_scale, const float* v_scale, void* o, const int* tables,
    const int* q_start, const int* kv_len, int b, int C, int hq, int hkv,
    int d, int block_size, int max_blocks, float scale, int dtype,
    int kv_type, void* stream) {
  if (kv_type == 0) return (int)cudaErrorInvalidValue;
  return paged_context(q, k_pages, v_pages, k_scale, v_scale, o, tables,
                       q_start, kv_len, b, C, hq, hkv, d, block_size,
                       max_blocks, scale, dtype, kv_type, stream);
}

extern "C" int paged_verify_attention_quant_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const float* k_scale, const float* v_scale, void* o, const int* tables,
    const int* kv_start, const int* kv_len, int b, int T, int hq, int hkv,
    int d, int block_size, int max_blocks, float scale, int dtype,
    int kv_type, void* stream) {
  return paged_context_attention_quant_fwd(
      q, k_pages, v_pages, k_scale, v_scale, o, tables, kv_start, kv_len, b,
      T, hq, hkv, d, block_size, max_blocks, scale, dtype, kv_type, stream);
}
