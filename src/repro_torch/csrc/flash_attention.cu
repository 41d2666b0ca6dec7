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
// so it is bound by operations. The design keeps every intermediate (scores,
// probabilities, running max/sum) on chip with an online softmax, serves the
// whole GQA group of a kv head from one K/V tile, and stops each query tile
// at its causal limit instead of masking dead tiles. bf16 inputs run on the
// tensor cores (mma.sync, attn_fwd_mma); fp32 inputs on scalar FMAs. Both
// load tiles without pipelining (no cp.async / TMA yet): PERF.md records how
// far that is from the bound.
#include "attention.cuh"

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, const int* kv_len,
                                   const int* kv_start, int b, int sq,
                                   int skv, int hq, int hkv, int d,
                                   int causal, int window, float scale,
                                   int dtype, void* stream) {
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
  return (int)rt::dispatch<false>(p, d, dtype, (cudaStream_t)stream);
}
