// Contiguous-cache decode attention for Hopper (sm_90a): one query token per
// row against a (b, S, hkv, d) cache, the draft model's decode step under
// speculative decoding.
//
// Replaces: src/repro/kernels/decode_attention.py:decode_attention_pallas.
// Keys at positions >= kv_len[i] or < kv_start[i] are masked; a row with no
// live key writes exact zeros. S may be any length (the TPU kernel padded
// a ragged last block; here loads stop at min(kv_len, S)).
//
// The body (decode.cuh, dk::decode_fwd with keys CONTIGUOUS) is shared with
// the paged decode kernel, which reads the same rows through a block table;
// decode.cuh says what bounds it on the card and how its design answers.
#include "decode.cuh"

extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, void* o, const int* kv_len,
                                    const int* kv_start, int b, int S, int hq,
                                    int hkv, int d, float scale, int n_split,
                                    float* part, int* counters,
                                    int n_counters, int dtype, void* stream) {
  dk::Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.kv_len = kv_len;
  p.kv_start = kv_start;
  p.b = b;
  p.S = S;
  p.hq = hq;
  p.hkv = hkv;
  p.n_split = n_split;
  p.part = part;
  p.counters = counters;
  const cudaError_t e = dk::prepare(p, scale, n_counters);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return (int)dk::launch_t<float, dk::CONTIGUOUS>(p, d, st);
  if (dtype == 1)
    return (int)dk::launch_t<dk::bf16, dk::CONTIGUOUS>(p, d, st);
  return (int)cudaErrorInvalidValue;
}
