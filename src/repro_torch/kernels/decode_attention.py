"""Wrapper of the contiguous-cache decode kernel
(``csrc/decode_attention.cu``), the port of
repro.kernels.decode_attention.decode_attention_pallas.

``decode_attention_cuda`` checks its inputs, allocates the output (and the
split-KV partials), launches on the current stream and counts the launch;
it never falls back to the plain version (``ref.decode_attention_ref``) —
``ops`` chooses.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (DTYPES,
                                                 check_attention_inputs,
                                                 lengths)
from repro_torch.kernels.paged_attention import decode_splits

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    fn = build.library("decode_attention").decode_attention_fwd
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P,
                   _I, _P]
    fn.restype = _I
    return fn


def decode_attention_cuda(q, k, v, *, kv_len=None, kv_start=None,
                          scale=None):
    """q (b,1,hq,d); k,v (b,S,hkv,d) CUDA tensors; kv_len / kv_start (b,)
    or None -> (b,1,hq,d)."""
    q, k, v = check_attention_inputs(q, k, v)
    b, one, hq, d = q.shape
    if one != 1:
        raise ValueError(f"decode takes one query token per row, got {one}")
    _, S, hkv, _ = k.shape
    if k.shape[0] != b:
        raise ValueError(f"batch {k.shape[0]} of k != batch {b} of q")
    lens = lengths(kv_len, b, q.device) if kv_len is not None else None
    starts = lengths(kv_start, b, q.device) if kv_start is not None else None
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    n_split = decode_splits(b, hkv, S, q.device)
    part = (torch.empty(b * hq * n_split * (d + 2), dtype=torch.float32,
                        device=q.device) if n_split > 1 else None)
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lens.data_ptr() if lens is not None else None,
                 starts.data_ptr() if starts is not None else None,
                 b, S, hq, hkv, d, float(scale), n_split,
                 part.data_ptr() if part is not None else None,
                 DTYPES[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"decode_attention_fwd: CUDA error {err}")
    decode_attention_cuda.launches += 1
    return o


decode_attention_cuda.launches = 0
