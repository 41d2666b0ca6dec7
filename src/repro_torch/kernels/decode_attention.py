"""Wrapper of the contiguous-cache decode kernel
(``csrc/decode_attention.cu``), the port of
repro.kernels.decode_attention.decode_attention_pallas.

``decode_attention_cuda`` checks its inputs, allocates the output (and the
split-KV partials), launches on the current stream and counts the launch;
it never falls back to the plain version (``ref.decode_attention_ref``) —
``ops`` chooses. ``contiguous_splits`` picks how many blocks share a row's
keys, for this kernel and for the paged decode kernel, which runs the same
body (``csrc/decode.cuh``) through a block table; the kernel divides each
row's live keys among them (``split_range``) and checks the count and the
size of the merge counters (``merge_counters``: one buffer per kernel).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (CONTIGUOUS_HEAD_DIMS,
                                                 DTYPES,
                                                 check_attention_inputs,
                                                 lengths)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    fn = build.library("decode_attention").decode_attention_fwd
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P,
                   _P, _I, _I, _P]
    fn.restype = _I
    return fn


# what the split count aims for: blocks per SM, the fewest cache keys per
# split, the most splits (the kernel's limit, which it checks), and the
# kernel's query heads per block, to count its blocks
BLOCKS_PER_SM = 3
KEYS_PER_SPLIT = 64
MAX_SPLITS = 64
HEADS = 8


def contiguous_splits(b, hq, hkv, S, sms, column_groups=1):
    """How many blocks share one row's keys: enough blocks (b x hkv x head
    groups x column groups (the paged verify kernel's; 1 for decode) x
    splits) for ~BLOCKS_PER_SM on each of `sms` SMs, and no more splits
    than S has KEYS_PER_SPLIT-key shares, nor than MAX_SPLITS. It reads S,
    not the live lengths, which are on the device."""
    groups = b * hkv * -(-(hq // hkv) // HEADS) * column_groups
    return max(1, min(-(-S // KEYS_PER_SPLIT), MAX_SPLITS,
                      -(-BLOCKS_PER_SM * sms // groups)))


_COUNTERS = {}


def merge_counters(kernel, n, device):
    """Zeroed int32 merge counters of at least n entries on `device`, a
    buffer of `kernel`'s own ("decode_attention", "paged_decode_attention",
    "paged_verify_attention"): a launch's last block per (row, kv head,
    head group, column group) resets its own, so they are zero again after
    every launch. b x hq entries (b x T x hq for verify) hold any grouping
    (the kernel checks that it has enough)."""
    t = _COUNTERS.get((kernel, device))
    if t is None or t.numel() < n:
        t = _COUNTERS[kernel, device] = torch.zeros(n, dtype=torch.int32,
                                                    device=device)
    return t


def decode_attention_cuda(q, k, v, *, kv_len=None, kv_start=None,
                          scale=None):
    """q (b,1,hq,d); k,v (b,S,hkv,d) CUDA tensors; kv_len / kv_start (b,)
    or None -> (b,1,hq,d)."""
    q, k, v = check_attention_inputs(q, k, v, kernel="decode_attention",
                                     head_dims=CONTIGUOUS_HEAD_DIMS)
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
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    n_split = contiguous_splits(b, hq, hkv, S, sms)
    part = counters = None
    if n_split > 1:
        part = torch.empty(b * hq * n_split * (d + 2), dtype=torch.float32,
                           device=q.device)
        counters = merge_counters("decode_attention", b * hq, q.device)
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lens.data_ptr() if lens is not None else None,
                 starts.data_ptr() if starts is not None else None,
                 b, S, hq, hkv, d, float(scale), n_split,
                 part.data_ptr() if part is not None else None,
                 counters.data_ptr() if counters is not None else None,
                 counters.numel() if counters is not None else 0,
                 DTYPES[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"decode_attention_fwd: CUDA error {err}")
    decode_attention_cuda.launches += 1
    return o


decode_attention_cuda.launches = 0
