"""Wrappers of the paged-attention CUDA kernels (``csrc/paged_attention.cu``),
the ports of repro.kernels.paged_attention.paged_decode_attention_pallas,
paged_context_attention_pallas and paged_verify_attention_pallas.

Each wrapper checks its inputs, allocates the output, launches on the
current stream and counts its own launches; none falls back to its plain
version (``ref.paged_*_ref``) — ``ops`` chooses. Block-table entries are
trusted to name pages of the pool (the engine's BlockTables produce them);
checking them on the card would cost a device sync per call.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (DTYPES,
                                                 check_attention_inputs,
                                                 lengths)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _fn(name, argtypes):
    fn = getattr(build.library("paged_attention"), name)
    fn.argtypes = argtypes
    fn.restype = _I
    return fn


def _tables(block_tables, b, device):
    t = torch.as_tensor(block_tables, device=device).to(torch.int32)
    if t.dim() != 2 or t.shape[0] != b:
        raise ValueError(f"block tables of shape {tuple(t.shape)}, "
                         f"expected ({b}, max_blocks)")
    return t.contiguous()


def decode_splits(b, hkv, capacity, device):
    """How many blocks share one decode row's keys: enough (b x hkv x
    splits) for ~4 blocks per SM, and at most one 32-key tile each."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-capacity // 32), -(-4 * sms // (b * hkv))))


def paged_decode_attention_cuda(q, k_pages, v_pages, block_tables, *,
                                kv_len=None, scale=None):
    """q (b,1,hq,d); pages (n_blocks,bs,hkv,d); block_tables (b,nb);
    kv_len (b,) (default: every table slot full) -> (b,1,hq,d)."""
    q, k_pages, v_pages = check_attention_inputs(q, k_pages, v_pages)
    b, one, hq, d = q.shape
    if one != 1:
        raise ValueError(f"decode takes one query token per row, got {one}")
    _, bs, hkv, _ = k_pages.shape
    tbl = _tables(block_tables, b, q.device)
    nb = tbl.shape[1]
    lens = lengths(kv_len if kv_len is not None else [nb * bs] * b, b,
                   q.device)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    n_split = decode_splits(b, hkv, nb * bs, q.device)
    part = (torch.empty(b * hq * n_split * (d + 2), dtype=torch.float32,
                        device=q.device) if n_split > 1 else None)
    err = _fn("paged_decode_attention_fwd",
              [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P,
               _I, _P])(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), o.data_ptr(),
        tbl.data_ptr(), lens.data_ptr(), b, hq, hkv, d, bs, nb,
        float(scale), n_split, part.data_ptr() if part is not None else None,
        DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_decode_attention_fwd: CUDA error {err}")
    paged_decode_attention_cuda.launches += 1
    return o


def _chunk_attention(entry, q, k_pages, v_pages, block_tables, q_start,
                     kv_len, scale):
    """Launch `entry` (context or verify: the same contract) -> o."""
    q, k_pages, v_pages = check_attention_inputs(q, k_pages, v_pages)
    b, C, hq, d = q.shape
    _, bs, hkv, _ = k_pages.shape
    tbl = _tables(block_tables, b, q.device)
    starts = lengths(q_start, b, q.device)
    lens = lengths(kv_len, b, q.device)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    err = _fn(entry,
              [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
               _I, _P])(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), o.data_ptr(),
        tbl.data_ptr(), starts.data_ptr(), lens.data_ptr(), b, C, hq, hkv, d,
        bs, tbl.shape[1], float(scale), DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"{entry}: CUDA error {err}")
    return o


def paged_context_attention_cuda(q, k_pages, v_pages, block_tables, *,
                                 q_start, kv_len, scale=None):
    """q (b,C,hq,d), row i token j at absolute position q_start[i] + j;
    pages already hold the chunk's K/V at [q_start, kv_len) -> (b,C,hq,d).
    """
    o = _chunk_attention("paged_context_attention_fwd", q, k_pages, v_pages,
                         block_tables, q_start, kv_len, scale)
    if o.numel():
        paged_context_attention_cuda.launches += 1
    return o


def paged_verify_attention_cuda(q, k_pages, v_pages, block_tables, *,
                                kv_start, kv_len, scale=None):
    """q (b,T,hq,d), T candidates per slot, row i's candidate j at absolute
    position kv_start[i] + j; pages already hold the candidates' K/V at
    [kv_start, kv_len) -> (b,T,hq,d), every position kept."""
    o = _chunk_attention("paged_verify_attention_fwd", q, k_pages, v_pages,
                         block_tables, kv_start, kv_len, scale)
    if o.numel():
        paged_verify_attention_cuda.launches += 1
    return o


paged_decode_attention_cuda.launches = 0
paged_context_attention_cuda.launches = 0
paged_verify_attention_cuda.launches = 0
