"""Wrappers of the paged-attention CUDA kernels (``csrc/paged_attention.cu``),
the ports of repro.kernels.paged_attention.paged_decode_attention_pallas,
paged_context_attention_pallas and paged_verify_attention_pallas, and of
their quantized-pool variants (``*_quant_pallas``: int8 / fp8 e4m3 payload
pools with float32 per-token-per-head scale pools, dequantized inside the
kernel).

Bodies (see the CUDA source): decode (#2) and verification (#4), bf16
and fp32, run the GQA decode body of ``csrc/decode.cuh`` through the block
table, each with its split count over the table's capacity and merge
counters of its own. A verify block's 8 query columns are (candidate,
head) pairs (``verify_columns``): candidate t of row i, at position
kv_start[i] + t, sees keys [0, min(kv_len[i], kv_start[i] + t + 1)). bf16
context runs the TMA + wgmma body ``pc::context_fwd`` on bf16 pools (#3,
K/V tiles gathered by cp.async) and on int8 / fp8 pools (#6, widened to
bf16 by the gathering warps, scales folded into scores and
probabilities). fp32 context, fp32 quantized context and the quantized
decode and verify (#5, #7) run the bodies of ``csrc/attention.cuh`` (the
quantized decode with ``decode_splits`` blocks per row and a second merge
launch).

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
from repro_torch.kernels.decode_attention import (HEADS, contiguous_splits,
                                                  merge_counters)
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
    """How many blocks share one row's keys in the quantized decode kernel
    (#5, attention.cuh's scalar body): enough (b x hkv x splits) for ~4
    blocks per SM, and at most one 32-key tile each."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-capacity // 32), -(-4 * sms // (b * hkv))))


def paged_decode_splits(b, hq, hkv, max_blocks, block_size, sms):
    """How many blocks share one row's keys in the paged decode kernel
    (#2): ``contiguous_splits`` over the table's capacity max_blocks x
    block_size (never the live lengths, which are on the device)."""
    return contiguous_splits(b, hq, hkv, max_blocks * block_size, sms)


def verify_columns(T, g):
    """(cp, column groups) of the paged verify kernel (#4): a block's HEADS
    query columns are cp = max(1, HEADS // g) candidates of g heads each
    (capped by T; one candidate and HEADS heads of a group at g > HEADS),
    so ceil(T / cp) column groups cover a row's candidates."""
    cp = min(T, max(1, HEADS // g))
    return cp, -(-T // cp)


def paged_verify_splits(b, T, hq, hkv, max_blocks, block_size, sms):
    """How many blocks share one row's keys in the paged verify kernel
    (#4): ``contiguous_splits`` over the table's capacity max_blocks x
    block_size (never the live lengths, which are on the device), counting
    its verify_columns column groups among the blocks."""
    return contiguous_splits(b, hq, hkv, max_blocks * block_size, sms,
                             column_groups=verify_columns(T, hq // hkv)[1])


# payload dtype of a quantized pool -> the kernels' K/V type code
KV_TYPES = {torch.int8: 1, torch.float8_e4m3fn: 2}


def check_quant_inputs(q, k_pages, v_pages, k_scale, v_scale):
    """check_attention_inputs for int8 / fp8 payload pools, and float32
    scale pools of shape (n_blocks, bs, hkv) on q's device. Returns q,
    k_pages, v_pages (16-byte aligned) and (k_scale, v_scale (contiguous),
    the kernels' K/V type code)."""
    q, k_pages, v_pages = check_attention_inputs(q, k_pages, v_pages,
                                                 tuple(KV_TYPES))
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t.device != q.device:
            raise ValueError(f"{name} must be on q's device, got {t.device}")
        if t.dtype != torch.float32 or t.shape != k_pages.shape[:3]:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, expected "
                             f"float32 {tuple(k_pages.shape[:3])}")
    return (q, k_pages, v_pages,
            (k_scale.contiguous(), v_scale.contiguous(),
             KV_TYPES[k_pages.dtype]))


def _checked(q, k_pages, v_pages, scales):
    """The inputs checked for the unquantized kernels (scales None: quant
    None) or the quantized ones (scales (k_scale, v_scale))."""
    if scales is None:
        return (*check_attention_inputs(q, k_pages, v_pages), None)
    return check_quant_inputs(q, k_pages, v_pages, *scales)


def _launch(entry, q, k_pages, v_pages, o, quant, tail, tail_types):
    """Call ``entry(q, k, v, o, *tail, stream)``, or for a quantized pool
    (quant = (k_scale, v_scale, kv_type)) its twin
    ``entry_quant_fwd(q, k, v, k_scale, v_scale, o, *tail, kv_type,
    stream)``; raise on a CUDA error."""
    stream = torch.cuda.current_stream(q.device).cuda_stream
    kv = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr())
    if quant is None:
        args = (*kv, o.data_ptr(), *tail, stream)
        types = [_P] * 4 + tail_types + [_P]
    else:
        k_scale, v_scale, kv_type = quant
        entry = entry.replace("_fwd", "_quant_fwd")
        args = (*kv, k_scale.data_ptr(), v_scale.data_ptr(), o.data_ptr(),
                *tail, kv_type, stream)
        types = [_P] * 6 + tail_types + [_I, _P]
    err = _fn(entry, types)(*args)
    if err:
        raise RuntimeError(f"{entry}: CUDA error {err}")


def _split_buffers(kernel, n_split, rows, d, device):
    """(part, counters) of a launch with n_split splits over `rows` query
    rows: fp32 partials (rows, n_split, d + 2) and `kernel`'s merge
    counters (None for a kernel that merges in a second launch), or
    (None, None) for one split."""
    if n_split == 1:
        return None, None
    return (torch.empty(rows * n_split * (d + 2), dtype=torch.float32,
                        device=device),
            merge_counters(kernel, rows, device) if kernel else None)


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _decode(q, k_pages, v_pages, scales, block_tables, kv_len, scale):
    """Launch the decode entry (quantized when `scales` is given) -> o."""
    q, k_pages, v_pages, quant = _checked(q, k_pages, v_pages, scales)
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
    if quant is None:
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        n_split = paged_decode_splits(b, hq, hkv, nb, bs, sms)
    else:
        n_split = decode_splits(b, hkv, nb * bs, q.device)
    part, counters = _split_buffers(
        "paged_decode_attention" if quant is None else None, n_split,
        b * hq, d, q.device)
    tail = (tbl.data_ptr(), lens.data_ptr(), b, hq, hkv, d, bs, nb,
            float(scale), n_split, _ptr(part))
    types = [_P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P]
    if quant is None:   # #2's own merge counters
        tail += (_ptr(counters),
                 counters.numel() if counters is not None else 0)
        types += [_P, _I]
    _launch("paged_decode_attention_fwd", q, k_pages, v_pages, o, quant,
            (*tail, DTYPES[q.dtype]), types + [_I])
    return o


def paged_decode_attention_cuda(q, k_pages, v_pages, block_tables, *,
                                kv_len=None, scale=None):
    """q (b,1,hq,d); pages (n_blocks,bs,hkv,d); block_tables (b,nb);
    kv_len (b,) (default: every table slot full) -> (b,1,hq,d)."""
    o = _decode(q, k_pages, v_pages, None, block_tables, kv_len, scale)
    if o.numel():
        paged_decode_attention_cuda.launches += 1
    return o


def paged_decode_attention_quant_cuda(q, k_pages, v_pages, k_scale, v_scale,
                                      block_tables, *, kv_len=None,
                                      scale=None):
    """paged_decode_attention_cuda on int8 / fp8 payload pools
    (n_blocks,bs,hkv,d) with float32 scale pools k_scale, v_scale
    (n_blocks,bs,hkv) -> (b,1,hq,d) in q's dtype."""
    o = _decode(q, k_pages, v_pages, (k_scale, v_scale), block_tables,
                kv_len, scale)
    if o.numel():
        paged_decode_attention_quant_cuda.launches += 1
    return o


def _chunk_attention(entry, q, k_pages, v_pages, block_tables, q_start,
                     kv_len, scale, scales=None):
    """Launch `entry` (context, or the quantized verify: the context
    contract at q_start = kv_start; its ``_quant_fwd`` twin when `scales`
    is (k_scale, v_scale)) -> o."""
    q, k_pages, v_pages, quant = _checked(q, k_pages, v_pages, scales)
    b, C, hq, d = q.shape
    _, bs, hkv, _ = k_pages.shape
    tbl = _tables(block_tables, b, q.device)
    starts = lengths(q_start, b, q.device)
    lens = lengths(kv_len, b, q.device)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    _launch(entry, q, k_pages, v_pages, o, quant,
            (tbl.data_ptr(), starts.data_ptr(), lens.data_ptr(), b, C, hq,
             hkv, d, bs, tbl.shape[1], float(scale), DTYPES[q.dtype]),
            [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I])
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
    q, k_pages, v_pages = check_attention_inputs(q, k_pages, v_pages)
    b, T, hq, d = q.shape
    _, bs, hkv, _ = k_pages.shape
    tbl = _tables(block_tables, b, q.device)
    nb = tbl.shape[1]
    starts = lengths(kv_start, b, q.device)
    lens = lengths(kv_len, b, q.device)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    n_split = paged_verify_splits(b, T, hq, hkv, nb, bs, sms)
    part, counters = _split_buffers("paged_verify_attention", n_split,
                                    b * T * hq, d, q.device)
    _launch("paged_verify_attention_fwd", q, k_pages, v_pages, o, None,
            (tbl.data_ptr(), starts.data_ptr(), lens.data_ptr(), b, T, hq,
             hkv, d, bs, nb, float(scale), n_split, _ptr(part),
             _ptr(counters), counters.numel() if counters is not None else 0,
             DTYPES[q.dtype]),
            [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P, _P, _I, _I])
    paged_verify_attention_cuda.launches += 1
    return o


def paged_context_attention_quant_cuda(q, k_pages, v_pages, k_scale,
                                       v_scale, block_tables, *, q_start,
                                       kv_len, scale=None):
    """paged_context_attention_cuda on int8 / fp8 payload pools with
    float32 scale pools (n_blocks,bs,hkv)."""
    o = _chunk_attention("paged_context_attention_fwd", q, k_pages, v_pages,
                         block_tables, q_start, kv_len, scale,
                         (k_scale, v_scale))
    if o.numel():
        paged_context_attention_quant_cuda.launches += 1
    return o


def paged_verify_attention_quant_cuda(q, k_pages, v_pages, k_scale, v_scale,
                                      block_tables, *, kv_start, kv_len,
                                      scale=None):
    """paged_verify_attention_cuda on int8 / fp8 payload pools with
    float32 scale pools (n_blocks,bs,hkv)."""
    o = _chunk_attention("paged_verify_attention_fwd", q, k_pages, v_pages,
                         block_tables, kv_start, kv_len, scale,
                         (k_scale, v_scale))
    if o.numel():
        paged_verify_attention_quant_cuda.launches += 1
    return o


paged_decode_attention_cuda.launches = 0
paged_context_attention_cuda.launches = 0
paged_verify_attention_cuda.launches = 0
paged_decode_attention_quant_cuda.launches = 0
paged_context_attention_quant_cuda.launches = 0
paged_verify_attention_quant_cuda.launches = 0
