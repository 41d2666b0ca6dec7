"""Wrappers of the paged-attention CUDA kernels (``csrc/paged_attention.cu``),
the ports of repro.kernels.paged_attention.paged_decode_attention_pallas,
paged_context_attention_pallas and paged_verify_attention_pallas, and of
their quantized-pool variants (``*_quant_pallas``: int8 / fp8 e4m3 payload
pools with float32 per-token-per-head scale pools, dequantized inside the
kernel).

Bodies (see the CUDA source): decode (#2) and verification (#4), and their
twins on int8 / fp8 pools (#5, #7), bf16 and fp32, run the GQA decode body
of ``csrc/decode.cuh`` through the block table, each with its split count
over the table's capacity and merge counters of its own (the quantized
ones widen the one-byte rows in registers and fold the scales into scores
and probabilities). A verify block's 8 query columns are (candidate,
head) pairs (``verify_columns``): candidate t of row i, at position
kv_start[i] + t, sees keys [0, min(kv_len[i], kv_start[i] + t + 1)). bf16
context runs the TMA + wgmma body ``pc::context_fwd`` on bf16 pools (#3,
K/V tiles gathered by cp.async) and on int8 / fp8 pools (#6, widened to
bf16 by the gathering warps, scales folded into scores and
probabilities). fp32 context and fp32 quantized context run the scalar
body of ``csrc/attention.cuh``.

The unquantized wrappers also take a pool of the other width than q's (a
bf16 pool under fp32 q, an fp32 pool under bf16 q; ``KV_TYPES`` codes 3
and 4): the bodies widen or narrow its rows in the load, as they widen
one-byte rows.

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


def paged_decode_splits(b, hq, hkv, max_blocks, block_size, sms):
    """How many blocks share one row's keys in the paged decode kernels
    (#2, #5): ``contiguous_splits`` over the table's capacity max_blocks x
    block_size (never the live lengths, which are on the device)."""
    return contiguous_splits(b, hq, hkv, max_blocks * block_size, sms)


def verify_columns(T, g):
    """(cp, column groups) of the paged verify kernels (#4, #7): a
    block's HEADS query columns are cp = max(1, HEADS // g) candidates of
    g heads each (capped by T; one candidate and HEADS heads of a group at
    g > HEADS), so ceil(T / cp) column groups cover a row's candidates."""
    cp = min(T, max(1, HEADS // g))
    return cp, -(-T // cp)


def paged_verify_splits(b, T, hq, hkv, max_blocks, block_size, sms):
    """How many blocks share one row's keys in the paged verify kernels
    (#4, #7): ``contiguous_splits`` over the table's capacity max_blocks x
    block_size (never the live lengths, which are on the device), counting
    its verify_columns column groups among the blocks."""
    return contiguous_splits(b, hq, hkv, max_blocks * block_size, sms,
                             column_groups=verify_columns(T, hq // hkv)[1])


# K/V dtype of a pool that is not q's -> the kernels' K/V type code: the
# one-byte payloads of a quantized pool, and an unquantized pool of the
# other width (bf16 under fp32 q, fp32 under bf16 q)
KV_TYPES = {torch.int8: 1, torch.float8_e4m3fn: 2, torch.bfloat16: 3,
            torch.float32: 4}
QUANT_TYPES = (torch.int8, torch.float8_e4m3fn)


def check_quant_inputs(kernel, q, k_pages, v_pages, k_scale, v_scale):
    """check_attention_inputs for `kernel` on int8 / fp8 payload pools, and
    float32 scale pools of shape (n_blocks, bs, hkv) on q's device. Returns
    q, k_pages, v_pages (16-byte aligned) and (k_scale, v_scale)
    (contiguous)."""
    q, k_pages, v_pages = check_attention_inputs(q, k_pages, v_pages,
                                                 QUANT_TYPES, kernel=kernel)
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t.device != q.device:
            raise ValueError(f"{name} must be on q's device, got {t.device}")
        if t.dtype != torch.float32 or t.shape != k_pages.shape[:3]:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, expected "
                             f"float32 {tuple(k_pages.shape[:3])}")
    return q, k_pages, v_pages, (k_scale.contiguous(), v_scale.contiguous())


def _checked(kernel, q, k_pages, v_pages, scales):
    """The inputs checked for `kernel`, unquantized (scales None) or
    quantized (scales (k_scale, v_scale)): q, k_pages, v_pages, the scales
    (None unquantized) and the kernels' K/V type code (0: K/V in q's
    dtype). The paged kernels take the head dims of the slot-mode configs
    (HEAD_DIMS)."""
    if scales is None:
        q, k_pages, v_pages = check_attention_inputs(
            q, k_pages, v_pages, tuple(DTYPES), kernel=kernel)
    else:
        q, k_pages, v_pages, scales = check_quant_inputs(
            kernel, q, k_pages, v_pages, *scales)
    kv_type = 0 if k_pages.dtype == q.dtype else KV_TYPES[k_pages.dtype]
    return q, k_pages, v_pages, scales, kv_type


def _launch(entry, q, k_pages, v_pages, o, scales, kv_type, tail,
            tail_types):
    """Call ``entry(q, k, v, o, *tail, kv_type, stream)``, or for a
    quantized pool (scales = (k_scale, v_scale)) its twin
    ``entry_quant_fwd(q, k, v, k_scale, v_scale, o, *tail, kv_type,
    stream)``; raise on a CUDA error."""
    stream = torch.cuda.current_stream(q.device).cuda_stream
    kv = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr())
    if scales is None:
        args = (*kv, o.data_ptr(), *tail, kv_type, stream)
        types = [_P] * 4 + tail_types + [_I, _P]
    else:
        k_scale, v_scale = scales
        entry = entry.replace("_fwd", "_quant_fwd")
        args = (*kv, k_scale.data_ptr(), v_scale.data_ptr(), o.data_ptr(),
                *tail, kv_type, stream)
        types = [_P] * 6 + tail_types + [_I, _P]
    err = _fn(entry, types)(*args)
    if err:
        raise RuntimeError(f"{entry}: CUDA error {err}")


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _splits(kernel, n_split, rows, d, device):
    """The split arguments of a decode-body entry, (n_split, part,
    counters, n_counters), for n_split splits over `rows` query rows: fp32
    partials (rows, n_split, d + 2) and `kernel`'s merge counters (null
    for one split); and their ctypes."""
    part = counters = None
    if n_split > 1:
        part = torch.empty(rows * n_split * (d + 2), dtype=torch.float32,
                           device=device)
        counters = merge_counters(kernel, rows, device)
    return ((n_split, _ptr(part), _ptr(counters),
             counters.numel() if counters is not None else 0),
            [_I, _P, _P, _I])


def _decode(kernel, q, k_pages, v_pages, scales, block_tables, kv_len,
            scale):
    """Launch the decode entry (quantized when `scales` is given) with the
    merge counters of `kernel` -> o."""
    q, k_pages, v_pages, scales, kv_type = _checked(kernel, q, k_pages,
                                                    v_pages, scales)
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
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    splits, split_types = _splits(
        kernel, paged_decode_splits(b, hq, hkv, nb, bs, sms), b * hq, d,
        q.device)
    _launch("paged_decode_attention_fwd", q, k_pages, v_pages, o, scales, kv_type,
            (tbl.data_ptr(), lens.data_ptr(), b, hq, hkv, d, bs, nb,
             float(scale), *splits, DTYPES[q.dtype]),
            [_P, _P, _I, _I, _I, _I, _I, _I, _F] + split_types + [_I])
    return o


def paged_decode_attention_cuda(q, k_pages, v_pages, block_tables, *,
                                kv_len=None, scale=None):
    """q (b,1,hq,d); pages (n_blocks,bs,hkv,d); block_tables (b,nb);
    kv_len (b,) (default: every table slot full) -> (b,1,hq,d)."""
    o = _decode("paged_decode_attention", q, k_pages, v_pages, None,
                block_tables, kv_len, scale)
    if o.numel():
        paged_decode_attention_cuda.launches += 1
    return o


def paged_decode_attention_quant_cuda(q, k_pages, v_pages, k_scale, v_scale,
                                      block_tables, *, kv_len=None,
                                      scale=None):
    """paged_decode_attention_cuda on int8 / fp8 payload pools
    (n_blocks,bs,hkv,d) with float32 scale pools k_scale, v_scale
    (n_blocks,bs,hkv) -> (b,1,hq,d) in q's dtype."""
    o = _decode("paged_decode_attention_quant", q, k_pages, v_pages,
                (k_scale, v_scale), block_tables, kv_len, scale)
    if o.numel():
        paged_decode_attention_quant_cuda.launches += 1
    return o


def _context(kernel, q, k_pages, v_pages, scales, block_tables, q_start,
             kv_len, scale):
    """Launch the context entry (quantized when `scales` is given) -> o."""
    q, k_pages, v_pages, scales, kv_type = _checked(kernel, q, k_pages,
                                                    v_pages, scales)
    b, C, hq, d = q.shape
    _, bs, hkv, _ = k_pages.shape
    tbl = _tables(block_tables, b, q.device)
    starts = lengths(q_start, b, q.device)
    lens = lengths(kv_len, b, q.device)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    _launch("paged_context_attention_fwd", q, k_pages, v_pages, o, scales, kv_type,
            (tbl.data_ptr(), starts.data_ptr(), lens.data_ptr(), b, C, hq,
             hkv, d, bs, tbl.shape[1], float(scale), DTYPES[q.dtype]),
            [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I])
    return o


def paged_context_attention_cuda(q, k_pages, v_pages, block_tables, *,
                                 q_start, kv_len, scale=None):
    """q (b,C,hq,d), row i token j at absolute position q_start[i] + j;
    pages already hold the chunk's K/V at [q_start, kv_len) -> (b,C,hq,d).
    """
    o = _context("paged_context_attention", q, k_pages, v_pages, None,
                 block_tables, q_start, kv_len, scale)
    if o.numel():
        paged_context_attention_cuda.launches += 1
    return o


def _verify(kernel, q, k_pages, v_pages, scales, block_tables, kv_start,
            kv_len, scale):
    """Launch the verify entry (quantized when `scales` is given) with the
    merge counters of `kernel` -> o."""
    q, k_pages, v_pages, scales, kv_type = _checked(kernel, q, k_pages,
                                                    v_pages, scales)
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
    splits, split_types = _splits(
        kernel, paged_verify_splits(b, T, hq, hkv, nb, bs, sms), b * T * hq,
        d, q.device)
    _launch("paged_verify_attention_fwd", q, k_pages, v_pages, o, scales, kv_type,
            (tbl.data_ptr(), starts.data_ptr(), lens.data_ptr(), b, T, hq,
             hkv, d, bs, nb, float(scale), *splits, DTYPES[q.dtype]),
            [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F] + split_types
            + [_I])
    return o


def paged_verify_attention_cuda(q, k_pages, v_pages, block_tables, *,
                                kv_start, kv_len, scale=None):
    """q (b,T,hq,d), T candidates per slot, row i's candidate j at absolute
    position kv_start[i] + j; pages already hold the candidates' K/V at
    [kv_start, kv_len) -> (b,T,hq,d), every position kept."""
    o = _verify("paged_verify_attention", q, k_pages, v_pages, None,
                block_tables, kv_start, kv_len, scale)
    if o.numel():
        paged_verify_attention_cuda.launches += 1
    return o


def paged_context_attention_quant_cuda(q, k_pages, v_pages, k_scale,
                                       v_scale, block_tables, *, q_start,
                                       kv_len, scale=None):
    """paged_context_attention_cuda on int8 / fp8 payload pools with
    float32 scale pools (n_blocks,bs,hkv)."""
    o = _context("paged_context_attention_quant", q, k_pages, v_pages,
                 (k_scale, v_scale), block_tables, q_start, kv_len, scale)
    if o.numel():
        paged_context_attention_quant_cuda.launches += 1
    return o


def paged_verify_attention_quant_cuda(q, k_pages, v_pages, k_scale, v_scale,
                                      block_tables, *, kv_start, kv_len,
                                      scale=None):
    """paged_verify_attention_cuda on int8 / fp8 payload pools with
    float32 scale pools (n_blocks,bs,hkv)."""
    o = _verify("paged_verify_attention_quant", q, k_pages, v_pages,
                (k_scale, v_scale), block_tables, kv_start, kv_len, scale)
    if o.numel():
        paged_verify_attention_quant_cuda.launches += 1
    return o


paged_decode_attention_cuda.launches = 0
paged_context_attention_cuda.launches = 0
paged_verify_attention_cuda.launches = 0
paged_decode_attention_quant_cuda.launches = 0
paged_context_attention_quant_cuda.launches = 0
paged_verify_attention_quant_cuda.launches = 0
