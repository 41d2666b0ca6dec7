"""Wrappers of the flash-attention CUDA kernels: the forward
(``csrc/flash_attention.cu``), the port of
repro.kernels.flash_attention.flash_attention_pallas, and its backward
(``csrc/flash_attention_bwd.cu``), the port of the reference's
hand-written VJP repro.kernels.ops._fa_full_bwd.

``flash_attention_cuda`` checks its inputs, allocates the output (and,
for training, the rows' log-sum-exp), launches the kernel on the current
stream and counts the launch; ``flash_attention_bwd_cuda`` does the same
for the gradients. Neither falls back to the plain versions
(``ref.attention_ref``, ``ref.attention_fwd_lse_ref``,
``ref.attention_bwd_ref``) — ``ops`` chooses.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# head dims every kernel takes; #1 (this kernel) and #8 (contiguous decode)
# also take h2o-danube-1.8b's 80 and paligemma-3b's 256, which no paged
# (slot-mode) config has
HEAD_DIMS = (32, 64, 128)
CONTIGUOUS_HEAD_DIMS = (32, 64, 80, 128, 256)
# the bf16 kernel's warpgroup rows (64) hold whole GQA groups
BF16_MAX_GROUP = 64
# head dims of the training instances (the forward's log-sum-exp and the
# backward), with or without a sliding window: llama2-70b's 128, every
# reduced config's 64, h2o-danube-1.8b's 80 and paligemma-3b's 256
TRAIN_HEAD_DIMS = (64, 80, 128, 256)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _aligned(t):
    """Contiguous, with a 16-byte aligned base (the kernels load 16 bytes
    at a time); a view at an odd offset is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def check_attention_inputs(q, k, v, kv_dtypes=None, *, kernel,
                           head_dims=HEAD_DIMS):
    """Raise on what `kernel`'s CUDA kernel does not take: head dim (one of
    `head_dims`, checked first, on the shapes alone), device, dtype, GQA
    shape. K and V take q's dtype, or, where `kv_dtypes` is given (the
    quantized pools), one dtype of it. Returns q, k, v contiguous and
    16-byte aligned."""
    if q.shape[-1] not in head_dims or k.shape[-1] != q.shape[-1] \
            or v.shape != k.shape:
        raise ValueError(f"{kernel}: head dims {q.shape[-1]}/{k.shape[-1]}: "
                         f"the kernel takes d in {head_dims}, k and v alike")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if kv_dtypes is None and (t.dtype != q.dtype or t.dtype not in DTYPES):
            raise TypeError(f"{name}: dtype {t.dtype}; the kernels take "
                            "float32 or bfloat16, all inputs alike")
        if t.device != q.device:
            raise ValueError("q, k, v must be on one device")
    if kv_dtypes is not None and (q.dtype not in DTYPES
                                  or k.dtype not in kv_dtypes
                                  or v.dtype != k.dtype):
        raise TypeError(f"dtypes {q.dtype} / {k.dtype} / {v.dtype}: the "
                        "kernels take float32 or bfloat16 q and K, V of one "
                        f"dtype of {list(kv_dtypes)}")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"hq={q.shape[2]} is not a multiple of "
                         f"hkv={k.shape[2]}")
    return _aligned(q), _aligned(k), _aligned(v)


def lengths(x, b, device):
    """(b,) int32 contiguous device tensor from a length argument."""
    t = torch.as_tensor(x, device=device).to(torch.int32).contiguous()
    if t.shape != (b,):
        raise ValueError(f"length vector of shape {tuple(t.shape)}, "
                         f"expected ({b},)")
    return t


def _lib():
    lib = build.library("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                   _I, _F, _I, _P]
    fn.restype = _I
    return fn


def flash_attention_cuda(q, k, v, *, causal=True, window=0, kv_len=None,
                         kv_start=None, scale=None, return_lse=False):
    """q (b,sq,hq,d); k,v (b,skv,hkv,d) CUDA tensors -> (b,sq,hq,d), and
    with return_lse the rows' log-sum-exp of the scaled scores (b, hq, sq)
    float32 (0 on a row that sees no key) for the backward kernel."""
    # the training instances (return_lse) take the backward's head dims
    q, k, v = check_attention_inputs(
        q, k, v, kernel="flash_attention",
        head_dims=TRAIN_HEAD_DIMS if return_lse else CONTIGUOUS_HEAD_DIMS)
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if k.shape[0] != b:
        raise ValueError(f"batch {k.shape[0]} of k != batch {b} of q")
    if q.dtype == torch.bfloat16 and hq // hkv > BF16_MAX_GROUP:
        raise ValueError(f"GQA group of {hq // hkv} query heads: the bf16 "
                         f"kernel takes at most {BF16_MAX_GROUP} per kv head")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    o = torch.empty_like(q)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if o.numel() == 0:
        return (o, lse) if return_lse else o
    lens = lengths(kv_len, b, q.device) if kv_len is not None else None
    starts = lengths(kv_start, b, q.device) if kv_start is not None else None
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr() if return_lse else None,
                 lens.data_ptr() if lens is not None else None,
                 starts.data_ptr() if starts is not None else None,
                 b, sq, skv, hq, hkv, d, int(bool(causal)), int(window or 0),
                 float(scale), DTYPES[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd: CUDA error {err}")
    flash_attention_cuda.launches += 1
    return (o, lse) if return_lse else o


flash_attention_cuda.launches = 0


def _bwd_lib():
    fn = build.library("flash_attention_bwd").flash_attention_bwd
    fn.argtypes = [_P] * 12 + [_I] * 8 + [_F, _I, _P]
    fn.restype = _I
    return fn


def flash_attention_bwd_cuda(q, k, v, o, lse, do, *, causal=True, window=0,
                             kv_len=None, kv_start=None, scale=None):
    """Gradients (dq, dk, dv) of flash_attention_cuda's output o from its
    lse (b, hq, sq) float32 and the cotangent do (b, sq, hq, d), all CUDA
    tensors; the gradients take the inputs' dtype (fp32 sums). GQA sums dk
    and dv over each kv head's g query heads; window > 0 masks as the
    forward does."""
    q, k, v = check_attention_inputs(q, k, v, kernel="flash_attention_bwd",
                                     head_dims=TRAIN_HEAD_DIMS)
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype:
        raise ValueError(f"o {tuple(o.shape)} {o.dtype} and do "
                         f"{tuple(do.shape)} must have q's shape "
                         f"{tuple(q.shape)} and dtype")
    if lse.shape != (b, hq, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype}: expected "
                         f"({b}, {hq}, {sq}) float32")
    o, do, lse = _aligned(o), _aligned(do.to(q.dtype)), lse.contiguous()
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    # pass 1's output: D (b, hq, sq) on the SIMT body, each row's (lse
    # log2 e, D) on the tensor-core body (bf16 at d 64 and 128), whose
    # tiles copy 16-byte aligned windows of up to 132 floats past a row
    # (the kernel zeroes the 256 past the last)
    delta = torch.empty(2 * b * hq * sq + 256, dtype=torch.float32,
                        device=q.device)
    lens = lengths(kv_len, b, q.device) if kv_len is not None else None
    starts = lengths(kv_start, b, q.device) if kv_start is not None else None
    err = _bwd_lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                     dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                     lens.data_ptr() if lens is not None else None,
                     starts.data_ptr() if starts is not None else None,
                     b, sq, skv, hq, hkv, d, int(bool(causal)),
                     int(window or 0), float(scale), DTYPES[q.dtype],
                     torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd: CUDA error {err}")
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0
