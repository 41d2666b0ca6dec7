"""Wrapper of the selective-scan CUDA kernel (``csrc/ssm_scan.cu``), the port
of repro.kernels.ssm_scan.ssm_scan_pallas.

``ssm_scan_cuda`` checks its inputs, allocates y and the final state,
launches on the current stream and counts the launch; it never falls back
to the plain version (``ref.ssm_scan_ref``) — ``ops`` chooses. ``LANES``,
``geometry`` and ``thread_map`` restate the kernel's launch geometry (L
lanes share one channel's state, ``THREADS`` a block) for the CPU tests;
the wrapper checks ``LANES`` against the library's own table on first
use.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import DTYPES

D_STATES = (4, 8, 16)          # the kernel's template instances
LANES = {4: 2, 8: 2, 16: 2}    # lanes sharing a channel (ss::lanes)
THREADS = 128                  # threads a block (ss::THREADS)

_P, _I = ctypes.c_void_p, ctypes.c_int
_CHECKED = []                  # libraries whose lanes match LANES


def geometry(b, din, ds):
    """(lanes L, channels a block, grid (x, y)) of the kernel's launch."""
    lanes = LANES[ds]
    ch = THREADS // lanes
    return lanes, ch, (-(-din // ch), b)


def thread_map(b, din, ds):
    """The kernel's index map over every launched thread: (row, channel,
    first state element) as flat int64 tensors (lane group g = thread // L
    holds channel c0 + g); a thread with channel >= din is dead, and each
    live one holds ds / L consecutive elements."""
    lanes, ch, (gx, gy) = geometry(b, din, ds)
    bx, by, t = torch.meshgrid(torch.arange(gx), torch.arange(gy),
                               torch.arange(THREADS), indexing="ij")
    return (by.flatten(), (bx * ch + t // lanes).flatten(),
            ((t % lanes) * (ds // lanes)).flatten())


def _lib():
    lib = build.library("ssm_scan")
    if lib not in _CHECKED:
        got = {ds: lib.ssm_scan_lanes(ds) for ds in D_STATES}
        if got != LANES:
            raise RuntimeError(f"ssm_scan library splits the state over "
                               f"{got} lanes, LANES says {LANES}")
        _CHECKED.append(lib)
    fn = lib.ssm_scan_fwd
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                   _I, _P]
    fn.restype = _I
    return fn


def _check(x, dt, A, B, C, D, h0):
    named = (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C), ("D", D)) \
        + ((("h0", h0),) if h0 is not None else ())
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != x.device:
            raise ValueError("all inputs must be on one device")
    if x.dim() != 3:
        raise ValueError(f"x must be (b, s, din), got {tuple(x.shape)}")
    b, s, din = x.shape
    ds = A.shape[-1]
    if ds not in D_STATES:
        raise ValueError(f"d_state {ds}: the kernel takes d_state in "
                         f"{D_STATES}")
    if s < 1:
        raise ValueError("the scan needs at least one step")
    want = {"dt": (b, s, din), "A": (din, ds), "B": (b, s, ds),
            "C": (b, s, ds), "D": (din,), "h0": (b, din, ds)}
    for name, t in named[1:]:
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} of shape {tuple(t.shape)}, expected "
                             f"{want[name]}")
    if x.dtype not in DTYPES or dt.dtype not in DTYPES:
        raise TypeError(f"x {x.dtype}, dt {dt.dtype}: the kernel takes "
                        "float32 or bfloat16")
    if B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"B {B.dtype} and C {C.dtype} must have x's dtype "
                        f"{x.dtype}")
    for name, t in named[2:]:
        if name in ("A", "D", "h0") and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


def ssm_scan_cuda(x, dt, A, B, C, D, *, h0=None):
    """x, dt (b, s, din); A (din, ds) fp32; B, C (b, s, ds) of x's dtype;
    D (din,) fp32; h0 (b, din, ds) fp32 or None (zeros), all CUDA tensors.
    Returns (y (b, s, din) in x's dtype, h_final (b, din, ds) fp32)."""
    _check(x, dt, A, B, C, D, h0)
    x, dt, A, B, C, D = (t.contiguous() for t in (x, dt, A, B, C, D))
    h0 = h0.contiguous() if h0 is not None else None
    b, s, din = x.shape
    ds = A.shape[-1]
    y = torch.empty_like(x)
    h = torch.empty((b, din, ds), dtype=torch.float32, device=x.device)
    if b == 0 or din == 0:
        return y, h
    err = _lib()(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                 C.data_ptr(), D.data_ptr(),
                 h0.data_ptr() if h0 is not None else None, y.data_ptr(),
                 h.data_ptr(), b, s, din, ds, DTYPES[x.dtype],
                 DTYPES[dt.dtype],
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssm_scan_fwd: CUDA error {err}")
    ssm_scan_cuda.launches += 1
    return y, h


ssm_scan_cuda.launches = 0
