"""Kernel entry points used by the model code (twins of
repro.kernels.ops.flash_attention / decode_attention /
paged_decode_attention / paged_context_attention /
paged_verify_attention, each paged entry with its quantized-pool variant,
and ssm_scan, the Mamba layers' selective scan).

Dispatch is by the tensor's device: a CUDA tensor goes to the hand-written
kernel, a CPU tensor to its plain PyTorch version in ``ref``. The scoped
``backend("plain")`` switch runs the plain versions on the card on purpose,
for tests and chip_smoke.py only; the library never sets it. Each kernel
wrapper counts its launches (``launch_counts``). ``k_scale`` / ``v_scale``
on a paged entry mark a quantized pool (int8 / fp8 payload, float32
per-token-per-head scales) and select its quantized kernel or plain
version.

``mlstm_scan`` / ``mlstm_step`` (the xLSTM matrix-memory layers) are plain
torch on every device, as the reference computes them with plain jnp: the
JAX package has no Pallas kernel for them.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.paged_attention import (
    paged_context_attention_cuda, paged_context_attention_quant_cuda,
    paged_decode_attention_cuda, paged_decode_attention_quant_cuda,
    paged_verify_attention_cuda, paged_verify_attention_quant_cuda)
from repro_torch.kernels.ssm_scan import ssm_scan_cuda

_BACKEND = "kernel"        # "kernel" | "plain"

KERNELS = {
    "flash_attention": flash_attention_cuda,
    "paged_decode_attention": paged_decode_attention_cuda,
    "paged_context_attention": paged_context_attention_cuda,
    "decode_attention": decode_attention_cuda,
    "paged_verify_attention": paged_verify_attention_cuda,
    "paged_decode_attention_quant": paged_decode_attention_quant_cuda,
    "paged_context_attention_quant": paged_context_attention_quant_cuda,
    "paged_verify_attention_quant": paged_verify_attention_quant_cuda,
    "ssm_scan": ssm_scan_cuda,
}


@contextlib.contextmanager
def backend(name: str):
    """``with ops.backend("plain"): ...`` runs the plain versions on CUDA
    tensors too, restoring the previous backend even on error."""
    global _BACKEND
    if name not in ("kernel", "plain"):
        raise ValueError(f"unknown backend {name!r}")
    prev, _BACKEND = _BACKEND, name
    try:
        yield
    finally:
        _BACKEND = prev


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def _kernel_for(x) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no kernel path for device {x.device}")
    return _BACKEND == "kernel"


def _quant(k_scale, v_scale) -> bool:
    if (k_scale is None) != (v_scale is None):
        raise ValueError("a quantized pool needs both k_scale and v_scale")
    return k_scale is not None


def flash_attention(q, k, v, *, causal=True, window=0, kv_len=None,
                    kv_start=None, scale=None):
    """q (b,sq,hq,d); k,v (b,skv,hkv,d); GQA via hq % hkv == 0. window > 0:
    each query sees the previous `window` keys, itself included."""
    if _kernel_for(q):
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    kv_len=kv_len, kv_start=kv_start,
                                    scale=scale)
    return ref.attention_ref(q, k, v, causal=causal, window=window,
                             kv_len=kv_len, kv_start=kv_start, scale=scale)


def decode_attention(q, k, v, *, kv_len=None, kv_start=None, scale=None):
    """q (b,1,hq,d) against a contiguous cache k,v (b,S,hkv,d); keys at
    positions >= kv_len or < kv_start (b,) are masked."""
    if _kernel_for(q):
        return decode_attention_cuda(q, k, v, kv_len=kv_len,
                                     kv_start=kv_start, scale=scale)
    return ref.decode_attention_ref(q, k, v, kv_len=kv_len,
                                    kv_start=kv_start, scale=scale)


def paged_decode_attention(q, k_pages, v_pages, block_tables, *, kv_len=None,
                           scale=None, k_scale=None, v_scale=None):
    """q (b,1,hq,d) against pages (n_blocks, block_size, hkv, d) through
    block_tables (b, max_blocks); kv_len (b,) valid lengths. k_scale,
    v_scale (n_blocks, block_size, hkv) float32 mark an int8 / fp8 pool."""
    if _quant(k_scale, v_scale):
        if _kernel_for(q):
            return paged_decode_attention_quant_cuda(
                q, k_pages, v_pages, k_scale, v_scale, block_tables,
                kv_len=kv_len, scale=scale)
        return ref.paged_decode_attention_quant_ref(
            q, k_pages, v_pages, k_scale, v_scale, block_tables,
            kv_len=kv_len, scale=scale)
    if _kernel_for(q):
        return paged_decode_attention_cuda(q, k_pages, v_pages, block_tables,
                                           kv_len=kv_len, scale=scale)
    return ref.paged_decode_attention_ref(q, k_pages, v_pages, block_tables,
                                          kv_len=kv_len, scale=scale)


def paged_context_attention(q, k_pages, v_pages, block_tables, *, q_start,
                            kv_len, scale=None, k_scale=None, v_scale=None):
    """q (b,C,hq,d), row i token j at absolute position q_start[i] + j,
    attending causally to the pages (which already hold the chunk's K/V at
    [q_start, kv_len)) through block_tables. k_scale / v_scale mark a
    quantized pool, as in paged_decode_attention."""
    if _quant(k_scale, v_scale):
        if _kernel_for(q):
            return paged_context_attention_quant_cuda(
                q, k_pages, v_pages, k_scale, v_scale, block_tables,
                q_start=q_start, kv_len=kv_len, scale=scale)
        return ref.paged_context_attention_quant_ref(
            q, k_pages, v_pages, k_scale, v_scale, block_tables,
            q_start=q_start, kv_len=kv_len, scale=scale)
    if _kernel_for(q):
        return paged_context_attention_cuda(q, k_pages, v_pages,
                                            block_tables, q_start=q_start,
                                            kv_len=kv_len, scale=scale)
    return ref.paged_context_attention_ref(q, k_pages, v_pages, block_tables,
                                           q_start=q_start, kv_len=kv_len,
                                           scale=scale)


def paged_verify_attention(q, k_pages, v_pages, block_tables, *, kv_start,
                           kv_len, scale=None, k_scale=None, v_scale=None):
    """Speculative verification: q (b,T,hq,d), row i's candidate j at
    absolute position kv_start[i] + j (the slot's committed length),
    attending causally to the committed pages and the candidate prefix
    (whose K/V the pages already hold at [kv_start, kv_len)); the output
    is kept at every position. Rows with kv_len == 0 give exact zeros.
    k_scale / v_scale mark a quantized pool, as in paged_decode_attention."""
    if _quant(k_scale, v_scale):
        if _kernel_for(q):
            return paged_verify_attention_quant_cuda(
                q, k_pages, v_pages, k_scale, v_scale, block_tables,
                kv_start=kv_start, kv_len=kv_len, scale=scale)
        return ref.paged_verify_attention_quant_ref(
            q, k_pages, v_pages, k_scale, v_scale, block_tables,
            kv_start=kv_start, kv_len=kv_len, scale=scale)
    if _kernel_for(q):
        return paged_verify_attention_cuda(q, k_pages, v_pages, block_tables,
                                           kv_start=kv_start, kv_len=kv_len,
                                           scale=scale)
    return ref.paged_verify_attention_ref(q, k_pages, v_pages, block_tables,
                                          kv_start=kv_start, kv_len=kv_len,
                                          scale=scale)


def ssm_scan(x, dt, A, B, C, D, *, h0=None):
    """Selective scan (Mamba S6): x, dt (b, s, din); A (din, ds); B, C
    (b, s, ds); D (din,); h0 (b, din, ds) or None. Returns (y in x's dtype,
    h_final float32); see ref.ssm_scan_ref."""
    if _kernel_for(x):
        return ssm_scan_cuda(x, dt, A, B, C, D, h0=h0)
    return ref.ssm_scan_ref(x, dt, A, B, C, D, h0=h0)


def mlstm_scan(q, k, v, i_gate, f_gate, *, C0=None, n0=None, chunk=128):
    """Chunked mLSTM (twin of the reference's, its chunk length and its
    order of fp32 sums); see ref.mlstm_scan_ref. q, k (b, s, h, dk); v
    (b, s, h, dv); gates (b, s, h) in (0, 1) (sigmoid); C0 (b, h, dk, dv),
    n0 (b, h, dk) or None. Returns (y in q's dtype, (C, n) float32)."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:                         # pad steps: i = 0, f = 1 (identity)
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        i_gate = F.pad(i_gate, (0, 0, 0, pad))
        f_gate = F.pad(f_gate, (0, 0, 0, pad), value=1.0)
    nc = (s + pad) // chunk
    scale = 1.0 / (dk ** 0.5)

    def r(t, *last):
        return t.float().reshape(b, nc, chunk, h, *last)

    qs, ks, vs, i_s, f_s = r(q, dk), r(k, dk), r(v, dv), r(i_gate), \
        r(f_gate)
    dev = q.device
    C = (torch.zeros((b, h, dk, dv), device=dev) if C0 is None
         else C0.float())
    n = torch.zeros((b, h, dk), device=dev) if n0 is None else n0.float()
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=dev))
    ys = []
    for c in range(nc):
        qc, kc, vc, ic, fc = (t[:, c] for t in (qs, ks, vs, i_s, f_s))
        cum = torch.cumsum(torch.log(fc.clamp_min(1e-30)), dim=1)  # log F_t
        # intra-chunk: decay[t, s] = exp(cum_t - cum_s) for s <= t (<= 1)
        dec = torch.exp((cum[:, :, None] - cum[:, None, :]).clamp(max=0.0))
        sc = torch.einsum("bthd,bshd->bhts", qc * scale, kc)
        sc = sc * (dec * ic[:, None, :, :]).permute(0, 3, 1, 2)
        sc = torch.where(tri, sc, torch.zeros_like(sc))
        Ft = torch.exp(cum)                                      # (b, c, h)
        q_dec = qc * scale * Ft[..., None]
        num = torch.einsum("bhts,bshd->bthd", sc, vc) + torch.einsum(
            "bthk,bhkv->bthv", q_dec, C)
        den = (sc.sum(-1).permute(0, 2, 1)
               + torch.einsum("bthk,bhk->bth", q_dec, n)).abs()
        ys.append(num / den.clamp_min(1.0)[..., None])
        # carry: C <- F_c C + sum_s (F_c / F_s) i_s k_s v_s^T
        rdec = torch.exp((cum[:, -1:, :] - cum).clamp(max=0.0)) * ic
        kiv = torch.einsum("bshk,bsh,bshv->bhkv", kc, rdec, vc)
        kin = torch.einsum("bshk,bsh->bhk", kc, rdec)
        Fc = Ft[:, -1]
        C = Fc[..., None, None] * C + kiv
        n = Fc[..., None] * n + kin
    y = torch.stack(ys, dim=1).reshape(b, nc * chunk, h, dv)[:, :s]
    return y.to(q.dtype), (C, n)


def mlstm_step(q_t, k_t, v_t, i_t, f_t, C, n):
    """One mLSTM decode step. q_t, k_t (b, h, dk); v_t (b, h, dv); gates
    (b, h); C (b, h, dk, dv), n (b, h, dk) float32. Returns (y in q_t's
    dtype, (C, n))."""
    scale = 1.0 / (q_t.shape[-1] ** 0.5)
    qf = q_t.float() * scale
    kf = k_t.float()
    C = f_t[..., None, None] * C + i_t[..., None, None] * (
        kf[..., :, None] * v_t.float()[..., None, :])
    n = f_t[..., None] * n + i_t[..., None] * kf
    num = torch.einsum("bhk,bhkv->bhv", qf, C)
    den = torch.einsum("bhk,bhk->bh", qf, n).abs()
    y = num / den.clamp_min(1.0)[..., None]
    return y.to(q_t.dtype), (C, n)
