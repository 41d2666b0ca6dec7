"""Plain PyTorch versions of the port's kernels: simple,
materialized, O(s^2) where applicable. They are the kernels' oracles on the
card and the path every CPU tensor takes.

Twins of repro.kernels.ref (same shapes, masks and dead-row contract), and
the selective scan of the Mamba layers (``ssm_scan_ref``, ``ssm_step``)
and the mLSTM recurrence (``mlstm_scan_ref``), below. The attention
versions take:
  q:     (b, s_q, h_q, d)
  k, v:  (b, s_kv, h_kv, d)      h_q % h_kv == 0 (GQA)
Scores, softmax and the weighted sum run in float32 whatever the input
dtype; the result is cast back to q's dtype.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _softmax_av(s, v):
    """Masked softmax over the last axis of s (b, hkv, g, sq, skv) and the
    weighted sum of v (b, skv, hkv, d) -> (b, sq, hkv, g, d). A probability
    is 0 where its score is <= NEG_INF / 2 and a row with no live key gives
    exact zeros."""
    m = s.amax(-1, keepdim=True)
    p = torch.where(s <= NEG_INF / 2, torch.zeros_like(s), torch.exp(s - m))
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgst,bthd->bshgd", p / l.clamp_min(1e-30), v)
    dead = (m <= NEG_INF / 2).squeeze(-1).permute(0, 3, 1, 2)[..., None]
    return torch.where(dead, torch.zeros_like(o), o)


def _scores(q, k, scale):
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, d)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    return torch.einsum("bshgd,bthd->bhgst", qg, k) * scale


def attention_ref(q, k, v, *, causal=True, window=0, q_offset=0,
                  kv_len=None, kv_start=None, scale=None):
    """Full materialized attention. q_offset: absolute position of q[0];
    window: query at position p sees keys in [p - window + 1, p] (0 = all);
    kv_len / kv_start (b,): keys at positions >= kv_len or < kv_start are
    masked."""
    orig = q.dtype
    q, k, v = q.float(), k.float(), v.float()
    b, sq, hq, d = q.shape
    skv = k.shape[1]
    s = _scores(q, k, scale)                           # (b,hkv,g,sq,skv)
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(skv, device=q.device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    mask = mask[None].expand(b, sq, skv)
    if kv_len is not None:
        kv_len = torch.as_tensor(kv_len, device=q.device)
        mask = mask & (kpos[None, None, :] < kv_len[:, None, None])
    if kv_start is not None:
        kv_start = torch.as_tensor(kv_start, device=q.device)
        mask = mask & (kpos[None, None, :] >= kv_start[:, None, None])
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    return _softmax_av(s, v).reshape(b, sq, hq, d).to(orig)


def context_attention_ref(q, k, v, *, q_start, kv_len, scale=None):
    """A chunk of new tokens attending causally to the prior cache plus
    itself. q (b, C, hq, d), row i token j at absolute position
    q_start[i] + j; k, v (b, S, hkv, d) the full cache view. Query j of row
    i sees keys kpos <= q_start[i] + j and kpos < kv_len[i]."""
    orig = q.dtype
    q, k, v = q.float(), k.float(), v.float()
    b, C, hq, d = q.shape
    skv = k.shape[1]
    s = _scores(q, k, scale)
    q_start = torch.as_tensor(q_start, device=q.device)
    kv_len = torch.as_tensor(kv_len, device=q.device)
    qpos = q_start[:, None] + torch.arange(C, device=q.device)[None]
    kpos = torch.arange(skv, device=q.device)
    mask = kpos[None, None, :] <= qpos[:, :, None]     # (b, C, skv)
    mask = mask & (kpos[None, :] < kv_len[:, None])[:, None, :]
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    return _softmax_av(s, v).reshape(b, C, hq, d).to(orig)


def decode_attention_ref(q, k, v, *, kv_len=None, kv_start=None,
                         scale=None):
    """One-token decode against a contiguous cache: q (b, 1, hq, d); k, v
    (b, S, hkv, d); keys at positions >= kv_len or < kv_start are masked
    (no causal term: every cached key is in the past)."""
    if q.shape[1] != 1:
        raise ValueError(f"decode takes one query token per row, got "
                         f"{q.shape[1]}")
    if kv_len is None:
        kv_len = torch.full((q.shape[0],), k.shape[1], dtype=torch.int32,
                            device=q.device)
    return attention_ref(q, k, v, causal=False, kv_len=kv_len,
                         kv_start=kv_start, scale=scale)


def gather_pages(pages, block_tables):
    """(n_blocks, bs, h, d) pages + (b, nb) tables -> contiguous
    (b, nb * bs, h, d) caches (null table entries gather the trash page;
    callers mask them with kv_len)."""
    b, nb = block_tables.shape
    _, bs, h, d = pages.shape
    return pages[block_tables.long()].reshape(b, nb * bs, h, d)


def paged_decode_attention_ref(q, k_pages, v_pages, block_tables, *,
                               kv_len=None, scale=None):
    """q (b, 1, hq, d) against each row's gathered pages, keys < kv_len."""
    k = gather_pages(k_pages, block_tables)
    v = gather_pages(v_pages, block_tables)
    if kv_len is None:
        kv_len = torch.full((q.shape[0],), k.shape[1], dtype=torch.int32,
                            device=q.device)
    return attention_ref(q, k, v, causal=False, kv_len=kv_len, scale=scale)


def paged_context_attention_ref(q, k_pages, v_pages, block_tables, *,
                                q_start, kv_len, scale=None):
    """The context oracle over each row's gathered pages (which already
    hold the chunk's own K/V at [q_start, kv_len))."""
    k = gather_pages(k_pages, block_tables)
    v = gather_pages(v_pages, block_tables)
    return context_attention_ref(q, k, v, q_start=q_start, kv_len=kv_len,
                                 scale=scale)


def paged_verify_attention_ref(q, k_pages, v_pages, block_tables, *,
                               kv_start, kv_len, scale=None):
    """Multi-token verification (speculative decoding): q (b, T, hq, d) is
    each slot's candidate chunk, row i's candidate j at absolute position
    kv_start[i] + j; the pages already hold the candidates' K/V at
    [kv_start, kv_len). It is the context oracle with the per-slot
    committed length as the chunk origin, and every position's output is
    kept. A row with kv_len == 0 sees no key and gives exact zeros."""
    return paged_context_attention_ref(q, k_pages, v_pages, block_tables,
                                       q_start=kv_start, kv_len=kv_len,
                                       scale=scale)


# ---------------------------------------------------------------------------
# Quantized page pools (int8 / fp8 payloads with per-token-per-head float32
# scales, models/quant.py): each dequantizes the WHOLE pool to float32 and
# calls the unquantized plain version, as repro.kernels.ref does.
# ---------------------------------------------------------------------------

def dequant_pages(pages, scales):
    """(n_blocks, bs, h, d) quantized payload + (n_blocks, bs, h) float32
    scales -> float32 pages."""
    return pages.float() * scales[..., None].float()


def paged_decode_attention_quant_ref(q, k_pages, v_pages, k_scale, v_scale,
                                     block_tables, *, kv_len=None,
                                     scale=None):
    return paged_decode_attention_ref(
        q, dequant_pages(k_pages, k_scale), dequant_pages(v_pages, v_scale),
        block_tables, kv_len=kv_len, scale=scale)


def paged_context_attention_quant_ref(q, k_pages, v_pages, k_scale, v_scale,
                                      block_tables, *, q_start, kv_len,
                                      scale=None):
    return paged_context_attention_ref(
        q, dequant_pages(k_pages, k_scale), dequant_pages(v_pages, v_scale),
        block_tables, q_start=q_start, kv_len=kv_len, scale=scale)


def paged_verify_attention_quant_ref(q, k_pages, v_pages, k_scale, v_scale,
                                     block_tables, *, kv_start, kv_len,
                                     scale=None):
    return paged_verify_attention_ref(
        q, dequant_pages(k_pages, k_scale), dequant_pages(v_pages, v_scale),
        block_tables, kv_start=kv_start, kv_len=kv_len, scale=scale)


def ssm_scan_ref(x, dt, A, B, C, D, *, h0=None):
    """Sequential selective scan (Mamba S6), twin of repro.kernels.ref.
    ssm_scan_ref: x, dt (b, s, din); A (din, ds); B, C (b, s, ds); D (din,);
    h0 (b, din, ds) or None (zeros); any s >= 1. Runs in float32. Returns
    (y (b, s, din) in x's dtype, h_final (b, din, ds) float32)."""
    xf, dtf, Bf, Cf = (t.float() for t in (x, dt, B, C))
    b, s, din = x.shape
    h = (torch.zeros((b, din, A.shape[-1]), dtype=torch.float32,
                     device=x.device) if h0 is None else h0.float())
    ys = []
    for t in range(s):
        h, y = _ssm_update(xf[:, t], dtf[:, t], A, Bf[:, t], Cf[:, t], h)
        ys.append(y)
    y = torch.stack(ys, 1) + xf * D.float()[None, None]
    return y.to(x.dtype), h


def _ssm_update(xt, dtt, A, Bt, Ct, h):
    dA = torch.exp(dtt[..., None] * A.float()[None])          # (b, din, ds)
    dBx = (dtt * xt)[..., None] * Bt[:, None, :]
    h = dA * h + dBx
    return h, torch.einsum("bdn,bn->bd", h, Ct)


def ssm_step(x_t, dt_t, A, B_t, C_t, D, h):
    """One decode step of the scan (twin of repro.kernels.ops.ssm_step,
    plain torch on every device): x_t, dt_t (b, din); B_t, C_t (b, ds);
    h (b, din, ds) float32. Returns (y (b, din) in x_t's dtype, h)."""
    xf = x_t.float()
    h, y = _ssm_update(xf, dt_t.float(), A, B_t.float(), C_t.float(), h)
    y = y + xf * D.float()[None]
    return y.to(x_t.dtype), h


def mlstm_scan_ref(q, k, v, i_gate, f_gate, *, C0=None, n0=None):
    """Sequential mLSTM oracle (sigmoid-softened gating, as in the
    reference). q, k (b, s, h, dk); v (b, s, h, dv); i_gate, f_gate
    (b, s, h) in (0, 1); state C (b, h, dk, dv), n (b, h, dk), float32.
    h_t = (q_t^T C_t) / max(|q_t^T n_t|, 1). Returns (y in q's dtype,
    (C, n))."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    qf, kf, vf, i_f, f_f = (t.float() for t in (q, k, v, i_gate, f_gate))
    C = (torch.zeros((b, h, dk, dv), device=q.device) if C0 is None
         else C0.float())
    n = torch.zeros((b, h, dk), device=q.device) if n0 is None else n0.float()
    scale = 1.0 / math.sqrt(dk)
    ys = []
    for t in range(s):
        qt, kt, vt, it, ft = (x[:, t] for x in (qf, kf, vf, i_f, f_f))
        C = ft[..., None, None] * C + it[..., None, None] * (
            kt[..., :, None] * vt[..., None, :])
        n = ft[..., None] * n + it[..., None] * kt
        num = torch.einsum("bhk,bhkv->bhv", qt * scale, C)
        den = torch.einsum("bhk,bhk->bh", qt * scale, n).abs()
        ys.append(num / den.clamp_min(1.0)[..., None])
    y = torch.stack(ys, dim=1) if ys else vf[:, :0]
    return y.to(q.dtype), (C, n)
