"""xLSTM blocks of the port (twin of repro.models.xlstm): mLSTM (matrix
memory, chunked linear attention) and sLSTM (scalar memory, a sequential
recurrence with exponential gating and the m_t stabilizer).

As in the reference, mLSTM gates are sigmoids (softened from the paper's
exponential input gate) so that the chunked-parallel form stays bounded,
and the sLSTM recurrent matrices are block-diagonal per head. Every
weight product goes through ``quant.mm``, so an int8-weight model
(``quant.QUANT_LEAVES``: w_up, wq, wk, wv, w_i, w_f, w_z, w_o, out_proj)
takes a plain one's place. The recurrences are plain torch
(``kernels.ops.mlstm_scan`` / ``mlstm_step`` and the sLSTM step below),
as the reference leaves them to jnp: there is no TPU kernel to port.

State per row: mLSTM {"C": (b, h, qk_h, v_h), "n": (b, h, qk_h)}, sLSTM
{"c", "n", "m", "h": (b, d)}, all float32. ``valid`` (b, s) masks pad
steps out of the state: an mLSTM pad step has i = 0 and f = 1, an sLSTM
pad step keeps the previous state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.quant import mm

GATES = ("z", "i", "f", "o")


def m_d_inner(cfg):
    return cfg.ssm_expand * cfg.d_model


def m_qk_dim(cfg):
    return int(m_d_inner(cfg) * cfg.xlstm_qk_dim_factor)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

# An mLSTM layer runs in two parts, so that a tensor-parallel stage (shards
# that each hold a slice of din: ``models.model``) can sum its shards'
# products between them: ``mlstm_in``, each shard's row-parallel q / k / v
# and gate preactivations (partial sums) and its slice of the gate z, then
# ``mlstm_out`` once, from the sums and the whole z: the gates, the cell
# and out_proj (which the rules replicate).

PRE = ("q", "k", "v", "i", "f")


def mlstm_in(p, x):
    """x (b, s, d) -> ({"q", "k", "v", "i", "f"} the products of xi with
    wq, wk, wv, w_i, w_f, flat (b, s, .); z (b, s, din))."""
    xi, z = mm(x, p["w_up"]).chunk(2, dim=-1)           # (b, s, din) each
    return {n: mm(xi, p[w]) for n, w in zip(PRE, ("wq", "wk", "wv", "w_i",
                                                  "w_f"))}, z


def _mlstm_qkv_gates(pre, cfg, valid=None):
    b, s, _ = pre["q"].shape
    h = cfg.num_heads
    din, qk = m_d_inner(cfg), m_qk_dim(cfg)
    q = pre["q"].reshape(b, s, h, qk // h)
    k = pre["k"].reshape(b, s, h, qk // h)
    v = pre["v"].reshape(b, s, h, din // h)
    ig = torch.sigmoid(pre["i"])                        # (b, s, h)
    fg = torch.sigmoid(pre["f"])
    if valid is not None:
        vm = valid.to(ig.dtype)[..., None]
        ig = ig * vm                                    # pad: i = 0
        fg = fg * vm + (1.0 - vm)                       # pad: f = 1
    return q, k, v, ig, fg


def mlstm_out(p, pre, z, cfg, *, valid=None, cache=None, step=False):
    """The cell and out_proj from ``mlstm_in``'s whole products `pre` and
    gate z: a scan over the sequence from the state `cache` (None: zeros),
    or with ``step`` one decode step against it. Returns (out, new_cache
    in `cache`'s dtypes, or None without a cache)."""
    q, k, v, ig, fg = _mlstm_qkv_gates(pre, cfg, valid)
    b, s = z.shape[:2]
    if step:
        y, (C, n) = ops.mlstm_step(q[:, 0], k[:, 0], v[:, 0], ig[:, 0],
                                   fg[:, 0], cache["C"].float(),
                                   cache["n"].float())
    else:
        C0 = n0 = None
        if cache is not None:
            C0, n0 = cache["C"], cache["n"]
        y, (C, n) = ops.mlstm_scan(q, k, v, ig, fg, C0=C0, n0=n0)
    out = mm(y.reshape(b, s, -1) * F.silu(z), p["out_proj"])
    if cache is None:
        return out, None
    return out, {"C": C.to(cache["C"].dtype), "n": n.to(cache["n"].dtype)}


def mlstm_prefill(p, x, cfg, *, valid=None, cache=None):
    """x (b, s, d), from the state `cache` (None: zeros). Returns (out,
    new_cache in `cache`'s dtypes, or None without a cache)."""
    pre, z = mlstm_in(p, x)
    return mlstm_out(p, pre, z, cfg, valid=valid, cache=cache)


def mlstm_decode(p, x, cfg, *, cache):
    """x (b, 1, d) against the state `cache`. Returns (out, new_cache)."""
    pre, z = mlstm_in(p, x)
    return mlstm_out(p, pre, z, cfg, cache=cache, step=True)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def _rec(p, name, hp):
    """Block-diagonal recurrent product: hp (b, heads, dh) by r (heads, dh,
    dh) -> (b, d)."""
    return torch.einsum("bhk,hkj->bhj", hp, p[name]).reshape(hp.shape[0], -1)


def slstm_gates(p, x_t, h_prev, cfg):
    """Per-step gate preactivations. x_t (b, d); h_prev (b, d)."""
    b, d = x_t.shape
    hp = h_prev.reshape(b, cfg.num_heads, d // cfg.num_heads)
    return tuple(mm(x_t, p[f"w_{g}"]) + _rec(p, f"r_{g}", hp) + p[f"b_{g}"]
                 for g in GATES)


def _slstm_step_pre(p, g_t, state, cfg):
    """One step given the input projections g_t = {z, i, f, o: (b, d)}."""
    h = state["h"]
    b, d = h.shape
    hp = h.to(g_t["z"].dtype).reshape(b, cfg.num_heads, d // cfg.num_heads)
    pre = [g_t[g] + _rec(p, f"r_{g}", hp) for g in GATES]
    return _slstm_core(*pre, state["c"], state["n"], state["m"])


def _slstm_core(zi, ii, ff, oo, c, n, m):
    zi, ii, ff, oo = (t.float() for t in (zi, ii, ff, oo))
    z = torch.tanh(zi)
    o = torch.sigmoid(oo)
    logf = F.logsigmoid(ff)                 # exp gate through the sigmoid
    m_new = torch.maximum(logf + m, ii)
    i_s = torch.exp(ii - m_new)
    f_s = torch.exp(logf + m - m_new)
    c = f_s * c + i_s * z
    n = f_s * n + i_s
    return {"c": c, "n": n, "m": m_new, "h": o * c / n.clamp_min(1.0)}


def slstm_step(p, x_t, state, cfg):
    """One sLSTM step with exponential gating and the stabilizer. state:
    {"c", "n", "m", "h"} each (b, d) float32."""
    zi, ii, ff, oo = slstm_gates(p, x_t, state["h"].to(x_t.dtype), cfg)
    return _slstm_core(zi, ii, ff, oo, state["c"], state["n"], state["m"])


def slstm_prefill(p, x, cfg, *, valid=None, cache=None):
    """Sequential scan over x (b, s, d) from the state `cache` (None:
    zeros). The input-side gate projections run as one product each before
    the scan, as in the reference. Returns (out, new_cache in `cache`'s
    dtypes, or None without a cache)."""
    b, s, d = x.shape
    state = cache if cache is not None else slstm_init_state(
        b, d, device=x.device)
    state = {k: v.float() for k, v in state.items()}
    gx = {g: mm(x, p[f"w_{g}"]) + p[f"b_{g}"] for g in GATES}
    if ops.shapes_only(x) and s > 1:
        y, state = _slstm_meta_scan(p, gx, state, cfg, valid)
        out = mm(y.to(x.dtype), p["out_proj"])
        if cache is None:
            return out, None
        return out, {k: state[k].to(cache[k].dtype) for k in state}
    hs = []
    for t in range(s):
        new = _slstm_step_pre(p, {g: gx[g][:, t] for g in GATES}, state, cfg)
        if valid is not None:
            vm = valid[:, t].float()[:, None]
            new = {k: vm * new[k] + (1 - vm) * state[k] for k in state}
        state = new
        hs.append(new["h"])
    y = torch.stack(hs, dim=1).to(x.dtype)               # (b, s, d)
    out = mm(y, p["out_proj"])
    if cache is None:
        return out, None
    return out, {k: state[k].to(cache[k].dtype) for k in state}


def _slstm_meta_scan(p, gx, state, cfg, valid):
    """The sLSTM scan on the meta device, where every step has the same
    shapes: step 0 counted s times (``ops.RepeatedStep``) stands for the
    loop, in the forward and the backward. Returns (h of every step
    (b, s, d) float32, the final state)."""
    b, s, d = gx["z"].shape
    keys = sorted(state)
    seqs = [gx[g] for g in GATES] + ([valid] if valid is not None else [])

    def step(*args):
        seq, rest = args[:len(seqs)], args[len(seqs):]
        g_t = {g: t[:, 0] for g, t in zip(GATES, seq)}
        st = dict(zip(keys, rest[:4]))
        new = _slstm_step_pre(dict(zip((f"r_{g}" for g in GATES),
                                       rest[4:])), g_t, st, cfg)
        if valid is not None:
            vm = seq[4][:, 0].float()[:, None]
            new = {k: vm * new[k] + (1 - vm) * st[k] for k in st}
        return tuple(new[k] for k in keys)
    out = ops.RepeatedStep.apply(step, s, len(seqs), *seqs,
                                 *(state[k] for k in keys),
                                 *(p[f"r_{g}"] for g in GATES))
    state = dict(zip(keys, out))
    # torch.stack of the s steps' h: the same bytes as this copy
    return state["h"][:, None].expand(b, s, d).contiguous(), state


def slstm_decode(p, x, cfg, *, cache):
    """x (b, 1, d) against the state `cache`. Returns (out, new_cache)."""
    state = {k: v.float() for k, v in cache.items()}
    new = slstm_step(p, x[:, 0], state, cfg)
    out = mm(new["h"].to(x.dtype)[:, None, :], p["out_proj"])
    return out, {k: new[k].to(cache[k].dtype) for k in cache}


def slstm_init_state(b, d, *, device):
    z = torch.zeros((b, d), dtype=torch.float32, device=device)
    return {"c": z, "n": z, "m": z, "h": z}
