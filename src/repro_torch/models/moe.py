"""Mixture-of-Experts MLP of the port: top-k router and the two
single-device capacity dispatches of the reference (repro.models.moe),
chosen by ``MOE_DISPATCH``.

"grouped" (the default; twin of _moe_grouped, the path the reference's
``moe_mlp`` takes outside a mesh): ranking and capacity are per batch
row: row i's tokens fill each expert's C slots in token order, a token
past its expert's capacity is dropped (its combine weight is 0), and
decode-sized rows (s * k <= 64) get C = s, which drops nothing since an
expert appears at most once in a token's top-k. The capacity therefore
depends only on the row's (padded) width, so rows are independent of
their batch-mates.

"global" (twin of _moe_global, the reference's measurement baseline):
one rank cumsum over all b * s tokens and one buffer of C slots an expert,
dropless (C = T) up to T = 8192 tokens and C = capacity_factor T k / E
above.

The expert products stay torch.einsum, batched over the expert axis, as
the reference left them to XLA; an int8 weight ({"q", "s"}, s (E, out)) is
widened and post-scaled. Training adds the router's load-balancing loss
(``return_aux``, the reference's _aux_loss).

Tensor parallelism (a pipeline stage's shards, ``models.model._sharded``):
every shard routes every token with the replicated router and the whole
layer's capacity, under either dispatch. An expert-parallel shard
(``experts=(first, count)``, the reference's _moe_local) holds and
computes only its experts' assignments, the others' combine weight 0 on
it; its ranks are still taken over all E experts, so which assignments
drop is the whole layer's (under "global", as GSPMD computes the
reference's on a TP stage). A d_ff-parallel shard holds every expert's
d_ff slice and computes them all. The shards' outputs sum to the layer's.
The reference's production-mesh path (_moe_shard_map, its psum inside
shard_map) is the dry run's, not ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import gelu
from repro_torch.models.quant import is_quantized


MOE_DISPATCH = "grouped"            # "grouped" | "global"


def moe_mlp(p, x, cfg, *, return_aux=False, experts=None):
    """x (b, s, d) -> (b, s, d), and with return_aux the router's
    load-balancing loss (a float32 scalar), by ``MOE_DISPATCH``.
    ``experts=(first, count)``: `p` holds only those experts (an
    expert-parallel shard), whose share of the output this returns."""
    if MOE_DISPATCH == "global":
        return _moe_global(p, x, cfg, return_aux=return_aux, experts=experts)
    if MOE_DISPATCH != "grouped":
        raise ValueError(f"unknown MOE_DISPATCH {MOE_DISPATCH!r}")
    return _moe_grouped(p, x, cfg, return_aux=return_aux, experts=experts)


def _moe_grouped(p, x, cfg, *, return_aux, experts=None):
    b, s, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    logits = (x @ p["router"]).float()                          # (b, s, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1)        # (b, s, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    C = s if s * k <= 64 else max(int(cfg.capacity_factor * s * k / E), 1)

    fe = expert_ids.reshape(b, s * k)
    fg = gate_vals.reshape(b, s * k)
    fl, owned = fe, None                # the ids of the experts p holds
    if experts is not None:
        # another shard's expert gets id E (this shard's count), whose
        # one-hot row is all zero: it takes no rank and lands in the drop
        # slot
        first, E = experts
        fl = fe - first
        owned = (fl >= 0) & (fl < E)
        fl = torch.where(owned, fl, torch.full_like(fl, E))
    onehot = _one_hot(fl, E)                                   # (b, sk, E)
    ranks = torch.cumsum(onehot, dim=1) - onehot                # row-local
    idx = fl if owned is None else fl.clamp(max=E - 1)
    rank = torch.gather(ranks, 2, idx[..., None])[..., 0]
    keep = rank < C
    if owned is not None:
        keep = keep & owned
    slot = torch.where(keep, fl * C + rank, torch.full_like(fl, E * C))

    src = torch.repeat_interleave(x, k, dim=1)                  # (b, sk, d)
    bidx = torch.arange(b, device=x.device)[:, None]
    buf = torch.zeros((b, E * C + 1, d), dtype=x.dtype, device=x.device)
    buf[bidx, slot] = src              # dropped tokens land in slot E * C
    buf = buf[:, :E * C].reshape(b, E, C, d)

    out_buf = _expert_ffn(p, buf, cfg)                          # (b, E, C, d)
    flat = torch.cat([out_buf.reshape(b, E * C, d),
                      torch.zeros((b, 1, d), dtype=out_buf.dtype,
                                  device=x.device)], dim=1)
    gathered = flat[bidx, slot]                                 # (b, sk, d)
    w = (fg * keep).to(x.dtype)
    out = (gathered * w[..., None]).reshape(b, s, k, d).sum(dim=2)
    if return_aux:
        # every shard routes every token with the whole router: the aux
        # loss is the layer's on each
        return out, _aux_loss(cfg, probs, fe, b * s * k)
    return out


def _moe_global(p, x, cfg, *, return_aux, experts=None):
    b, s, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    T = b * s
    xt = x.reshape(T, d)
    logits = (xt @ p["router"]).float()                         # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1)        # (T, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    C = T if T <= 8192 else max(int(cfg.capacity_factor * T * k / E), 1)

    fe = expert_ids.reshape(T * k)
    fg = gate_vals.reshape(T * k)
    onehot = _one_hot(fe, E)                                   # (Tk, E)
    ranks = torch.cumsum(onehot, dim=0) - onehot                # global
    rank = torch.gather(ranks, 1, fe[:, None])[:, 0]
    keep = rank < C
    fl, n = fe, E                       # the ids of the experts p holds
    if experts is not None:
        # ranked over all E above; another shard's expert lands in the
        # drop slot of this shard's buffer of its `n` experts
        first, n = experts
        fl = fe - first
        keep = keep & (fl >= 0) & (fl < n)
    slot = torch.where(keep, fl * C + rank, torch.full_like(fe, n * C))

    src = torch.repeat_interleave(xt, k, dim=0)                 # (Tk, d)
    buf = torch.zeros((n * C + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = src                    # dropped tokens land in slot n * C
    buf = buf[:n * C].reshape(n, C, d)

    out_buf = _expert_ffn(p, buf, cfg)                          # (n, C, d)
    flat = torch.cat([out_buf.reshape(n * C, d),
                      torch.zeros((1, d), dtype=out_buf.dtype,
                                  device=x.device)], dim=0)
    gathered = flat[slot]                                       # (Tk, d)
    w = (fg * keep).to(x.dtype)
    out = (gathered * w[:, None]).reshape(T, k, d).sum(dim=1).reshape(
        b, s, d)
    if return_aux:
        # the whole router's probabilities and assignments: the layer's
        # aux loss on every shard
        return out, _aux_loss(cfg, probs, fe, T * k)
    return out


def _one_hot(ids, E):
    """(..., E) int64 one-hot rows of ids, by comparison: the same ops on
    every device (F.one_hot reads the ids' range on the CPU and scatters
    on the card), so that a count of the step is the device's."""
    return (ids[..., None] == torch.arange(E, device=ids.device)).long()


def _aux_loss(cfg, probs, flat_expert, denom):
    """E * sum_e (mean router probability of e) * (share of the top-k
    assignments to e) * router_aux_coef; the assignment counts carry no
    gradient."""
    E = cfg.num_experts
    me = probs.reshape(-1, E).mean(0)
    ce = torch.zeros(E, dtype=torch.float32, device=probs.device).index_add_(
        0, flat_expert.reshape(-1),
        torch.ones(flat_expert.numel(), device=probs.device)) / denom
    return E * torch.sum(me * ce) * cfg.router_aux_coef


def _eins(buf, w, eq):
    """Expert einsum for a plain or an int8 w ({"q", "s"}, s (E, out))."""
    if is_quantized(w):
        y = torch.einsum(eq, buf, w["q"].to(buf.dtype))
        return y * w["s"].to(buf.dtype)[:, None, :]
    return torch.einsum(eq, buf, w)


def _expert_ffn(p, buf, cfg):
    """SwiGLU (or, without ``activation="silu"``, w_up -> gelu with no
    gate) over buf (..., E, C, d), batched over the expert axis."""
    if cfg.activation == "silu":
        hidden = F.silu(_eins(buf, p["w_gate"], "...ecd,edf->...ecf")) \
            * _eins(buf, p["w_up"], "...ecd,edf->...ecf")
    else:
        hidden = gelu(_eins(buf, p["w_up"], "...ecd,edf->...ecf"))
    return _eins(hidden, p["w_down"], "...ecf,efd->...ecd")
