"""Mixture-of-Experts MLP of the port: top-k router and the single-device
grouped capacity dispatch (twin of repro.models.moe._moe_grouped, the path
the reference's ``moe_mlp`` takes outside a mesh).

Ranking and capacity are per batch row: row i's tokens fill each expert's
C slots in token order, a token past its expert's capacity is dropped (its
combine weight is 0), and decode-sized rows (s * k <= 64) get C = s, which
drops nothing since an expert appears at most once in a token's top-k.
The capacity therefore depends only on the row's (padded) width, so rows
are independent of their batch-mates. The expert products stay
torch.einsum, batched over the expert axis, as the reference left them to
XLA; an int8 weight ({"q", "s"}, s (E, out)) is widened and post-scaled.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import gelu
from repro_torch.models.quant import is_quantized


def moe_mlp(p, x, cfg):
    """x (b, s, d) -> (b, s, d)."""
    b, s, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    logits = (x @ p["router"]).float()                          # (b, s, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1)        # (b, s, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    C = s if s * k <= 64 else max(int(cfg.capacity_factor * s * k / E), 1)

    fe = expert_ids.reshape(b, s * k)
    fg = gate_vals.reshape(b, s * k)
    onehot = F.one_hot(fe, E)                                   # (b, sk, E)
    ranks = torch.cumsum(onehot, dim=1) - onehot                # row-local
    rank = torch.gather(ranks, 2, fe[..., None])[..., 0]
    keep = rank < C
    slot = torch.where(keep, fe * C + rank, torch.full_like(fe, E * C))

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
    return (gathered * w[..., None]).reshape(b, s, k, d).sum(dim=2)


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
