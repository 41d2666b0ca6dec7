"""Mamba (S6) selective-SSM block of the port, Jamba-style (twin of
repro.models.mamba).

Prefill runs the selective scan through ``kernels.ops.ssm_scan`` (the
hand-written CUDA kernel on the card); decode is one recurrent step in
plain torch (``ref.ssm_step``), as the reference leaves it to jnp. The
per-slot cache is {"conv": (b, w-1, din) the last w-1 conv inputs,
"h": (b, din, ds) float32 state}.

``A_log``, ``D`` and ``dt_bias`` are float32 leaves whatever the model
dtype (``FP32_LEAVES``): the bridge and the pipeline stages never cast them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.models.quant import mm

FP32_LEAVES = ("A_log", "D", "dt_bias")


def _dt_rank(cfg):
    return cfg.ssm_dt_rank or -(-cfg.d_model // 16)


def d_inner(cfg, p=None):
    """The layer's inner width: of its mixer params `p` where given (a
    tensor-parallel shard holds a slice of din), else the config's."""
    if p is not None:
        return p["D"].shape[-1]
    return cfg.ssm_expand * cfg.d_model


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0); F.softplus returns x itself above
    # its threshold, which differs in the last bits
    return torch.logaddexp(x, torch.zeros_like(x))


def _project(p, x):
    """x (b, s, d) -> the conv input xi and the gate z, each (b, s, din)."""
    return mm(x, p["in_proj"]).chunk(2, dim=-1)


def _ssm_inputs(p, dbc, cfg, valid=None):
    """dt, A, B, C from dbc = xc @ x_proj (b, s, dtr + 2 ds), the whole
    layer's (a TP stage sums its shards' first)."""
    dtr, ds = _dt_rank(cfg), cfg.ssm_d_state
    dt_raw = dbc[..., :dtr]
    B = dbc[..., dtr:dtr + ds]
    C = dbc[..., dtr + ds:]
    # the float32 dt_bias promotes dt to float32, as in the reference
    dt = _softplus(mm(dt_raw, p["dt_proj"]) + p["dt_bias"])
    if valid is not None:
        dt = dt * valid[..., None].to(dt.dtype)          # pad steps: identity
    A = -torch.exp(p["A_log"].float())
    return dt, A, B, C


# A layer runs in two halves, so that a tensor-parallel stage (shards that
# each hold a slice of din: ``models.model``) can sum its shards' x_proj
# products between them: ``*_in`` up to dbc = xc @ x_proj, a partial sum
# on a shard (x_proj is row-parallel), ``*_out`` from the whole dbc
# through dt_proj, the scan and out_proj (a partial sum again).

def prefill_in(p, x, cfg, *, valid=None):
    """The first half of ``mamba_prefill``: {"xpad", "xc", "z", "dbc"}."""
    xi, z = _project(p, x)
    if valid is not None:
        xi = xi * valid[..., None].to(xi.dtype)
    w = cfg.ssm_d_conv
    xpad = F.pad(xi, (0, 0, w - 1, 0))                   # causal left pad
    xc = F.silu(_depthwise_conv(xpad, p["conv_w"], p["conv_b"]))
    return {"xpad": xpad, "xc": xc, "z": z, "dbc": mm(xc, p["x_proj"])}


def prefill_out(p, st, dbc, cfg, *, valid=None, lens=None, cache=None):
    """The second half of ``mamba_prefill`` from ``prefill_in``'s `st` and
    the whole dbc."""
    xpad, xc = st["xpad"], st["xc"]
    dt, A, B, C = _ssm_inputs(p, dbc, cfg, valid=valid)
    y, h = ops.ssm_scan(xc, dt, A, B, C, p["D"])
    out = mm(y * F.silu(st["z"]), p["out_proj"])
    if cache is None:
        return out, None
    w = cfg.ssm_d_conv
    if w <= 1:
        tail = xpad[:, :0]
    elif lens is not None:
        # row i's real inputs sit at xpad[w-1 + j], j < lens[i]: the tail
        # [lens[i], lens[i] + w-1) holds its last real inputs (and the
        # conv's leading zeros when lens[i] < w-1)
        lens = torch.as_tensor(lens, device=xpad.device).long()
        idx = lens[:, None] + torch.arange(w - 1, device=xpad.device)
        tail = torch.gather(xpad, 1, idx[..., None].expand(
            -1, -1, xpad.shape[2]))
    else:
        tail = xpad[:, -(w - 1):]
    return out, {"conv": tail.to(cache["conv"].dtype),
                 "h": h.to(cache["h"].dtype)}


def mamba_prefill(p, x, cfg, *, valid=None, lens=None, cache=None):
    """x (b, s, d); valid (b, s) 0/1 marks real steps (pads become identity
    state updates); lens (b,) marks right padding, so that the conv tail is
    each row's last w-1 real inputs. Returns (out, new_cache) with
    new_cache {"conv", "h"} in `cache`'s dtypes, or None without a cache."""
    st = prefill_in(p, x, cfg, valid=valid)
    return prefill_out(p, st, st["dbc"], cfg, valid=valid, lens=lens,
                       cache=cache)


def decode_in(p, x, cfg, *, cache):
    """The first half of ``mamba_decode``: {"hist", "xc", "z", "dbc"}."""
    xi, z = _project(p, x)                               # (b, 1, din)
    hist = torch.cat([cache["conv"].to(xi.dtype), xi], dim=1)   # (b, w, din)
    xc = torch.einsum("bwd,dw->bd", hist, p["conv_w"]) + p["conv_b"]
    xc = F.silu(xc)[:, None, :]
    return {"hist": hist, "xc": xc, "z": z, "dbc": mm(xc, p["x_proj"])}


def decode_out(p, st, dbc, cfg, *, cache):
    """The second half of ``mamba_decode`` from ``decode_in``'s `st` and
    the whole dbc."""
    xc = st["xc"]
    dt, A, B, C = _ssm_inputs(p, dbc, cfg)
    y, h = ref.ssm_step(xc[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], p["D"],
                        cache["h"].float())
    out = mm(y[:, None, :] * F.silu(st["z"]), p["out_proj"])
    return out, {"conv": st["hist"][:, 1:].to(cache["conv"].dtype),
                 "h": h.to(cache["h"].dtype)}


def mamba_decode(p, x, cfg, *, cache):
    """x (b, 1, d); cache {"conv": (b, w-1, din), "h": (b, din, ds)}.
    Returns (out, new_cache)."""
    st = decode_in(p, x, cfg, cache=cache)
    return decode_out(p, st, st["dbc"], cfg, cache=cache)


def _depthwise_conv(xpad, kern, bias):
    """xpad (b, s+w-1, din); kern (din, w) -> (b, s, din) causal, the taps
    summed in the reference's order so that float32 sums round alike."""
    w = kern.shape[-1]
    s = xpad.shape[1] - (w - 1)
    out = torch.zeros((xpad.shape[0], s, xpad.shape[2]), dtype=xpad.dtype,
                      device=xpad.device)
    for i in range(w):
        out = out + xpad[:, i:i + s] * kern[:, i][None, None, :]
    return out + bias[None, None, :]
