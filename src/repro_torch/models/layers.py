"""Layer primitives of the port (twins of repro.models.layers): RMSNorm
and LayerNorm, RoPE and sinusoidal positions, the GQA attention blocks
(with an optional q/k/v bias) of the paged serving path and of the
contiguous caches (full, or the sliding-window ring), whisper's
bidirectional encoder attention and cross-attention, and the MLP (SwiGLU,
or gelu without a gate).

Parameters are plain dicts of tensors in the reference's (in, out) layout,
so every weight product is ``x @ w``, through ``quant.mm`` so that an
int8 weight ({"q", "s"}) takes a plain weight's place. Large products stay
torch.matmul, as the reference left them to XLA; attention goes through
``repro_torch.kernels.ops``. Paged K/V pools are updated in place where the
reference donated its buffers to jit; a quantized pool (one carrying
``k_scale`` / ``v_scale``) quantizes the new rows on write and hands its
scale pools to the attention entry.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.quant import (bits, kv_dtype_name, mm,
                                      quantize_kv_rows)


def rms_norm(x, w, eps=1e-5):
    """Normalize in float32, cast back to x's dtype, then scale by w."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def layer_norm(x, w, b, eps=1e-5):
    """LayerNorm with bias (whisper): normalize in float32, cast back to
    x's dtype, then scale by w and shift by b."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def sinusoidal_positions(positions, d):
    """Whisper-style sinusoidal embeddings: positions (b, s) -> (b, s, d)
    float32, sines then cosines of position x 10000^(-i / (d/2 - 1))."""
    half = d // 2
    log_base = torch.log(torch.tensor(10000.0, dtype=torch.float32))
    freqs = torch.exp(-log_base * torch.arange(
        half, dtype=torch.float32, device=positions.device) / (half - 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def rope(x, positions, theta):
    """Split-half rotary embedding. x (b, s, h, d); positions (b, s) or
    (s,) absolute positions; theta == 0 disables."""
    if theta == 0.0:
        return x
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs              # (b, s, d/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# the bias that may follow an output product (no architecture of the
# registry has one): a tensor-parallel stage adds it once, to its shards'
# sum (``models.model._sharded``)
ROW_BIAS = {"wo": "bo", "w_down": "b_down"}


def _out(p, o, w):
    """The output product o @ p[w] (wo or w_down), plus its bias where `p`
    has one."""
    y = mm(o, p[w])
    b = p.get(ROW_BIAS[w])
    return y if b is None else y + b


def _qkv(p, x, cfg):
    """The projections of every attention path (prefill, contiguous and
    paged decode, context, verify), plus the q/k/v bias of an
    ``attn_bias`` model (codeqwen1.5-7b)."""
    b, s, _ = x.shape
    hd = cfg.head_dim_
    q, k, v = mm(x, p["wq"]), mm(x, p["wk"]), mm(x, p["wv"])
    if cfg.attn_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(b, s, cfg.num_heads, hd),
            k.reshape(b, s, cfg.num_kv_heads, hd),
            v.reshape(b, s, cfg.num_kv_heads, hd))


def attn_prefill(p, x, cfg, *, positions, kv_start=None, window=None):
    """Causal self-attention over whole prompts x (b, s, d) at absolute
    positions (b, s): right-padded (slot insertion), or left-padded with
    kv_start (b,) the first real index of each row (static batching), whose
    pad keys are masked. `window` (None: the config's sliding window, 0:
    none) limits each query to the previous `window` keys. Returns
    (out, k, v): the roped K/V rows are the caller's to write into its
    cache (``write_cache`` for a contiguous one; the paged path scatters
    them straight into pages)."""
    window = cfg.swa_window if window is None else window
    q, k, v = _qkv(p, x, cfg)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = ops.flash_attention(q, k, v, causal=True, window=window,
                            kv_start=kv_start)
    b, s = x.shape[:2]
    return _out(p, o.reshape(b, s, -1), "wo"), k, v


def _is_ring(cache, window):
    return bool(window) and cache["k"].shape[1] <= window


def write_cache(cache, k, v, *, window=0):
    """Write a prefill's K/V rows k, v (b, s, hkv, hd) into a contiguous
    cache {"k","v"} (b, S, hkv, hd), in place. A sliding-window ring
    (window > 0 and S <= window) keeps the last S keys, position p at slot
    p % S (so a decode write at pos % S evicts exactly the oldest key), and
    zeros past s when s < S; a full cache takes them at [0, s)."""
    S, s = cache["k"].shape[1], k.shape[1]
    for n, t in (("k", k), ("v", v)):
        t = t.to(cache[n].dtype)
        if _is_ring(cache, window):
            if s >= S:
                cache[n].copy_(torch.roll(t[:, -S:], s % S, dims=1))
            else:
                cache[n][:, :s] = t
                cache[n][:, s:] = 0
        else:
            cache[n][:, :s] = t


def attn_decode(p, x, cfg, *, pos, cache, kv_start=None, window=None):
    """One-token decode against a contiguous cache {"k","v"} (b, S, hkv,
    hd), in place. x (b, 1, d); pos a scalar (a uniform batch: the static
    engine) or (b,) per-row absolute positions (slot mode).

    Full cache: the new token's K/V go to position pos, then it attends to
    [0, pos + 1) minus the kv_start (b,) padding. Ring (sliding window,
    ``write_cache``): the write goes to slot pos % S and the token attends
    to the min(pos + 1, S) filled slots. As in the reference, the ring
    passes no kv_start, so a left-padded row attends to its pad keys until
    the ring overwrites them (ROADMAP.md F5)."""
    window = cfg.swa_window if window is None else window
    q, k, v = _qkv(p, x, cfg)
    b = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device).long().expand(b)
    posb = pos[:, None]
    q = rope(q, posb, cfg.rope_theta)
    k = rope(k, posb, cfg.rope_theta)
    ridx = torch.arange(b, device=x.device)
    if _is_ring(cache, window):
        S = cache["k"].shape[1]
        slot, kv_len, kv_start = pos % S, (pos + 1).clamp(max=S), None
    else:
        slot, kv_len = pos, pos + 1
    cache["k"][ridx, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][ridx, slot] = v[:, 0].to(cache["v"].dtype)
    o = ops.decode_attention(q, cache["k"], cache["v"], kv_len=kv_len,
                             kv_start=kv_start)
    return _out(p, o.reshape(b, 1, -1), "wo")


def write_pages(cache, blk, off, k, v):
    """Write K/V rows k, v (..., hkv, hd) at pages blk, offsets off (same
    leading shape) of `cache`, in place: cast to the pool dtype, or, for a
    quantized pool, quantized (payload and scales at the same (blk, off)).
    Returns the scale kwargs of the ops call ({} for a plain pool)."""
    if "k_scale" not in cache:
        cache["k"][blk, off] = k.to(cache["k"].dtype)
        cache["v"][blk, off] = v.to(cache["v"].dtype)
        return {}
    kvd = kv_dtype_name(cache["k"].dtype)
    for n, rows in (("k", k), ("v", v)):
        payload, scale = quantize_kv_rows(rows, kvd)
        bits(cache[n])[blk, off] = bits(payload)
        cache[n + "_scale"][blk, off] = scale
    return {"k_scale": cache["k_scale"], "v_scale": cache["v_scale"]}


def attn_decode_paged(p, x, cfg, *, pos, block_tables, cache):
    """One-token decode against a block-paged cache. x (b, 1, d); pos (b,)
    per-row absolute positions; block_tables (b, max_blocks) int32; cache
    {"k","v"}: (n_blocks, block_size, hkv, hd) pools shared by every row.
    The new token's K/V go into the page holding position pos (in place;
    quantized on write for an int8 / fp8 pool, so the token reads its own
    K/V back quantized, as in the reference), then attention reads through
    the tables. Rows with all-null tables (free slots) write into the
    trash page and read garbage that the caller discards."""
    q, k, v = _qkv(p, x, cfg)
    b = x.shape[0]
    posb = pos[:, None]
    q = rope(q, posb, cfg.rope_theta)
    k = rope(k, posb, cfg.rope_theta)
    bs = cache["k"].shape[1]
    ridx = torch.arange(b, device=x.device)
    blk = block_tables[ridx, pos // bs].long()
    off = pos % bs
    sc = write_pages(cache, blk, off, k[:, 0], v[:, 0])
    o = ops.paged_decode_attention(q, cache["k"], cache["v"], block_tables,
                                   kv_len=pos + 1, **sc)
    return _out(p, o.reshape(b, 1, -1), "wo")


def _chunk_qkv_to_pages(p, x, cfg, positions, q_len, block_tables, cache):
    """Q, K, V of a chunk x (b, C, d) at absolute positions (b, C); the
    roped K/V go into the pages in place (tokens j >= q_len[i] clamp their
    position into the table and write the null page). Returns roped q and
    the scale kwargs of the ops call (``write_pages``)."""
    q, k, v = _qkv(p, x, cfg)
    C = x.shape[1]
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    bs = cache["k"].shape[1]
    max_pos = block_tables.shape[1] * bs - 1
    valid = torch.arange(C, device=x.device)[None, :] < q_len[:, None]
    posc = positions.clamp(max=max_pos)                 # pad rows stay legal
    blk = torch.gather(block_tables, 1, posc // bs).long()
    blk = torch.where(valid, blk, torch.zeros_like(blk))   # pads -> null page
    off = posc % bs
    return q, write_pages(cache, blk, off, k, v)


def attn_context_paged(p, x, cfg, *, positions, q_len, block_tables, cache):
    """Context prefill against a block-paged cache: x (b, C, d) is a chunk
    whose row-i token j sits at absolute position positions[i, 0] + j. The
    chunk's K/V go into the pages first (in place), then the chunk attends
    causally to the prior pages and itself. Padding tokens (j >= q_len[i])
    clamp their position into the table and write into the null page;
    their outputs are garbage the caller discards."""
    q, sc = _chunk_qkv_to_pages(p, x, cfg, positions, q_len, block_tables,
                                cache)
    b, C = x.shape[:2]
    o = ops.paged_context_attention(q, cache["k"], cache["v"], block_tables,
                                    q_start=positions[:, 0],
                                    kv_len=positions[:, 0] + q_len, **sc)
    return _out(p, o.reshape(b, C, -1), "wo")


def attn_verify_paged(p, x, cfg, *, positions, q_len, block_tables, cache):
    """Speculative verification against a block-paged cache: x (b, T, d)
    is each slot's candidate chunk (the bonus token plus its drafts), row
    i's candidate j at absolute position positions[i, 0] + j, the slot's
    committed length. The chunk's K/V go into the pages first (in place),
    then every candidate attends to the committed pages and the candidate
    prefix; the caller keeps the output at every position. Padding
    candidates (j >= q_len[i]) write into the null page; rows with
    q_len == 0 come back dead. Rejected candidates' writes sit past the
    committed length and are the caller's to roll back."""
    q, sc = _chunk_qkv_to_pages(p, x, cfg, positions, q_len, block_tables,
                                cache)
    b, T = x.shape[:2]
    o = ops.paged_verify_attention(q, cache["k"], cache["v"], block_tables,
                                   kv_start=positions[:, 0],
                                   kv_len=positions[:, 0] + q_len, **sc)
    return _out(p, o.reshape(b, T, -1), "wo")


def cross_attn(p, x, cfg, *, enc_kv=None, enc_out=None):
    """Whisper's cross-attention of decoder rows x (b, s, d) to the encoder:
    enc_kv {"k", "v"} (b, se, hkv, hd), the K/V cached at prefill, or, when
    None, computed from the encoder output enc_out (b, se, d). Non-causal
    flash attention (#1) with sq = s against skv = se keys: a prompt at
    prefill, one row at every decode step. No bias, no positions. Returns
    (out, enc_kv)."""
    b, s, _ = x.shape
    hd = cfg.head_dim_
    q = mm(x, p["wq"]).reshape(b, s, cfg.num_heads, hd)
    if enc_kv is None:
        se = enc_out.shape[1]
        enc_kv = {"k": mm(enc_out, p["wk"]).reshape(b, se, cfg.num_kv_heads,
                                                    hd),
                  "v": mm(enc_out, p["wv"]).reshape(b, se, cfg.num_kv_heads,
                                                    hd)}
    o = ops.flash_attention(q, enc_kv["k"].to(q.dtype),
                            enc_kv["v"].to(q.dtype), causal=False)
    return _out(p, o.reshape(b, s, -1), "wo"), enc_kv


def attn_encoder(p, x, cfg):
    """Bidirectional self-attention of whisper's encoder over x (b, se, d):
    non-causal flash attention (#1) with sq = skv, no positions (the
    encoder adds sinusoidal ones to its input)."""
    q, k, v = _qkv(p, x, cfg)
    o = ops.flash_attention(q, k, v, causal=False)
    b, s = x.shape[:2]
    return _out(p, o.reshape(b, s, -1), "wo")


def gelu(x):
    """jax.nn.gelu's default, the tanh approximation (torch's default is
    the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def mlp(p, x, cfg):
    """SwiGLU MLP (``activation="silu"``), else w_up -> gelu -> w_down
    with no gate (granite-20b's gpt-bigcode MLP)."""
    if cfg.activation == "silu":
        return _out(p, F.silu(mm(x, p["w_gate"])) * mm(x, p["w_up"]),
                    "w_down")
    return _out(p, gelu(mm(x, p["w_up"])), "w_down")
