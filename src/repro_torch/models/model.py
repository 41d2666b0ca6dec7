"""Model assembly of the port for the paged serving path and the draft
model's contiguous cache (twin of the attention-only parts of
repro.models.model).

Parameters keep the reference's pytree: ``embed`` (V, d), ``final_norm``,
``lm_head`` (d, V) and ``blocks/sub0`` whose leaves stack every layer on a
leading axis — the dense decoders this slice serves have a period of one
layer, so layer i is index i of each leaf (``slice_layer_params``). That
keeps a bridged JAX pytree (``repro_torch.bridge``) and a seeded torch one
interchangeable.

Paged caches are one ``{"k", "v"}`` pool pair per layer, shaped
(n_blocks, block_size, hkv, hd); block 0 is the reserved null/trash page.
An int8 / fp8 pool adds float32 ``k_scale`` / ``v_scale`` pools
(n_blocks, block_size, hkv) addressed by the same block ids
(``models.quant``).
The contiguous cache (``init_cache``, the speculative draft model's) keeps
the reference's layout: ``{"sub0": {"k", "v"}}`` with every layer stacked
on a leading axis, (L, batch, max_len, hkv, hd). Writes go into the caches
in place.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers, quant


def _check_supported(cfg: ModelConfig) -> None:
    unported = []
    if cfg.layer_pattern is not None:
        unported.append("recurrent/hybrid layers (slice 6)")
    if cfg.num_experts:
        unported.append("MoE layers (slice 6)")
    if cfg.is_encoder_decoder or cfg.num_image_tokens:
        unported.append("encoder-decoder / VLM inputs (slice 6)")
    if cfg.activation != "silu":
        unported.append(f"activation {cfg.activation!r} (slice 6)")
    if cfg.attn_bias or cfg.tie_embeddings:
        unported.append("attention bias / tied embeddings (slice 6)")
    if unported:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet: {', '.join(unported)}; see "
            "ROADMAP.md")


def param_dtype(cfg: ModelConfig, dtype=None) -> torch.dtype:
    return dtype if dtype is not None else getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda",
                dtype=None):
    """Random parameters from a torch.Generator seeded with `seed` on
    `device`: N(0, 0.02) weights (N(0, 0.02 / sqrt(2 L)) for the residual
    outputs wo and w_down) and unit norms, in the reference's layout. Each
    leaf is drawn in place at its own dtype, so a full-width model needs no
    float32 copy. The same seed gives the same weights on the same kind of
    device (CPU and CUDA generators draw different streams)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    generator = torch.Generator(device=dev).manual_seed(seed)
    dt = param_dtype(cfg, dtype)
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim_
    hq, hkv, L = cfg.num_heads, cfg.num_kv_heads, cfg.num_layers
    out_scale = 0.02 / math.sqrt(2 * L)

    def rand(shape, scale=0.02):
        return torch.empty(shape, dtype=dt, device=dev).normal_(
            0.0, scale, generator=generator)

    def ones(shape):
        return torch.ones(shape, dtype=dt, device=dev)

    sub = {
        "ln1": {"w": ones((L, d))},
        "mixer": {"wq": rand((L, d, hq * hd)), "wk": rand((L, d, hkv * hd)),
                  "wv": rand((L, d, hkv * hd)),
                  "wo": rand((L, hq * hd, d), out_scale)},
        "ln2": {"w": ones((L, d))},
        "mlp": {"w_gate": rand((L, d, f)), "w_up": rand((L, d, f)),
                "w_down": rand((L, f, d), out_scale)},
    }
    return {"embed": rand((cfg.vocab_size, d)),
            "final_norm": {"w": ones((d,))},
            "blocks": {"sub0": sub},
            "lm_head": rand((d, cfg.vocab_size))}


def slice_layer_params(cfg: ModelConfig, params, i: int):
    """Params of global layer i (views, leading layer axis removed)."""
    def take(tree):
        return {k: take(v) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}
    return take(params["blocks"]["sub0"])


# ---------------------------------------------------------------------------
# Contiguous cache (the draft model's)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, dtype=None,
               device="cuda"):
    """Zeroed contiguous cache {"sub0": {"k", "v"}}, each
    (L, batch, max_len, hkv, hd)."""
    _check_supported(cfg)
    if cfg.swa_window:
        raise NotImplementedError("the sliding-window ring cache is not "
                                  "ported yet (ROADMAP.md, slice 5)")
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim_)
    dt = param_dtype(cfg, dtype)
    dev = resolve_device(device)
    return {"sub0": {"k": torch.zeros(shape, dtype=dt, device=dev),
                     "v": torch.zeros(shape, dtype=dt, device=dev)}}


def scatter_cache_rows(cache, rows, slot_ids):
    """Write `rows` (an init_cache tree whose batch is len(slot_ids)) into
    `cache` at those batch rows, in place; the rows may be shorter than
    the cache and fill its leading positions. Returns cache."""
    for n, t in cache["sub0"].items():
        src = rows["sub0"][n]
        idx = torch.as_tensor(list(slot_ids), device=t.device).long()
        t.narrow(2, 0, src.shape[2]).index_copy_(1, idx, src.to(t.dtype))
    return cache


# ---------------------------------------------------------------------------
# Paged caches
# ---------------------------------------------------------------------------

def pool_dtype(kv_dtype, dtype: torch.dtype) -> torch.dtype:
    """Storage dtype of a page pool for `kv_dtype` (None: the model's
    `dtype`). An unquantized kv_dtype must name the model's own width: the
    kernels take q and K/V of one dtype (other widths: ROADMAP.md)."""
    if kv_dtype is None:
        return dtype
    st = quant.kv_storage_dtype(kv_dtype)
    if not quant.kv_is_quantized(kv_dtype) and st != dtype:
        raise NotImplementedError(
            f"kv_dtype={kv_dtype!r} under a {dtype} model: unquantized pools "
            "of another width than the model's are not ported yet "
            "(ROADMAP.md)")
    return st


def init_layer_paged_cache(cfg: ModelConfig, i: int, n_blocks: int,
                           block_size: int, *, dtype, device, kv_dtype=None,
                           kv_guard_layers=()):
    """One attention layer's page pools (block 0 = null/trash page).
    `kv_dtype` ("int8" / "fp8") stores int8 / fp8 payloads with zeroed
    float32 scale pools; a layer whose global index i is in
    `kv_guard_layers` keeps the model's `dtype` whatever kv_dtype says."""
    if cfg.layer_kind(i) != ATTN:
        raise NotImplementedError("recurrent-state layers are not ported "
                                  "yet (ROADMAP.md, slice 6)")
    if i in kv_guard_layers:
        kv_dtype = None
    shape = (n_blocks, block_size, cfg.num_kv_heads, cfg.head_dim_)
    st = pool_dtype(kv_dtype, dtype)
    c = {"k": torch.zeros(shape, dtype=st, device=device),
         "v": torch.zeros(shape, dtype=st, device=device)}
    if kv_dtype is not None and quant.kv_is_quantized(kv_dtype):
        for n in quant.KV_SCALE_LEAVES:
            c[n] = torch.zeros(shape[:3], dtype=torch.float32, device=device)
    return c


def scatter_rows_to_pages(pages, rows, dest_blocks):
    """Write freshly prefilled rows into a paged pool, in place.

    pages: {"k","v"} pools (n_blocks, bs, h, d); rows: {"k","v"} rows
    (m, P, h, d) of m prompts at positions [0, P); dest_blocks:
    (m * max_blocks,) int physical page of each (row, logical block) pair,
    row-major, P <= max_blocks * bs. Unallocated entries point at the null
    page: what lands there is never unmasked. A quantized pool (one with
    ``k_scale``) quantizes the rows on write and scatters payload and
    scales through the same rows."""
    m, P = rows["k"].shape[:2]
    bs = pages["k"].shape[1]
    t = torch.arange(P, device=dest_blocks.device)
    blk = dest_blocks.reshape(m, -1)[:, t // bs].long()           # (m, P)
    flat = (blk * bs + t % bs).reshape(-1)
    quantized = "k_scale" in pages
    kvd = quant.kv_dtype_name(pages["k"].dtype) if quantized else None
    for n in ("k", "v"):
        pool, src = pages[n], rows[n].reshape(m * P, *pages[n].shape[2:])
        if quantized:
            src, scale = quant.quantize_kv_rows(src, kvd)
            pages[n + "_scale"].view(-1, pool.shape[2]).index_copy_(
                0, flat, scale)
        quant.bits(pool).view(-1, *pool.shape[2:]).index_copy_(
            0, flat, quant.bits(src.to(pool.dtype)))


def copy_cache_pages(caches, src_blocks, dst_blocks):
    """Copy-on-write: duplicate page contents src -> dst in every layer's
    K/V pools, and their scale pools where quantized, in place."""
    for c in caches:
        for n in ("k", "v") + quant.KV_SCALE_LEAVES:
            if n in c:
                quant.bits(c[n])[dst_blocks] = quant.bits(c[n])[src_blocks]


# ---------------------------------------------------------------------------
# Stack application (one attention block: norm, attention, norm, MLP)
# ---------------------------------------------------------------------------

def _norm(cfg, p, x):
    return layers.rms_norm(x, p["w"], cfg.norm_eps)


def _mlp(cfg, sp, x):
    return x + layers.mlp(sp["mlp"], _norm(cfg, sp["ln2"], x), cfg)


def _attn_only(kind):
    if kind != ATTN:
        raise NotImplementedError("recurrent-state layers are not ported "
                                  "yet (ROADMAP.md, slice 6)")


def apply_sublayer_seq(cfg, kind, sp, x, sc, *, positions, dest_blocks):
    """One block over whole prompts x (m, P, d); its K/V rows go straight
    into the layer's pages `sc` through dest_blocks (m * max_blocks,).
    Returns x."""
    _attn_only(kind)
    o, k, v = layers.attn_prefill(sp["mixer"], _norm(cfg, sp["ln1"], x),
                                  cfg, positions=positions)
    scatter_rows_to_pages(sc, {"k": k, "v": v}, dest_blocks)
    return _mlp(cfg, sp, x + o)


def apply_sublayer_decode_paged(cfg, kind, sp, x, sc, *, pos, block_tables):
    """One block for a single decode token per row against paged `sc`."""
    _attn_only(kind)
    o = layers.attn_decode_paged(sp["mixer"], _norm(cfg, sp["ln1"], x), cfg,
                                 pos=pos, block_tables=block_tables,
                                 cache=sc)
    return _mlp(cfg, sp, x + o)


def apply_sublayer_context_paged(cfg, kind, sp, x, sc, *, positions, q_len,
                                 block_tables):
    """One block over a chunk of new tokens against paged `sc`."""
    _attn_only(kind)
    o = layers.attn_context_paged(sp["mixer"], _norm(cfg, sp["ln1"], x),
                                  cfg, positions=positions, q_len=q_len,
                                  block_tables=block_tables, cache=sc)
    return _mlp(cfg, sp, x + o)


def apply_sublayer_verify_paged(cfg, kind, sp, x, sc, *, positions, q_len,
                                block_tables):
    """One block over each slot's candidate chunk against paged `sc`
    (speculative verification; attention-only: a recurrent state cannot
    roll back past a rejected candidate)."""
    _attn_only(kind)
    o = layers.attn_verify_paged(sp["mixer"], _norm(cfg, sp["ln1"], x), cfg,
                                 positions=positions, q_len=q_len,
                                 block_tables=block_tables, cache=sc)
    return _mlp(cfg, sp, x + o)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def _embed(cfg, params, tokens):
    return params["embed"][tokens]


def _head(cfg, params, x):
    return quant.mm(_norm(cfg, params["final_norm"], x), params["lm_head"])


# ---------------------------------------------------------------------------
# Whole-model entry points
# ---------------------------------------------------------------------------

def prefill(cfg: ModelConfig, params, batch, cache, *, lens=None):
    """Prompt pass over right-padded rows batch["tokens"] (b, s), writing
    every layer's K/V into cache positions [0, s) in place. lens (b,): row
    i's prompt is [0, lens[i]) and its logits come from its own last real
    token (None: the last column). Returns (logits (b, V), cache)."""
    tokens = torch.as_tensor(batch["tokens"], device=params["embed"].device)
    b, s = tokens.shape
    x = _embed(cfg, params, tokens.long())
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    for i in range(cfg.num_layers):
        _attn_only(cfg.layer_kind(i))
        sp = slice_layer_params(cfg, params, i)
        o, k, v = layers.attn_prefill(sp["mixer"], _norm(cfg, sp["ln1"], x),
                                      cfg, positions=positions)
        for n, t in (("k", k), ("v", v)):
            cache["sub0"][n][i, :, :s] = t.to(cache["sub0"][n].dtype)
        x = _mlp(cfg, sp, x + o)
    if lens is not None:
        last = torch.as_tensor(lens, device=x.device).long() - 1
        x = x[torch.arange(b, device=x.device), last][:, None]
    else:
        x = x[:, -1:]
    return _head(cfg, params, x)[:, 0], cache


def decode_step(cfg: ModelConfig, params, tokens, cache, pos, *,
                kv_start=None):
    """One decode step against the contiguous cache, in place. tokens (b,);
    pos a scalar or (b,) per-row absolute positions. Returns
    (logits (b, V), cache)."""
    tokens = torch.as_tensor(tokens, device=params["embed"].device).long()
    x = _embed(cfg, params, tokens[:, None])
    pos = torch.as_tensor(pos, device=x.device)
    for i in range(cfg.num_layers):
        _attn_only(cfg.layer_kind(i))
        sp = slice_layer_params(cfg, params, i)
        c = {n: cache["sub0"][n][i] for n in ("k", "v")}
        o = layers.attn_decode(sp["mixer"], _norm(cfg, sp["ln1"], x), cfg,
                               pos=pos, cache=c, kv_start=kv_start)
        x = _mlp(cfg, sp, x + o)
    return _head(cfg, params, x)[:, 0], cache


def verify_step_paged(cfg: ModelConfig, params, tokens, caches, kv_start,
                      q_len, block_tables):
    """Speculative verification of each row's candidate chunk tokens
    (b, T), row i's candidate j at absolute position kv_start[i] + j,
    against per-layer page pools `caches` (one {"k","v"} per layer, written
    in place) through block_tables (b, max_blocks). q_len (b,) real
    candidate counts (0 = a dead row). Returns (logits (b, T, V) at every
    position, caches)."""
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, device=dev).long()
    starts = torch.as_tensor(kv_start, device=dev).long()
    lens = torch.as_tensor(q_len, device=dev).long()
    tbl = torch.as_tensor(block_tables, device=dev).to(torch.int32)
    x = _embed(cfg, params, tokens)
    positions = starts[:, None] + torch.arange(tokens.shape[1], device=dev)
    for i, sc in enumerate(caches):
        x = apply_sublayer_verify_paged(
            cfg, cfg.layer_kind(i), slice_layer_params(cfg, params, i), x,
            sc, positions=positions, q_len=lens, block_tables=tbl)
    return _head(cfg, params, x), caches
