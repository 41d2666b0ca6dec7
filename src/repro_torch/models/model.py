"""Model assembly of the port for the paged serving path (twin of the
attention-only parts of repro.models.model).

Parameters keep the reference's pytree: ``embed`` (V, d), ``final_norm``,
``lm_head`` (d, V) and ``blocks/sub0`` whose leaves stack every layer on a
leading axis — the dense decoders this slice serves have a period of one
layer, so layer i is index i of each leaf (``slice_layer_params``). That
keeps a bridged JAX pytree (``repro_torch.bridge``) and a seeded torch one
interchangeable.

Paged caches are one ``{"k", "v"}`` pool pair per layer, shaped
(n_blocks, block_size, hkv, hd); block 0 is the reserved null/trash page.
Writes go into the pools in place.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers


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
# Paged caches
# ---------------------------------------------------------------------------

def init_layer_paged_cache(cfg: ModelConfig, i: int, n_blocks: int,
                           block_size: int, *, dtype, device):
    """One attention layer's page pools (block 0 = null/trash page)."""
    if cfg.layer_kind(i) != ATTN:
        raise NotImplementedError("recurrent-state layers are not ported "
                                  "yet (ROADMAP.md, slice 6)")
    shape = (n_blocks, block_size, cfg.num_kv_heads, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def scatter_rows_to_pages(pages, rows, dest_blocks):
    """Write freshly prefilled rows into a paged pool, in place.

    pages: {"k","v"} pools (n_blocks, bs, h, d); rows: {"k","v"} rows
    (m, P, h, d) of m prompts at positions [0, P); dest_blocks:
    (m * max_blocks,) int physical page of each (row, logical block) pair,
    row-major, P <= max_blocks * bs. Unallocated entries point at the null
    page: what lands there is never unmasked."""
    m, P = rows["k"].shape[:2]
    bs = pages["k"].shape[1]
    t = torch.arange(P, device=dest_blocks.device)
    blk = dest_blocks.reshape(m, -1)[:, t // bs].long()           # (m, P)
    flat = (blk * bs + t % bs).reshape(-1)
    for n in ("k", "v"):
        pool = pages[n]
        pool.view(-1, *pool.shape[2:]).index_copy_(
            0, flat, rows[n].reshape(m * P, *pool.shape[2:]).to(pool.dtype))


def copy_cache_pages(caches, src_blocks, dst_blocks):
    """Copy-on-write: duplicate page contents src -> dst in every layer's
    K/V pools, in place."""
    for c in caches:
        for n in ("k", "v"):
            c[n][dst_blocks] = c[n][src_blocks]


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


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def _embed(cfg, params, tokens):
    return params["embed"][tokens]


def _head(cfg, params, x):
    return _norm(cfg, params["final_norm"], x) @ params["lm_head"]
