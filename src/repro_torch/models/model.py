"""Model assembly of the port for the paged serving path and the
contiguous cache (twin of repro.models.model for the dense decoders, MoE,
the hybrid Mamba + attention stacks, the attention-free xLSTM stacks,
whisper's encoder-decoder and paligemma's image-prefixed decoder).

Layers are organized into *periods*, as in the reference: the layer
pattern of a hybrid model (Jamba's seven Mamba layers and one attention
layer, MoE on every other layer) repeats with period ``period_len(cfg)``.
Parameters keep the reference's pytree: ``embed`` (V, d), ``final_norm``,
``lm_head`` (d, V; absent under tied embeddings, where the head is
``x @ embed.T``) and ``blocks/sub{j}`` for each position j of a period,
whose leaves stack the ``n_periods`` layers at that position on a leading
axis. An encoder-decoder (whisper) has LayerNorms with a bias ``b``, a
cross-attention ``xattn`` behind its norm ``lnx`` in every decoder layer,
and ``encoder`` {``blocks/sub0`` (its layers stacked), ``final_norm``}.
A dense decoder has a period of one layer, so ``sub0`` leaf index i is
layer i. ``slice_layer_params`` takes global layer i's views. That keeps
a bridged JAX pytree (``repro_torch.bridge``) and a seeded torch one
interchangeable.

Paged caches are one dict per layer: an attention layer's ``{"k", "v"}``
pools, shaped (n_blocks, block_size, hkv, hd), with block 0 the reserved
null/trash page (an int8 / fp8 pool adds float32 ``k_scale`` / ``v_scale``
pools (n_blocks, block_size, hkv) addressed by the same block ids,
``models.quant``); a recurrent layer's per-slot state, whose rows are the
slots (nothing to page): Mamba's ``{"conv": (n_slots, w-1, din), "h":
(n_slots, din, ds) float32}``, mLSTM's ``{"C": (n_slots, h, qk_h, v_h),
"n": (n_slots, h, qk_h)}`` and sLSTM's ``{"c", "n", "m", "h": (n_slots,
d)}``, these two all float32 (``_slot_state``). The contiguous cache
(``init_cache``: the speculative draft model's, and the reference-shaped
prefill / decode)
keeps the reference's layout: ``{"sub{j}": ...}`` with each period
position's leaves stacked on a leading axis, attention rows
(P, batch, S, hkv, hd), S = max_len or, for a sliding-window model, the
min(max_len, window)-slot ring, and an encoder-decoder's cross K/V
``cross_k`` / ``cross_v`` (P, batch, encoder_seq_len, hkv, hd), written
once at prefill; the pipeline's contiguous caches are one layer's leaves
each (``init_layer_cache``). Writes go into the caches in place.

Training (``train_forward``, ``loss_fn``) runs whole sequences with no
cache, the reference's mode="train"; attention and the Mamba scan
differentiate through their backward kernels (``kernels.ops``).

Modality inputs are stubs, as in the reference: whisper's batch carries
frame embeddings ``enc_frames`` (b, encoder_seq_len, d) for the encoder,
paligemma's patch embeddings ``image_embeds`` (b, num_image_tokens, d),
which prefix the prompt's embeddings; both are cast to the model's dtype
(the reference runs a float32 ``enc_frames`` through a bf16 model's
encoder in float32; in fp32 the two agree).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ATTN, MAMBA, MLSTM, SLSTM, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers, mamba, moe, quant, xlstm


def param_dtype(cfg: ModelConfig, dtype=None) -> torch.dtype:
    return dtype if dtype is not None else getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# Period structure
# ---------------------------------------------------------------------------

def period_len(cfg: ModelConfig) -> int:
    p = len(cfg.layer_pattern) if cfg.layer_pattern else 1
    m = cfg.moe_every if cfg.num_experts else 1
    return math.lcm(p, m)


def n_periods(cfg: ModelConfig) -> int:
    pl = period_len(cfg)
    if cfg.num_layers % pl:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not a "
                         f"whole number of {pl}-layer periods")
    return cfg.num_layers // pl


def sub_kinds(cfg: ModelConfig):
    """(kind, is_moe) of each position within one period."""
    return [(cfg.layer_kind(j), cfg.is_moe_layer(j))
            for j in range(period_len(cfg))]


def layer_sub_index(cfg: ModelConfig, i: int):
    """Global layer i -> (period index, position within the period)."""
    pl = period_len(cfg)
    return i // pl, i % pl


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda",
                dtype=None):
    """Random parameters from a torch.Generator seeded with `seed` on
    `device`, in the reference's layout: N(0, 0.02) weights
    (N(0, 0.02 / sqrt(2 L)) for the residual outputs wo, w_down, out_proj),
    unit norms, the reference's Mamba dynamics (A_log = log(1..ds),
    D = 1 and dt_bias the inverse softplus of a log-uniform dt in
    [1e-3, 0.1], all three float32 whatever the model dtype) and sLSTM
    gate biases (0, and 1 for the forget gate). The q/k/v biases of an
    ``attn_bias`` model are drawn N(0, 0.02) where the reference's are
    zeros, so that a served seeded model exercises them. An
    encoder-decoder's LayerNorms get zero biases and its cross-attention
    and encoder the attention and MLP draws; tied embeddings leave out
    ``lm_head``. Each leaf is
    drawn in place at its own dtype, so a full-width model needs no float32
    copy. The same seed gives the same weights on the same kind of device
    (CPU and CUDA generators draw different streams)."""
    dev = resolve_device(device)
    generator = torch.Generator(device=dev).manual_seed(seed)
    dt = param_dtype(cfg, dtype)
    d, f, hd, V = cfg.d_model, cfg.d_ff, cfg.head_dim_, cfg.vocab_size
    hq, hkv, E = cfg.num_heads, cfg.num_kv_heads, cfg.num_experts
    P = n_periods(cfg)
    out_scale = 0.02 / math.sqrt(2 * cfg.num_layers)

    def rand(shape, scale=0.02):
        return torch.empty(shape, dtype=dt, device=dev).normal_(
            0.0, scale, generator=generator)

    def full(shape, value, dtype=dt):
        return torch.full(shape, value, dtype=dtype, device=dev)

    def norm(n=P):
        # LayerNorm with bias for encoder-decoders, RMSNorm's scale else
        w = {"w": full((n, d) if n else (d,), 1.0)}
        if cfg.is_encoder_decoder:
            w["b"] = full((n, d) if n else (d,), 0.0)
        return w

    def attn(n=P, cross=False):
        p = {"wq": rand((n, d, hq * hd)), "wk": rand((n, d, hkv * hd)),
             "wv": rand((n, d, hkv * hd)),
             "wo": rand((n, hq * hd, d), out_scale)}
        if cfg.attn_bias and not cross:
            p.update(bq=rand((n, hq * hd)), bk=rand((n, hkv * hd)),
                     bv=rand((n, hkv * hd)))
        return p

    def ssm():
        din, dtr = mamba.d_inner(cfg), mamba._dt_rank(cfg)
        ds, w = cfg.ssm_d_state, cfg.ssm_d_conv
        A = torch.arange(1, ds + 1, dtype=torch.float32, device=dev)
        u = torch.rand((P, din), generator=generator, device=dev)
        dt_init = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                            + math.log(1e-3))
        return {"in_proj": rand((P, d, 2 * din)),
                "conv_w": rand((P, din, w), 0.1),
                "conv_b": full((P, din), 0.0),
                "x_proj": rand((P, din, dtr + 2 * ds)),
                "dt_proj": rand((P, dtr, din), 0.1),
                "dt_bias": dt_init + torch.log(-torch.expm1(-dt_init)),
                "A_log": torch.log(A).expand(P, din, ds).contiguous(),
                "D": full((P, din), 1.0, torch.float32),
                "out_proj": rand((P, din, d), out_scale)}

    def mlstm():
        din, qk = xlstm.m_d_inner(cfg), xlstm.m_qk_dim(cfg)
        return {"w_up": rand((P, d, 2 * din)), "wq": rand((P, din, qk)),
                "wk": rand((P, din, qk)), "wv": rand((P, din, din)),
                "w_i": rand((P, din, hq)), "w_f": rand((P, din, hq)),
                "out_proj": rand((P, din, d), out_scale)}

    def slstm():
        dh = d // hq
        p = {"out_proj": rand((P, d, d), out_scale)}
        for g in xlstm.GATES:
            p[f"w_{g}"] = rand((P, d, d))
            p[f"r_{g}"] = rand((P, hq, dh, dh))
            p[f"b_{g}"] = full((P, d), 1.0 if g == "f" else 0.0)
        return p

    def mlp(experts=(), n=P):
        gate = ({"w_gate": rand((n, *experts, d, f))}
                if cfg.activation == "silu" else {})
        return {**gate, "w_up": rand((n, *experts, d, f)),
                "w_down": rand((n, *experts, f, d), out_scale)}

    mixers = {ATTN: attn, MAMBA: ssm, MLSTM: mlstm, SLSTM: slstm}
    blocks = {}
    for j, (kind, is_moe) in enumerate(sub_kinds(cfg)):
        sub = {"ln1": norm(), "mixer": mixers[kind]()}
        if cfg.is_encoder_decoder:
            sub["lnx"] = norm()
            sub["xattn"] = attn(cross=True)
        if f > 0 and kind in (ATTN, MAMBA):
            sub["ln2"] = norm()
            if is_moe:
                sub["moe"] = {"router": rand((P, d, E)), **mlp((E,))}
            else:
                sub["mlp"] = mlp()
        blocks[f"sub{j}"] = sub
    params = {"embed": rand((V, d)), "final_norm": norm(0),
              "blocks": blocks}
    if not cfg.tie_embeddings:
        params["lm_head"] = rand((d, V))
    if cfg.is_encoder_decoder:
        Pe = cfg.num_encoder_layers
        params["encoder"] = {
            "blocks": {"sub0": {"ln1": norm(Pe), "mixer": attn(Pe),
                                "ln2": norm(Pe), "mlp": mlp(n=Pe)}},
            "final_norm": {"w": full((d,), 1.0), "b": full((d,), 0.0)}}
    return params


def slice_layer_params(cfg: ModelConfig, params, i: int):
    """Params of global layer i (views, leading period axis removed)."""
    p, j = layer_sub_index(cfg, i)

    def take(tree):
        return {k: take(v) if isinstance(v, dict) else v[p]
                for k, v in tree.items()}
    return take(params["blocks"][f"sub{j}"])


# ---------------------------------------------------------------------------
# Contiguous cache (the draft model's, and the reference-shaped prefill)
# ---------------------------------------------------------------------------

def _slot_state(cfg, kind, shape, dt, dev):
    """Zeroed recurrent state of a Mamba, mLSTM or sLSTM layer for `shape`
    leading dims (Mamba's conv tail in `dt`, everything else float32)."""
    def zeros(*dims, dtype=torch.float32):
        return torch.zeros((*shape, *dims), dtype=dtype, device=dev)
    if kind == MLSTM:
        h = cfg.num_heads
        qk_h = xlstm.m_qk_dim(cfg) // h
        return {"C": zeros(h, qk_h, xlstm.m_d_inner(cfg) // h),
                "n": zeros(h, qk_h)}
    if kind == SLSTM:
        return {nm: zeros(cfg.d_model) for nm in ("c", "n", "m", "h")}
    din = mamba.d_inner(cfg)
    return {"conv": zeros(cfg.ssm_d_conv - 1, din, dtype=dt),
            "h": zeros(din, cfg.ssm_d_state)}


def _cache_leaves(cfg, kind, lead, max_len, dt, dev):
    """Zeroed contiguous cache leaves of one layer kind, `lead` leading
    dims: attention {"k", "v"} (*lead, S, hkv, hd), S = max_len or, for a
    sliding-window model, the min(max_len, swa_window)-slot ring
    (``layers.write_cache``), plus an encoder-decoder's {"cross_k",
    "cross_v"} (*lead, encoder_seq_len, hkv, hd); a recurrent layer's
    state (``_slot_state``)."""
    if kind != ATTN:
        return _slot_state(cfg, kind, lead, dt, dev)
    S = min(max_len, cfg.swa_window) if cfg.swa_window else max_len
    hkv, hd = cfg.num_kv_heads, cfg.head_dim_
    c = {"k": torch.zeros((*lead, S, hkv, hd), dtype=dt, device=dev),
         "v": torch.zeros((*lead, S, hkv, hd), dtype=dt, device=dev)}
    if cfg.is_encoder_decoder:
        shape = (*lead, cfg.encoder_seq_len, hkv, hd)
        c["cross_k"] = torch.zeros(shape, dtype=dt, device=dev)
        c["cross_v"] = torch.zeros(shape, dtype=dt, device=dev)
    return c


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, dtype=None,
               device="cuda"):
    """Zeroed contiguous cache {"sub{j}": ...} of each period position j,
    stacked over the n_periods layers there: attention {"k", "v"}
    (P, batch, S, hkv, hd), a recurrent layer's state with leading dims
    (P, batch) (``_cache_leaves``)."""
    P = n_periods(cfg)
    dt = param_dtype(cfg, dtype)
    dev = resolve_device(device)
    return {f"sub{j}": _cache_leaves(cfg, kind, (P, batch), max_len, dt, dev)
            for j, (kind, _) in enumerate(sub_kinds(cfg))}


def init_layer_cache(cfg: ModelConfig, i: int, batch: int, max_len: int, *,
                     dtype=None, device="cuda"):
    """Global layer i's contiguous cache (no period axis): init_cache's
    leaves of one layer."""
    return _cache_leaves(cfg, cfg.layer_kind(i), (batch,), max_len,
                         param_dtype(cfg, dtype), resolve_device(device))


def _layer_cache(cfg, cache, i):
    """Views of global layer i's leaves in an init_cache tree."""
    p, j = layer_sub_index(cfg, i)
    return {n: t[p] for n, t in cache[f"sub{j}"].items()}


def scatter_cache_rows(pool, rows, slot_ids, *, batch_axis=1):
    """Write `rows` (a cache tree whose batch is len(slot_ids)) into `pool`
    at those batch rows, in place: batch_axis 1 for an init_cache tree (the
    period axis first), 0 for one layer's cache (init_layer_cache).
    Attention rows may be shorter than the pool's and fill its leading
    positions. Returns pool."""
    for n, t in pool.items():
        src = rows[n]
        if isinstance(t, dict):
            scatter_cache_rows(t, src, slot_ids, batch_axis=batch_axis)
            continue
        idx = torch.as_tensor(list(slot_ids), device=t.device).long()
        dst = (t.narrow(batch_axis + 1, 0, src.shape[batch_axis + 1])
               if n in ("k", "v") else t)
        dst.index_copy_(batch_axis, idx, src.to(t.dtype))
    return pool


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
                           block_size: int, *, dtype, device, n_slots=0,
                           kv_dtype=None, kv_guard_layers=()):
    """Global layer i's paged cache: an attention layer's page pools (block
    0 = null/trash page), a recurrent layer's zeroed per-slot state
    (``_slot_state``: Mamba's {"conv": (n_slots, w-1, din) `dtype`, "h":
    (n_slots, din, ds) float32}, mLSTM's and sLSTM's float32 leaves).
    `kv_dtype` ("int8" / "fp8") stores int8 / fp8 payloads with zeroed
    float32 scale pools; a layer whose global index i is in
    `kv_guard_layers` keeps the model's `dtype` whatever kv_dtype says."""
    kind = cfg.layer_kind(i)
    if kind != ATTN:
        if n_slots < 1:
            raise ValueError(f"a {kind} layer's slot state needs "
                             "n_slots >= 1")
        return _slot_state(cfg, kind, (n_slots,), dtype, device)
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
    K/V pools, and their scale pools where quantized, in place (a
    recurrent layer's per-slot state has no pages and is left alone)."""
    for c in caches:
        for n in ("k", "v") + quant.KV_SCALE_LEAVES:
            if n in c:
                quant.bits(c[n])[dst_blocks] = quant.bits(c[n])[src_blocks]


# ---------------------------------------------------------------------------
# Stack application (one attention block: norm, attention, norm, MLP)
# ---------------------------------------------------------------------------

def _norm(cfg, p, x):
    if cfg.is_encoder_decoder:                       # LayerNorm with bias
        return layers.layer_norm(x, p["w"], p["b"], cfg.norm_eps)
    return layers.rms_norm(x, p["w"], cfg.norm_eps)


def _ffn(cfg, sp, x):
    """The block's second half: x plus its MLP or MoE on the normed x."""
    if "mlp" in sp:
        return x + layers.mlp(sp["mlp"], _norm(cfg, sp["ln2"], x), cfg)
    if "moe" in sp:
        return x + moe.moe_mlp(sp["moe"], _norm(cfg, sp["ln2"], x), cfg)
    return x


def _attn_only(kind):
    if kind != ATTN:
        raise NotImplementedError(
            "the paged context and verify paths need attention layers: a "
            "recurrent state cannot resume per block or roll back")


def _write_slot_rows(sc, rows, slot_ids):
    """Scatter a recurrent layer's fresh state rows into its slots, in
    place."""
    idx = torch.as_tensor(list(slot_ids),
                          device=next(iter(sc.values())).device).long()
    for n, t in sc.items():
        t.index_copy_(0, idx, rows[n].to(t.dtype))


def _recurrent_prefill(cfg, kind, p, h, sc, *, valid, lens):
    """A recurrent layer over whole prompts h (m, P, d) from a zero state,
    as the reference's scratch caches start. Returns (out, the m rows of
    final state)."""
    if kind == MAMBA:
        return mamba.mamba_prefill(p, h, cfg, valid=valid, lens=lens,
                                   cache=sc)
    zero = _slot_state(cfg, kind, (h.shape[0],), h.dtype, h.device)
    fn = xlstm.mlstm_prefill if kind == MLSTM else xlstm.slstm_prefill
    return fn(p, h, cfg, valid=valid, cache=zero)


_DECODE = {MAMBA: mamba.mamba_decode, MLSTM: xlstm.mlstm_decode,
           SLSTM: xlstm.slstm_decode}


def _recurrent_decode(cfg, kind, p, h, sc):
    """One decode step of a recurrent layer over every row of its state
    `sc`, in place."""
    o, new = _DECODE[kind](p, h, cfg, cache=sc)
    for n, t in sc.items():
        t.copy_(new[n])
    return o


def _cross(cfg, sp, x, sc, enc_out=None):
    """An encoder-decoder block's cross-attention residual: from the
    encoder output enc_out (b, se, d), writing the cross K/V into
    `sc["cross_k"]` / `["cross_v"]` in place (prefill), or, without
    enc_out, from those cached K/V (decode). Other models: x as it is."""
    if not cfg.is_encoder_decoder:
        return x
    hx = _norm(cfg, sp["lnx"], x)
    if enc_out is None:
        o, _ = layers.cross_attn(sp["xattn"], hx, cfg,
                                 enc_kv={"k": sc["cross_k"],
                                         "v": sc["cross_v"]})
        return x + o
    o, ekv = layers.cross_attn(sp["xattn"], hx, cfg, enc_out=enc_out)
    for n in ("k", "v"):
        if ekv[n].shape != sc["cross_" + n].shape:
            raise ValueError(f"encoder K/V of shape {tuple(ekv[n].shape)}; "
                             f"the cache holds "
                             f"{tuple(sc['cross_' + n].shape)} "
                             f"(encoder_seq_len {cfg.encoder_seq_len})")
        sc["cross_" + n].copy_(ekv[n])
    return x + o


def apply_sublayer_seq(cfg, kind, sp, x, sc, *, positions, dest_blocks=None,
                       kv_start=None, valid=None, lens=None, slot_ids=None,
                       enc_out=None):
    """One block over whole prompts x (m, P, d): right-padded (lens (m,)),
    or left-padded from kv_start (m,) (static batching), with `valid`
    (m, P) marking the real steps. An attention layer's K/V rows go into
    its pages `sc` through dest_blocks (m * max_blocks,), or, without
    dest_blocks, into the contiguous cache `sc` (``layers.write_cache``: a
    full cache or the sliding-window ring); a recurrent layer (Mamba,
    mLSTM, sLSTM) scans from a zero state and writes each row's final
    state into slot slot_ids[row] of `sc` (None: row i into row i). An
    encoder-decoder block then attends to the encoder output enc_out
    (``_cross``, caching its K/V). Returns x."""
    h = _norm(cfg, sp["ln1"], x)
    if kind != ATTN:
        o, rows = _recurrent_prefill(cfg, kind, sp["mixer"], h, sc,
                                     valid=valid, lens=lens)
        _write_slot_rows(sc, rows, range(x.shape[0]) if slot_ids is None
                         else slot_ids)
    else:
        o, k, v = layers.attn_prefill(sp["mixer"], h, cfg,
                                      positions=positions, kv_start=kv_start)
        if dest_blocks is None:
            layers.write_cache(sc, k, v, window=cfg.swa_window)
        else:
            scatter_rows_to_pages(sc, {"k": k, "v": v}, dest_blocks)
    return _ffn(cfg, sp, _cross(cfg, sp, x + o, sc, enc_out))


def apply_sublayer_decode(cfg, kind, sp, x, sc, *, pos, kv_start=None):
    """One block for a single decode token per row against the contiguous
    cache `sc` (pos a scalar or (b,) per-row positions; kv_start (b,) the
    left padding), in place; an encoder-decoder block also attends to its
    cached cross K/V."""
    h = _norm(cfg, sp["ln1"], x)
    if kind != ATTN:
        o = _recurrent_decode(cfg, kind, sp["mixer"], h, sc)
    else:
        o = layers.attn_decode(sp["mixer"], h, cfg, pos=pos, cache=sc,
                               kv_start=kv_start)
    return _ffn(cfg, sp, _cross(cfg, sp, x + o, sc))


def apply_sublayer_decode_paged(cfg, kind, sp, x, sc, *, pos, block_tables):
    """One block for a single decode token per row against paged `sc`: an
    attention layer reads and writes its pages, a recurrent layer steps
    every slot's state (free slots step garbage that their next insert
    overwrites), in place."""
    h = _norm(cfg, sp["ln1"], x)
    if kind != ATTN:
        o = _recurrent_decode(cfg, kind, sp["mixer"], h, sc)
    else:
        o = layers.attn_decode_paged(sp["mixer"], h, cfg, pos=pos,
                                     block_tables=block_tables, cache=sc)
    return _ffn(cfg, sp, x + o)


def apply_sublayer_context_paged(cfg, kind, sp, x, sc, *, positions, q_len,
                                 block_tables):
    """One block over a chunk of new tokens against paged `sc`."""
    _attn_only(kind)
    o = layers.attn_context_paged(sp["mixer"], _norm(cfg, sp["ln1"], x),
                                  cfg, positions=positions, q_len=q_len,
                                  block_tables=block_tables, cache=sc)
    return _ffn(cfg, sp, x + o)


def apply_sublayer_verify_paged(cfg, kind, sp, x, sc, *, positions, q_len,
                                block_tables):
    """One block over each slot's candidate chunk against paged `sc`
    (speculative verification; attention-only: a recurrent state cannot
    roll back past a rejected candidate)."""
    _attn_only(kind)
    o = layers.attn_verify_paged(sp["mixer"], _norm(cfg, sp["ln1"], x), cfg,
                                 positions=positions, q_len=q_len,
                                 block_tables=block_tables, cache=sc)
    return _ffn(cfg, sp, x + o)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def _embed(cfg, params, tokens):
    x = params["embed"][tokens]
    if cfg.family == "vlm":                      # gemma-style scaling
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def _head(cfg, params, x):
    x = _norm(cfg, params["final_norm"], x)
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return quant.mm(x, params["lm_head"])


def _encoder_forward(cfg, params, frames):
    """Whisper's encoder over stub frame embeddings frames (b, se, d), cast
    to the model's dtype: sinusoidal positions, num_encoder_layers blocks
    of bidirectional attention (#1, non-causal) and MLP, the final
    LayerNorm. Returns (b, se, d)."""
    ep = params["encoder"]
    w = ep["final_norm"]["w"]
    x = torch.as_tensor(frames, device=w.device).to(w.dtype)
    b, se, d = x.shape
    pos = torch.arange(se, device=x.device)[None].expand(b, se)
    x = x + layers.sinusoidal_positions(pos, d).to(x.dtype)
    stack = ep["blocks"]["sub0"]
    for i in range(cfg.num_encoder_layers):
        pp = {k: {n: t[i] for n, t in v.items()} for k, v in stack.items()}
        x = x + layers.attn_encoder(pp["mixer"], _norm(cfg, pp["ln1"], x),
                                    cfg)
        x = x + layers.mlp(pp["mlp"], _norm(cfg, pp["ln2"], x), cfg)
    return layers.layer_norm(x, w, ep["final_norm"]["b"], cfg.norm_eps)


def _add_positions(cfg, x, positions):
    """Whisper's decoder adds sinusoidal positions (b, s) to its token
    embeddings x (b, s, d), as it has no RoPE; other models: x."""
    if cfg.is_encoder_decoder and cfg.rope_theta == 0.0:
        return x + layers.sinusoidal_positions(positions,
                                               cfg.d_model).to(x.dtype)
    return x


def _prep_input_seq(cfg, params, batch):
    """batch["tokens"] (b, st) (+ the modality stubs) -> (x, positions,
    prefix): the embeddings, paligemma's ``image_embeds`` (b, n_img, d)
    before them (prefix = n_img), positions arange(s) of the whole
    sequence, and whisper's sinusoidal positions added."""
    dev = params["embed"].device
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    x = _embed(cfg, params, tokens)
    prefix = 0
    if cfg.num_image_tokens:
        img = torch.as_tensor(batch["image_embeds"], device=dev)
        x = torch.cat([img.to(x.dtype), x], dim=1)
        prefix = cfg.num_image_tokens
    b, s = x.shape[:2]
    positions = torch.arange(s, device=dev)[None].expand(b, s)
    return _add_positions(cfg, x, positions), positions, prefix


# ---------------------------------------------------------------------------
# Whole-model entry points
# ---------------------------------------------------------------------------

def prefill(cfg: ModelConfig, params, batch, cache, *, kv_start=None,
            lens=None):
    """Prompt pass over batch["tokens"] (b, s), writing every attention
    layer's K/V into the cache (``layers.write_cache``: positions [0, s),
    or the sliding-window ring) and every recurrent layer's final state into
    its rows, in place. Two padding conventions, as in the reference:
    kv_start (b,) marks LEFT-padded rows (static batching; logits from the
    last column), lens (b,) RIGHT-padded ones (row i's prompt is
    [0, lens[i]), its pad steps leave the recurrent state alone and its
    logits come from its own last real token). The batch also carries the
    modality stubs: whisper's ``enc_frames`` (the encoder runs first and
    every decoder layer caches its cross K/V), paligemma's
    ``image_embeds`` (the sequence's first num_image_tokens positions).
    Returns (logits (b, V), cache)."""
    if kv_start is not None and lens is not None:
        raise ValueError("pick one padding convention")
    x, positions, _ = _prep_input_seq(cfg, params, batch)
    b, s = x.shape[:2]
    enc_out = None
    if cfg.is_encoder_decoder:
        enc_out = _encoder_forward(cfg, params, batch["enc_frames"])
    valid = None
    if kv_start is not None:
        kv_start = torch.as_tensor(kv_start, device=x.device).long()
        valid = (positions >= kv_start[:, None]).to(torch.int32)
    if lens is not None:
        lens = torch.as_tensor(lens, device=x.device).long()
        valid = (positions < lens[:, None]).to(torch.int32)
    for i in range(cfg.num_layers):
        x = apply_sublayer_seq(cfg, cfg.layer_kind(i),
                               slice_layer_params(cfg, params, i), x,
                               _layer_cache(cfg, cache, i),
                               positions=positions, kv_start=kv_start,
                               valid=valid, lens=lens, enc_out=enc_out)
    if lens is not None:
        x = x[torch.arange(b, device=x.device), lens - 1][:, None]
    else:
        x = x[:, -1:]
    return _head(cfg, params, x)[:, 0], cache


def decode_step(cfg: ModelConfig, params, tokens, cache, pos, *,
                kv_start=None):
    """One decode step against the contiguous cache, in place. tokens (b,);
    pos a scalar (a uniform batch of left-padded prompts, kv_start (b,)
    their padding) or (b,) per-row absolute positions. Returns
    (logits (b, V), cache)."""
    tokens = torch.as_tensor(tokens, device=params["embed"].device).long()
    x = _embed(cfg, params, tokens[:, None])
    pos = torch.as_tensor(pos, device=x.device)
    x = _add_positions(cfg, x, pos.long().expand(x.shape[0])[:, None])
    if kv_start is not None:
        kv_start = torch.as_tensor(kv_start, device=x.device)
    for i in range(cfg.num_layers):
        x = apply_sublayer_decode(cfg, cfg.layer_kind(i),
                                  slice_layer_params(cfg, params, i), x,
                                  _layer_cache(cfg, cache, i), pos=pos,
                                  kv_start=kv_start)
    return _head(cfg, params, x)[:, 0], cache


# ---------------------------------------------------------------------------
# Training (the reference's mode="train": whole sequences, no cache)
# ---------------------------------------------------------------------------

def apply_sublayer_train(cfg, kind, sp, x, *, positions, enc_out=None):
    """One block over whole sequences x (b, s, d) with no cache: the mixer
    (causal attention through #1, Mamba through #9, or the plain mLSTM /
    sLSTM recurrences), an encoder-decoder's cross-attention to enc_out,
    then the MLP or MoE. Returns (x, the MoE router's aux loss or 0)."""
    h = _norm(cfg, sp["ln1"], x)
    if kind == ATTN:
        o, _, _ = layers.attn_prefill(sp["mixer"], h, cfg,
                                      positions=positions)
    elif kind == MAMBA:
        o, _ = mamba.mamba_prefill(sp["mixer"], h, cfg)
    elif kind == MLSTM:
        o, _ = xlstm.mlstm_prefill(sp["mixer"], h, cfg)
    else:
        o, _ = xlstm.slstm_prefill(sp["mixer"], h, cfg)
    x = x + o
    if cfg.is_encoder_decoder:
        o, _ = layers.cross_attn(sp["xattn"], _norm(cfg, sp["lnx"], x), cfg,
                                 enc_out=enc_out)
        x = x + o
    if "moe" in sp:
        o, aux = moe.moe_mlp(sp["moe"], _norm(cfg, sp["ln2"], x), cfg,
                             return_aux=True)
        return x + o, aux
    return _ffn(cfg, sp, x), torch.zeros((), device=x.device)


def train_forward(cfg: ModelConfig, params, batch):
    """Full-sequence causal logits for training (twin of the reference's
    train_forward). batch: {"tokens": (b, s)} plus the modality stubs
    (paligemma's ``image_embeds``, whisper's ``enc_frames``). Returns
    (logits (b, s_total, V), the MoE layers' aux losses summed, float32);
    s_total counts paligemma's image prefix."""
    x, positions, _ = _prep_input_seq(cfg, params, batch)
    enc_out = None
    if cfg.is_encoder_decoder:
        enc_out = _encoder_forward(cfg, params, batch["enc_frames"])
    aux = torch.zeros((), device=x.device)
    for i in range(cfg.num_layers):
        x, a = apply_sublayer_train(cfg, cfg.layer_kind(i),
                                    slice_layer_params(cfg, params, i), x,
                                    positions=positions, enc_out=enc_out)
        aux = aux + a
    return _head(cfg, params, x), aux


def loss_fn(cfg: ModelConfig, params, batch):
    """Next-token cross entropy over the text positions (log_softmax in
    float32; the image prefix's logits dropped) plus the aux loss."""
    logits, aux = train_forward(cfg, params, batch)
    tokens = torch.as_tensor(batch["tokens"], device=logits.device).long()
    pred = logits[:, cfg.num_image_tokens:][:, :-1]
    logp = torch.log_softmax(pred.float(), dim=-1)
    nll = -torch.gather(logp, -1, tokens[:, 1:, None])[..., 0]
    return nll.mean() + aux


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
