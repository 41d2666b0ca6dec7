"""Megatron tensor-parallel split rules of the port (twin of
repro.models.shardings), as plain functions on shapes: for a leaf and a TP
degree, the dimension the leaf splits on, or None (replicated). No
PartitionSpec: the port places each shard's slices itself
(``serving.pipeline.StageExecutor``).

Column-parallel: wq/wk/wv, w_gate/w_up, mamba in_proj  -> split output dim
Row-parallel:    wo, w_down, mamba out_proj             -> split input dim
Experts:         (E, d, f) split over E when E % tp == 0, else over d_ff
Embedding:       vocab-split embed (dim 0) and lm_head (dim 1)
KV heads:        split only when num_kv_heads % tp == 0, else replicated
                 (granite-20b's MQA; granite-8b's 8 kv heads at TP 16)
Anything unmatched is replicated. The sublayer kind (attention, Mamba,
mLSTM, sLSTM) comes from the ``sub{j}`` path element, so the leaf names
that several kinds share (wq / wk / wv) resolve by kind, as in the
reference.

``param_splits`` and ``cache_splits`` give the reference's rules leaf by
leaf, for an int8-weight tree too: there a weight is {"q", "s"}, and the
rules match on the last path element, which is never ``wq`` or ``w_up``,
so the reference replicates every ``q`` and ``s`` (ROADMAP.md F9; its
``models/quant.py`` docstring promises the Megatron cut). The port cuts
them (``quant_split``): ``q`` as its plain weight, ``s`` with the output
columns of a column-parallel weight (and with the experts of an
expert-parallel one), whole beside a row-parallel one, so a TP-t stage
holds 1/t of each split weight's int8 bytes.

The executor (``models.model.shard_layer_params``) cuts the MLP and
MoE leaves on ``leaf_split``'s dimension, and every attention leaf on its
``HEAD_AXIS`` at the shard's global head range (``shard_heads``), which
is ``leaf_split``'s even split wherever that splits. Where the rules
replicate wk / wv and the K / V pools (kv heads that do not divide the
TP degree), a shard keeps only the kv heads its own q heads read, chosen
by global head index (q head h reads kv head h // (num_heads //
num_kv_heads)): a subset of the reference's replicated whole (all of it
for an MQA model's one kv head).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

from repro_torch.configs.base import ATTN, MAMBA, MLSTM, SLSTM, ModelConfig

KV_SCALE_LEAVES = ("k_scale", "v_scale")
# an attention leaf's head axis (without the period axis): wq / wk / wv's
# columns and wo's rows are heads x head_dim, as are the q/k/v biases
HEAD_AXIS = {"wq": 1, "wk": 1, "wv": 1, "bq": 0, "bk": 0, "bv": 0, "wo": 0}
KV_LEAVES = ("wk", "wv", "bk", "bv")


class HeadCut(NotImplementedError):
    """``shard_heads``' refusal: a shard would hold part of a query head,
    or read its kv heads unevenly."""


def _div(n: int, tp: int) -> bool:
    return tp > 0 and n % tp == 0


def _sub_kinds(cfg: ModelConfig):
    # the kinds of models.model.sub_kinds, without importing the model
    p = len(cfg.layer_pattern) if cfg.layer_pattern else 1
    m = cfg.moe_every if cfg.num_experts else 1
    return [cfg.layer_kind(j) for j in range(math.lcm(p, m))]


def leaf_split(cfg: ModelConfig, names: Sequence[str], ndim: int,
               tp: int) -> Optional[int]:
    """The dimension a parameter leaf splits on at TP degree `tp`, or None.
    `names` is the leaf's path of dict keys in the param tree; a leaf
    under ``blocks`` (or an encoder's) carries the leading period axis,
    counted in `ndim` and in the returned index (the reference's
    ``param_specs``)."""
    if tp <= 1:
        return None
    kinds = _sub_kinds(cfg)
    name = names[-1]
    stacked = "blocks" in names
    in_moe, in_mixer = "moe" in names, "mixer" in names
    kind = ATTN
    for n in names:
        if n.startswith("sub") and n != "sub" and "encoder" not in names:
            kind = kinds[int(n[3:])]
    lead = 1 if stacked else 0

    def at(dim: int) -> int:
        # the reference's wrap(None, .., m, ..): dimension `dim` of the
        # leaf without its period axis
        return lead + dim

    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    E, f = cfg.num_experts, cfg.d_ff
    din = cfg.ssm_expand * cfg.d_model
    if name == "embed":
        return 0 if _div(cfg.vocab_size, tp) else None
    if name == "lm_head":
        return 1 if _div(cfg.vocab_size, tp) else None
    if name in HEAD_AXIS and kind == ATTN:
        ok = _div(hkv, tp) if name in KV_LEAVES else _div(hq * hd, tp)
        return at(HEAD_AXIS[name]) if ok else None
    if in_mixer and kind == MAMBA:
        sd = _div(din, tp)
        if name == "in_proj":
            return at(1) if sd else None
        if name in ("conv_w", "conv_b", "A_log", "D", "dt_bias", "x_proj"):
            return at(0) if sd else None
        if name == "dt_proj":
            return at(1) if sd else None
        if name == "out_proj":
            return at(0) if sd else None
    if in_mixer and kind == MLSTM:
        sd = _div(din, tp)
        if name == "w_up":
            return at(1) if sd else None
        if name in ("wq", "wk", "wv", "w_i", "w_f"):
            return at(0) if sd else None
        return None                   # out_proj: y replicated after the sum
    if in_mixer and kind == SLSTM:
        return None                   # tiny; replicated
    if in_moe:
        if name == "router":
            return None
        se, sf = _div(E, tp), _div(f, tp)
        if name in ("w_gate", "w_up"):
            return at(0) if se else (at(2) if sf else None)
        if name == "w_down":
            return at(0) if se else (at(1) if sf else None)
    if name in ("w_gate", "w_up"):
        return at(1) if _div(f, tp) else None
    if name == "w_down":
        return at(0) if _div(f, tp) else None
    return None


def quant_split(cfg: ModelConfig, names: Sequence[str], ndim: int,
                tp: int) -> Tuple[Optional[int], Optional[int]]:
    """(q's split dimension, s's) of an int8 weight {"q": (..., in, out),
    "s": (..., out)} at TP degree `tp`, from its plain weight's rule:
    `names` is the weight's path (ending in ``wq``, ``w_up``, ...) and
    `ndim` its q's dimensions. q splits as the plain weight would; s
    splits with q's output columns (a column-parallel weight) or leading
    axes (a 3-D expert weight's E), and stays whole where q splits on its
    contraction rows (a row-parallel weight)."""
    d = leaf_split(cfg, names, ndim, tp)
    return d, quant_s_dim(d, ndim)


def quant_s_dim(d: Optional[int], ndim: int) -> Optional[int]:
    """The dimension of s (..., out) that an int8 weight's scales split on
    when its q (..., in, out), `ndim` dimensions, splits on `d`: the output
    columns or a leading (expert) axis carry their scales along; the
    contraction rows (a row-parallel cut) keep every scale."""
    if d is None or d == ndim - 2:
        return None
    return d if d < ndim - 2 else ndim - 2


def _map(tree, fn, path=()):
    return {k: _map(v, fn, path + (k,)) if isinstance(v, dict)
            else fn(path + (k,), v) for k, v in tree.items()}


def param_splits(cfg: ModelConfig, params, tp: int):
    """The split dimension (or None) of every leaf of a param tree (any
    leaves with a ``.dim()``: meta tensors will do), in the tree's
    layout."""
    return _map(params, lambda path, t: leaf_split(cfg, path, t.dim(), tp))


def cache_split(names: Sequence[str], shape: Sequence[int],
                tp: int) -> Optional[int]:
    """The split dimension of one cache leaf at TP degree `tp` (the
    reference's ``cache_specs`` on its model axis). Attention K / V,
    cross K / V and a quantized pool's scale pools split on their kv-head
    axis when the kv heads divide `tp`: the second dimension from the end
    of K / V (contiguous (P, b, S, hkv, hd), paged (n_blocks, bs, hkv,
    hd)), the last of a scale pool (n_blocks, bs, hkv), which the
    reference's rule does not name: its pools are replicated, the port's
    live per shard. Where this gives None for K / V (kv heads that do
    not divide `tp`), each shard's pools hold the kv heads its q heads
    read (``shard_heads``). Mamba's conv tail (P, b, w - 1, din) and state
    (P, b, din, ds) split on din; the rest is replicated."""
    if tp <= 1:
        return None
    name, nd = names[-1], len(shape)
    if name in ("k", "v", "cross_k", "cross_v"):
        return nd - 2 if shape[nd - 2] % tp == 0 else None
    if name in KV_SCALE_LEAVES:
        return nd - 1 if shape[nd - 1] % tp == 0 else None
    if name == "conv":
        return 3 if shape[3] % tp == 0 else None
    if name == "h" and nd == 4:
        return 2 if shape[2] % tp == 0 else None
    return None


def cache_splits(cache, tp: int):
    """``cache_split`` of every leaf of a cache tree."""
    return _map(cache, lambda path, t: cache_split(path, tuple(t.shape), tp))


def shard_heads(cfg: ModelConfig, tp: int
                ) -> List[Tuple[Tuple[int, int], Tuple[int, int]]]:
    """Each shard's global (q head range, kv head range), in shard order:
    shard r takes q heads [r hq / tp, (r + 1) hq / tp) (wq's column split,
    whole heads) and the kv heads they read, which are wk / wv's split
    where the kv heads divide `tp` and a subset of the replicated whole
    where they do not (granite-20b's one kv head on every shard). Raises
    NotImplementedError where a shard would hold part of a head, or where
    its q heads read their kv heads in a pattern its own kernel call
    cannot express (local q head j -> local kv head j // g_local): a
    ``HeadCut``."""
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    if hq % tp:
        raise HeadCut(
            f"{cfg.name}: {hq} query heads do not split over {tp} shards "
            "without cutting a head")
    g, n = hq // hkv, hq // tp
    out = []
    for r in range(tp):
        q0 = r * n
        k0, k1 = q0 // g, (q0 + n - 1) // g + 1
        if n % (k1 - k0) or any((q0 + j) // g - k0 != j // (n // (k1 - k0))
                                for j in range(n)):
            raise NotImplementedError(
                f"{cfg.name}: shard {r} of {tp} holds q heads "
                f"[{q0}, {q0 + n}) that read kv heads [{k0}, {k1}) unevenly")
        out.append(((q0, q0 + n), (k0, k1)))
    return out
