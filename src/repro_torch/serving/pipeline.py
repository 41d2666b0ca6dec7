"""Asymmetric pipeline executor of the port (twin of
repro.serving.pipeline, Contribution 1, §3.2): the static whole-batch path
(``generate``), contiguous slot mode and paged slot mode.

Each stage owns its own contiguous span of layers and its own device
group, with its own tensor-parallel degree: ``stage_devices[si]`` (the
reference's per-stage meshes). A stage over tp > 1 devices holds each
layer as tp shards, cut by the reference's Megatron rules
(``models.shardings``, ``models.model.shard_layer_params``), whatever
the family and whether or not the weights are int8: shard r keeps its q
heads and the kv heads they read (with their page pools and whisper's
cross K/V), its slice of a Mamba or mLSTM layer's din (with the Mamba
state's channels), its d_ff slice or its experts, on its own device; the
sublayers' outputs are summed across the shards in shard order before
each residual add. Embedding, final norm, head and whisper's encoder stay
whole on the stage's first device (the logits are the same), as do the
norms, an sLSTM layer and an mLSTM layer's cell and state. Activations
move to the next stage's first device, and from there to each of its
shards; a step's positions, block tables, masks and the encoder output
go to each stage's devices once (``StageExecutor.put``). Repeated devices
are not collapsed here (the engine does that): two shards on one card are
two shards. Stages stay separate objects with their own page pools,
sized independently, so the asymmetric split is real.

A stage's attention layers keep page pools, its recurrent layers (Mamba,
mLSTM, sLSTM) one row of state per slot; a stage may hold no attention
layer at all (``has_attn``).

The public methods keep the reference's numpy-in / numpy-out signatures:
they are the whole seam the batcher (serving.continuous) drives. Logits come
back to the host as float32 numpy arrays every call, as in the reference.
Page payloads (KV migration, the host tier, cluster prefix fetches) are the
exception: they are torch tensors at pool precision (numpy has no bf16 or
fp8), on the card, or in pinned host memory for the host tier, with every
kv head of each layer whatever the stage's TP degree.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ATTN, MLSTM, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.mamba import FP32_LEAVES
from repro_torch.models.quant import KV_SCALE_LEAVES, bits, is_quantized


def slot_mode_supported(cfg) -> bool:
    """Slot-based continuous batching drives uniform text decoders; SWA
    ring caches need uniform positions and encoder-decoder / VLM prompts
    carry per-request modality state."""
    return not (cfg.swa_window or cfg.is_encoder_decoder
                or cfg.num_image_tokens)


def context_mode_supported(cfg) -> bool:
    """Prefix caching and chunked prefill need every sublayer to be
    attention (a recurrent state has no per-block piece to share or
    resume)."""
    return slot_mode_supported(cfg) and all(
        cfg.layer_kind(i) == ATTN for i in range(cfg.num_layers))


class StageExecutor:
    """One pipeline stage: layers [lo, hi) on `devices`, tensor-parallel
    over tp = len(devices) shards (TP 1: the whole layers on devices[0]).
    Repeated devices are separate shards (two shards on one card, or on
    cpu:0 and cpu:1); collapsing a plan's device ids is the engine's job.
    Activations and the norms live on the first device."""

    def __init__(self, cfg: ModelConfig, params, lo: int, hi: int,
                 devices: Sequence[torch.device], *, dtype: torch.dtype,
                 is_first: bool, is_last: bool):
        self.cfg = cfg
        self.lo, self.hi = lo, hi
        self.is_first, self.is_last = is_first, is_last
        self.devices = list(devices)
        self.tp = len(self.devices)
        self.device = self.devices[0]
        self.dtype = dtype
        self.kinds = [cfg.layer_kind(i) for i in range(lo, hi)]

        def place(tree, device=self.device):
            # an int8 weight keeps its int8 payload and float32 scales, a
            # Mamba layer its float32 dynamics; a shard's slice is copied,
            # to be contiguous on its device (and to hold only its bytes)
            if is_quantized(tree):
                return {k: v.to(device=device).contiguous()
                        for k, v in tree.items()}
            return {k: place(v, device) if isinstance(v, dict)
                    else v.to(device=device,
                              dtype=torch.float32 if k in FP32_LEAVES
                              else dtype).contiguous()
                    for k, v in tree.items()}
        if self.tp == 1:
            self.layer_params = [place(M.slice_layer_params(cfg, params, i))
                                 for i in range(lo, hi)]
        else:
            self.layer_params = [
                M.shard_layer_params(cfg, M.slice_layer_params(cfg, params, i),
                                     i, self.devices, place)
                for i in range(lo, hi)]
        self.head_params = None
        if is_first or is_last:
            # whole on the first device (the logits are the same); no
            # lm_head under tied embeddings; the encoder runs on the first
            # stage
            names = [n for n in ("embed", "final_norm", "lm_head")
                     if n in params]
            if cfg.is_encoder_decoder and is_first:
                names.append("encoder")
            self.head_params = place({n: params[n] for n in names})

    @property
    def has_attn(self) -> bool:
        return ATTN in self.kinds

    def put(self, t):
        """A step's tensor `t` (or None) where this stage's layers read it:
        on its device at TP 1, else Shards of its copies, one copy a
        distinct device (so each goes once a step, not once a layer)."""
        if t is None or self.tp == 1:
            return None if t is None else t.to(self.device)
        by = {}
        for d in self.devices:
            if d not in by:
                by[d] = t.to(d)
        return M.Shards(by[d] for d in self.devices)

    def _shards(self, k: int):
        """Layer k's mixer shards (None at TP 1)."""
        m = self.layer_params[k]["mixer"]
        return m if isinstance(m, M.Shards) else None

    def _layer_caches(self, make):
        """make(cfg, i, device, d_inner) of each layer: one cache on the
        stage's device (a whole layer's, or an mLSTM layer's, whose cell
        runs there), or Shards of each shard's (its kv heads or its Mamba
        channels, on its device)."""
        out = []
        for k, i in enumerate(range(self.lo, self.hi)):
            sh = self._shards(k)
            out.append(make(self.cfg, i, self.device, None)
                       if sh is None or self.kinds[k] == MLSTM
                       else M.Shards(make(s.cfg, i, s.device, s.d_inner)
                                     for s in sh))
        return out

    def make_caches(self, batch: int, max_len: int):
        """Per-layer contiguous caches of `batch` rows: attention K/V of
        max_len positions (the sliding-window ring of min(max_len, window)
        slots), recurrent state rows."""
        return self._layer_caches(lambda cfg, i, dev, din: M.init_layer_cache(
            cfg, i, batch, max_len, dtype=self.dtype, device=dev,
            d_inner=din))

    def make_paged_caches(self, n_blocks: int, block_size: int,
                          n_slots: int, *, kv_dtype: Optional[str] = None,
                          kv_guard_layers: Sequence[int] = ()):
        """Per-layer caches: page pools for the attention layers, which
        share ONE block-id space of `n_blocks` blocks (one table addresses
        every layer and every shard), and `n_slots` rows of state for the
        recurrent layers.
        `kv_dtype` selects the pool precision (None = the model's);
        `kv_guard_layers` are GLOBAL layer indices kept at model
        precision."""
        return self._layer_caches(
            lambda cfg, i, dev, din: M.init_layer_paged_cache(
                cfg, i, n_blocks, block_size, dtype=self.dtype, device=dev,
                n_slots=n_slots, kv_dtype=kv_dtype,
                kv_guard_layers=kv_guard_layers, d_inner=din))

    def scatter_rows(self, pools, rows, slot_ids) -> None:
        """Write scratch caches `rows` into the contiguous `pools` at
        slots slot_ids, shard by shard, in place."""
        for pool, r in zip(pools, rows):
            for p, q in zip(M.parts(pool), M.parts(r)):
                M.scatter_cache_rows(p, q, slot_ids, batch_axis=0)

    def copy_pages(self, caches, src, dst) -> None:
        """Copy-on-write of page contents src -> dst (host lists) in every
        layer and shard, in place."""
        src, dst = (M.parts(self.put(torch.as_tensor(np.asarray(
            a, np.int64)))) for a in (src, dst))
        for c in caches:
            for r, part in enumerate(M.parts(c)):
                M.copy_cache_pages([part], src[r], dst[r])

    def gather_pages(self, caches, blocks, host: bool = False) -> List[dict]:
        """Each layer's payload at `blocks`: its K/V pages (and scale pages
        on a quantized pool), copied out at pool precision with ALL the
        layer's kv heads (a sharded layer's taken from the shards that
        hold them, each head once, on the stage's device). ``host`` puts
        the copy in host memory, pinned when the pool is on the card (one
        synchronous copy, so the payload is complete when this returns)."""
        idx = self.put(torch.as_tensor(np.asarray(blocks, np.int64)))
        out = []
        for k, c in enumerate(caches):
            sh = self._shards(k)
            if sh is None:
                lkv = _gather(c, idx)
            else:
                pieces, nxt = [], 0
                for s, cr, ir in zip(sh, c, idx):
                    k0, k1 = s.kv_heads
                    if k1 <= nxt:
                        continue        # a replicated head taken already
                    pieces.append({n: t.narrow(2, nxt - k0, k1 - nxt)
                                   .to(self.device)
                                   for n, t in _gather(cr, ir).items()})
                    nxt = k1
                lkv = {n: _bits_cat([p[n] for p in pieces], dim=2)
                       for n in pieces[0]}
            if host:
                lkv = {n: _to_host(t) for n, t in lkv.items()}
            out.append(lkv)
        return out

    def scatter_pages(self, caches, blocks, payload) -> None:
        """Write per-layer payloads (all kv heads) into `caches`' pools at
        `blocks`, in place, each shard taking its kv heads; a host payload
        is copied to the device first (synchronously: the host buffer may
        be dropped as soon as this returns)."""
        idx = self.put(torch.as_tensor(np.asarray(blocks, np.int64)))
        for k, (c, lkv) in enumerate(zip(caches, payload)):
            sh = self._shards(k)
            if sh is None:
                _scatter(c, idx, lkv)
                continue
            for s, cr, ir in zip(sh, c, idx):
                k0, k1 = s.kv_heads
                _scatter(cr, ir, {n: a.narrow(2, k0, k1 - k0)
                                  for n, a in lkv.items()})

    def kv_bytes(self, caches, base_itemsize: int):
        """(resident, baseline) bytes of the attention layers' pools,
        each kv head counted once (a replicated head's copies are one
        head, as in the reference's global arrays); baseline counts the
        K/V pools at `base_itemsize`."""
        resident = baseline = 0
        for k, c in enumerate(caches):
            sh = self._shards(k) or [None]
            nxt = 0
            for s, part in zip(sh, M.parts(c)):
                if "k" not in part:
                    break              # a recurrent layer's slot state
                share = 1.0
                if s is not None:
                    k0, k1 = s.kv_heads
                    share = max(k1 - max(k0, nxt), 0) / (k1 - k0)
                    nxt = max(nxt, k1)
                for n, t in part.items():
                    resident += int(t.numel() * share) * t.element_size()
                    if n in ("k", "v"):
                        baseline += int(t.numel() * share) * base_itemsize
        return resident, baseline

    def prefill(self, x, caches, positions, *, dest_blocks=None,
                kv_start=None, valid=None, lens=None, slot_ids=None,
                enc_out=None):
        """The stage's layers over whole prompts (``M.apply_sublayer_seq``):
        attention K/V into pages through dest_blocks, or into the
        contiguous `caches`; an encoder-decoder's layers attend to enc_out
        and cache its cross K/V. Every tensor argument is the step's on
        any device: it goes to this stage's devices here, once."""
        x = x.to(self.device)
        positions, dest_blocks, kv_start, valid, lens, enc_out = (
            self.put(t) for t in (positions, dest_blocks, kv_start, valid,
                                  lens, enc_out))
        for kind, lp, sc in zip(self.kinds, self.layer_params, caches):
            x = M.apply_sublayer_seq(self.cfg, kind, lp, x, sc,
                                     positions=positions,
                                     dest_blocks=dest_blocks,
                                     kv_start=kv_start, valid=valid,
                                     lens=lens, slot_ids=slot_ids,
                                     enc_out=enc_out)
        return x

    def decode(self, x, caches, pos, kv_start=None):
        """One decode token per row against the contiguous `caches`."""
        x, pos, kv_start = x.to(self.device), self.put(pos), \
            self.put(kv_start)
        for kind, lp, sc in zip(self.kinds, self.layer_params, caches):
            x = M.apply_sublayer_decode(self.cfg, kind, lp, x, sc,
                                        pos=pos, kv_start=kv_start)
        return x

    def decode_paged(self, x, caches, pos, block_tables):
        x, pos, block_tables = (x.to(self.device), self.put(pos),
                                self.put(block_tables))
        for kind, lp, sc in zip(self.kinds, self.layer_params, caches):
            x = M.apply_sublayer_decode_paged(self.cfg, kind, lp, x, sc,
                                              pos=pos,
                                              block_tables=block_tables)
        return x

    def context_paged(self, x, caches, positions, q_len, block_tables):
        x, positions, q_len, block_tables = (
            x.to(self.device), self.put(positions), self.put(q_len),
            self.put(block_tables))
        for kind, lp, sc in zip(self.kinds, self.layer_params, caches):
            x = M.apply_sublayer_context_paged(
                self.cfg, kind, lp, x, sc, positions=positions,
                q_len=q_len, block_tables=block_tables)
        return x

    def verify_paged(self, x, caches, positions, q_len, block_tables):
        x, positions, q_len, block_tables = (
            x.to(self.device), self.put(positions), self.put(q_len),
            self.put(block_tables))
        for kind, lp, sc in zip(self.kinds, self.layer_params, caches):
            x = M.apply_sublayer_verify_paged(
                self.cfg, kind, lp, x, sc, positions=positions,
                q_len=q_len, block_tables=block_tables)
        return x


def _bits_cat(ts, dim):
    """torch.cat of same-dtype tensors through their bits (fp8 too)."""
    if len(ts) == 1:
        return ts[0]
    return torch.cat([bits(t) for t in ts], dim=dim).view(ts[0].dtype)


def _to_host(t):
    """A copy of `t` in host memory, pinned when `t` is on the card."""
    if not t.is_cuda:
        return t
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    bits(h).copy_(bits(t))
    return h


def _gather(c: dict, idx) -> dict:
    """One pool's pages at block ids `idx` (on its device): K/V and, on a
    quantized pool, the scale pages, at pool precision."""
    if "k" not in c or "v" not in c:
        raise NotImplementedError("page payloads cover attention-only "
                                  "stacks (a recurrent layer's state "
                                  "has no pages)")
    return {n: bits(c[n]).index_select(0, idx).view(c[n].dtype)
            for n in ("k", "v") + KV_SCALE_LEAVES if n in c}


def _scatter(c: dict, idx, lkv: dict) -> None:
    """Write one layer's payload `lkv` into pool `c` at block ids `idx`,
    verbatim (the same leaves and dtypes), in place."""
    if set(lkv) != {n for n in ("k", "v") + KV_SCALE_LEAVES if n in c}:
        raise ValueError(f"payload leaves {sorted(lkv)} do not "
                         f"match the pool's {sorted(c)}")
    for n, a in lkv.items():
        if a.dtype != c[n].dtype:
            raise ValueError(f"payload {n} is {a.dtype}, the pool "
                             f"{c[n].dtype}: pages land verbatim")
        bits(c[n]).index_copy_(0, idx, bits(a).to(c[n].device))


class AsymmetricPipeline:
    """A full model replica as a chain of StageExecutors, stage si over
    the devices ``stage_devices[si]`` (None: one ``device`` a stage)."""

    def __init__(self, cfg: ModelConfig, params, stage_layers: Sequence[int],
                 stage_devices=None, *, device="cuda",
                 dtype: Optional[torch.dtype] = None):
        if sum(stage_layers) != cfg.num_layers:
            raise ValueError(f"stage layers {list(stage_layers)} do not sum "
                             f"to {cfg.num_layers}")
        if stage_devices is None:
            stage_devices = [[device]] * len(stage_layers)
        if len(stage_devices) != len(stage_layers) or not all(
                stage_devices):
            raise ValueError("one non-empty device list per stage")
        stage_devices = [[resolve_device(d) for d in devs]
                         for devs in stage_devices]
        self.cfg = cfg
        self.device = stage_devices[0][0]    # the replica's first device
        self.dtype = M.param_dtype(cfg, dtype)
        self.stages: List[StageExecutor] = []
        lo = 0
        for si, (nl, devs) in enumerate(zip(stage_layers, stage_devices)):
            self.stages.append(StageExecutor(
                cfg, params, lo, lo + nl, devs, dtype=self.dtype,
                is_first=(si == 0), is_last=(si == len(stage_layers) - 1)))
            lo += nl
        # static batching (prefill / decode_step / generate): the caches of
        # the batch in flight, its left padding and its next position
        self.caches = None
        self._kv_start = None
        self._pos = 0
        # slot mode (init_slot_caches) and paged slot mode
        # (init_paged_caches): per-stage caches whose rows are slots
        self.slot_caches = None
        self.n_slots = 0
        self.slot_len = 0
        self.paged_caches = None
        self.block_size = 0
        self.stage_blocks: List[int] = []
        self.kv_dtype: Optional[str] = None      # model precision pools
        self.kv_guard_layers: tuple = ()

    def describe_devices(self) -> List[List[str]]:
        """Each stage's shards' devices, as strings."""
        return [[str(d) for d in st.devices] for st in self.stages]

    def kv_pool_bytes(self, base_itemsize: int):
        """(resident, baseline) bytes of the paged pools (each kv head
        once), baseline at `base_itemsize` bytes a K/V element."""
        res = base = 0
        for st, caches in zip(self.stages, self.paged_caches or ()):
            r, b = st.kv_bytes(caches, base_itemsize)
            res, base = res + r, base + b
        return res, base

    # ---- host <-> device seam -------------------------------------------
    def _ints(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device).long()

    def _tables(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int32), device=self.device)

    def _embed(self, tokens, batch_extras=None):
        """Token embeddings (gemma's scale on a VLM), after a VLM's image
        prefix batch_extras["image_embeds"] (b, n_img, d)."""
        x = M._embed(self.cfg, self.stages[0].head_params,
                     self._ints(tokens))
        if self.cfg.num_image_tokens:
            img = torch.as_tensor(batch_extras["image_embeds"],
                                  device=self.device)
            x = torch.cat([img.to(x.dtype), x], dim=1)
        return x

    def _head(self, x) -> np.ndarray:
        """Logits of the last stage's rows x, copied to the host from the
        last stage's first device."""
        st = self.stages[-1]
        logits = M._head(self.cfg, st.head_params, x.to(st.device))
        return logits.float().cpu().numpy()

    def _last_rows(self, x, lens_t) -> torch.Tensor:
        """Row i's position lens_t[i] - 1 of x (m, P, d), as (m, 1, d)."""
        lens_t = lens_t.to(x.device)
        ridx = torch.arange(x.shape[0], device=x.device)
        return x[ridx, lens_t - 1][:, None]

    # ---- static batching ---------------------------------------------------
    @torch.inference_mode()
    def prefill(self, tokens: np.ndarray, *, kv_start=None,
                max_new: int = 32, batch_extras=None) -> np.ndarray:
        """Prompt pass of the whole batch `tokens` (b, s), left-padded
        (kv_start (b,): each row's first real index; None: no padding),
        into fresh contiguous caches of s + num_image_tokens + max_new
        positions (the sliding-window ring of a SWA model). batch_extras
        carries the modality stubs: whisper's ``enc_frames`` (b, se, d),
        through the encoder on the first stage, whose output every
        decoder layer attends to and caches as cross K/V; paligemma's
        ``image_embeds`` (b, n_img, d), the sequence's first positions.
        Without them such a model raises KeyError, as the reference does.
        Returns last-position logits (b, V)."""
        cfg = self.cfg
        tokens = np.asarray(tokens)
        b, s = tokens.shape
        total = s + cfg.num_image_tokens
        self.caches = None                  # free the old batch's first
        self.caches = [st.make_caches(b, total + max_new)
                       for st in self.stages]
        self._kv_start = None if kv_start is None else self._ints(kv_start)
        batch_extras = batch_extras or {}
        enc_out = None
        if cfg.is_encoder_decoder:
            enc_out = M._encoder_forward(cfg, self.stages[0].head_params,
                                         batch_extras["enc_frames"])
        x = self._embed(tokens, batch_extras)
        positions = torch.arange(total, device=self.device)[None].expand(
            b, total)
        x = M._add_positions(cfg, x, positions)
        valid = None
        if self._kv_start is not None:
            valid = (positions >= self._kv_start[:, None]).to(torch.int32)
        for si, st in enumerate(self.stages):
            x = st.prefill(x, self.caches[si], positions,
                           kv_start=self._kv_start, valid=valid,
                           enc_out=enc_out)
        self._pos = total
        return self._head(x[:, -1:])[:, 0]

    def _embed_decode_tokens(self, tokens, positions):
        """Single-token decode embedding (b, 1, d): the lookup, the
        family's scale, and sinusoidal positions (b,) where the
        architecture uses them."""
        x = M._embed(self.cfg, self.stages[0].head_params,
                     self._ints(tokens)[:, None])
        return M._add_positions(self.cfg, x, positions[:, None])

    @torch.inference_mode()
    def decode_step(self, tokens: np.ndarray) -> np.ndarray:
        """tokens (b,) at the batch's next position -> logits (b, V)."""
        tokens = np.asarray(tokens)
        pos = torch.tensor(self._pos, device=self.device)
        x = self._embed_decode_tokens(tokens, pos.expand(tokens.shape[0]))
        for si, st in enumerate(self.stages):
            x = st.decode(x, self.caches[si], pos, self._kv_start)
        self._pos += 1
        return self._head(x)[:, 0]

    def generate(self, tokens: np.ndarray, *, max_new: int,
                 kv_start=None, batch_extras=None) -> np.ndarray:
        """Greedy generation of the left-padded batch: (b, max_new) ids
        (``batch_extras``: the modality stubs, as in ``prefill``). The
        reference also decodes the last token, whose logits nobody reads;
        that step is skipped (the same tokens)."""
        logits = self.prefill(tokens, kv_start=kv_start, max_new=max_new,
                              batch_extras=batch_extras)
        out = []
        for step in range(max_new):
            nxt = logits.argmax(-1).astype(np.int32)
            out.append(nxt)
            if step + 1 < max_new:
                logits = self.decode_step(nxt)
        return np.stack(out, axis=1)

    # ---- slot mode (contiguous continuous batching) -----------------------
    def init_slot_caches(self, n_slots: int, max_len: int) -> None:
        """Per-stage contiguous caches whose n_slots rows are decode slots
        of max_len positions each."""
        if not slot_mode_supported(self.cfg):
            raise NotImplementedError(f"{self.cfg.name}: slot mode needs a "
                                      "uniform text decoder; use static "
                                      "batching")
        self.n_slots = n_slots
        self.slot_len = max_len
        self.slot_caches = None             # free the old pools first
        self.slot_caches = [st.make_caches(n_slots, max_len)
                            for st in self.stages]

    @torch.inference_mode()
    def insert_slots(self, tokens: np.ndarray, lens: np.ndarray,
                     slot_ids: Sequence[int]) -> np.ndarray:
        """Joint prefill of right-padded prompts `tokens` (b, P) with real
        lengths `lens` (b,): the first m = len(slot_ids) rows are real, rows
        beyond m are the batcher's shape padding and are dropped before any
        work. Each stage prefills into scratch caches of m rows and
        scatters them into pool slots slot_ids (the K/V past lens[i] are
        masked by kv_len in decode and overwritten as the slot decodes).
        Returns each row's last-real-token logits (m, V)."""
        m = len(slot_ids)
        tokens = np.asarray(tokens)[:m]
        lens_t = self._ints(np.asarray(lens)[:m])
        P = tokens.shape[1]
        x = self._embed(tokens)
        positions = torch.arange(P, device=self.device)[None].expand(m, P)
        valid = (positions < lens_t[:, None]).to(torch.int32)
        for si, st in enumerate(self.stages):
            scratch = st.make_caches(m, self.slot_len)
            x = st.prefill(x, scratch, positions, valid=valid, lens=lens_t)
            st.scatter_rows(self.slot_caches[si], scratch, slot_ids)
        return self._head(self._last_rows(x, lens_t))[:, 0]

    @torch.inference_mode()
    def decode_slots(self, tokens: np.ndarray,
                     positions: np.ndarray) -> np.ndarray:
        """One decode iteration over ALL slots: tokens (n_slots,) at
        per-slot positions (n_slots,). Free slots decode garbage that the
        batcher discards. Returns (n_slots, V)."""
        pos = self._ints(positions)
        x = self._embed(np.asarray(tokens)[:, None])
        for si, st in enumerate(self.stages):
            x = st.decode(x, self.slot_caches[si], pos)
        return self._head(x)[:, 0]

    # ---- paged slot mode ---------------------------------------------------
    def init_paged_caches(self, n_slots: int, max_len: int, *,
                          block_size: int = 16,
                          stage_blocks: Optional[Sequence[int]] = None,
                          kv_dtype: Optional[str] = None,
                          kv_guard_layers: Sequence[int] = ()) -> None:
        """Per-stage page pools. `stage_blocks[si]` is stage si's pool size
        in blocks (including the reserved null block); None sizes every
        stage for full occupancy (n_slots * max_len tokens). `kv_dtype`
        ("int8" / "fp8", or the model's own width) selects the pool
        precision, None the model's; `kv_guard_layers` pins those GLOBAL
        layer indices at model precision."""
        if not slot_mode_supported(self.cfg):
            raise NotImplementedError(f"{self.cfg.name}: paged slot mode "
                                      "needs a uniform text decoder")
        if max_len % block_size:
            raise ValueError(f"max_len {max_len} is not a multiple of "
                             f"block_size {block_size}")
        self.n_slots = n_slots
        self.slot_len = max_len
        self.block_size = block_size
        full = n_slots * (max_len // block_size) + 1
        if stage_blocks is None:
            stage_blocks = [full] * len(self.stages)
        self.stage_blocks = list(stage_blocks)
        if len(self.stage_blocks) != len(self.stages):
            raise ValueError("one pool size per stage")
        self.kv_dtype = kv_dtype
        self.kv_guard_layers = tuple(kv_guard_layers)
        self.paged_caches = None            # free the old pools first
        self.paged_caches = [
            st.make_paged_caches(nb, block_size, n_slots, kv_dtype=kv_dtype,
                                 kv_guard_layers=self.kv_guard_layers)
            for st, nb in zip(self.stages, self.stage_blocks)]

    @torch.inference_mode()
    def insert_slots_paged(self, tokens: np.ndarray, lens: np.ndarray,
                           slot_ids: Sequence[int],
                           stage_dest: Sequence[np.ndarray]) -> np.ndarray:
        """Joint right-padded prefill of prompts `tokens` (b, P) with real
        lengths `lens` (b,): the first m = len(slot_ids) rows are real, rows
        beyond m are the batcher's shape padding and are dropped before any
        work. Each stage's attention K/V rows go straight into its pages
        at ``stage_dest[si]`` ((m * max_blocks,) physical page per logical
        block, row-major; null entries absorb the padding); its recurrent
        layers scan each row's real steps (pads are identity steps) and
        write the final state into the row's slot. Returns each row's
        last-real-token logits (m, V)."""
        m = len(slot_ids)
        tokens = np.asarray(tokens)[:m]
        lens_t = self._ints(np.asarray(lens)[:m])
        P = tokens.shape[1]
        x = self._embed(tokens)
        positions = torch.arange(P, device=self.device)[None].expand(m, P)
        valid = (positions < lens_t[:, None]).to(torch.int32)
        for si, st in enumerate(self.stages):
            dest = self._ints(stage_dest[si])
            x = st.prefill(x, self.paged_caches[si], positions,
                           dest_blocks=dest, valid=valid, lens=lens_t,
                           slot_ids=slot_ids)
        return self._head(self._last_rows(x, lens_t))[:, 0]

    @torch.inference_mode()
    def context_slots_paged(self, tokens: np.ndarray, lens: np.ndarray,
                            q_start: np.ndarray,
                            stage_tables: Sequence[np.ndarray]) -> np.ndarray:
        """Context prefill of right-padded chunks `tokens` (m, C) whose
        row-i token j sits at absolute position q_start[i] + j: the cold
        suffix of a prompt whose prefix is resident (prefix caching), or
        one chunk of a long prompt (chunked prefill). Each chunk's K/V go
        into this stage's pages through `stage_tables[si]` (m, max_blocks)
        and attention reads the prior context back through the same table.
        Returns each row's last-real-token logits (m, V)."""
        if not context_mode_supported(self.cfg):
            raise NotImplementedError(f"{self.cfg.name}: the context path "
                                      "needs an attention-only stack")
        m, C = np.asarray(tokens).shape
        lens_t = self._ints(lens)
        starts = self._ints(q_start)
        positions = starts[:, None] + torch.arange(C, device=self.device)
        x = self._embed(tokens)
        for si, st in enumerate(self.stages):
            x = st.context_paged(x, self.paged_caches[si], positions, lens_t,
                                 self._tables(stage_tables[si]))
        return self._head(self._last_rows(x, lens_t))[:, 0]

    @torch.inference_mode()
    def copy_pages(self, stage_idx: int, src_blocks: Sequence[int],
                   dst_blocks: Sequence[int]) -> None:
        """Copy-on-write: duplicate page contents src -> dst in every layer
        of stage `stage_idx`, in place."""
        if not src_blocks:
            return
        self.stages[stage_idx].copy_pages(self.paged_caches[stage_idx],
                                          src_blocks, dst_blocks)

    # ---- KV migration (disaggregated prefill/decode) -----------------------
    # The wire format is per-GLOBAL-LAYER so the source and destination
    # pipelines may split their stages differently: stage si's single block
    # table addresses every one of ITS layers' page pools, but each layer
    # owns its own K/V arrays, so regrouping layers across stages is just a
    # different iteration order over the same per-layer payloads.

    @torch.inference_mode()
    def extract_kv_pages(self, stage_blocks: Sequence[Optional[Sequence[int]]]
                         ) -> List[dict]:
        """Gather the page CONTENTS of each stage's block list: returns
        ``layer_kv[l] = {"k","v"}`` of shape (n_blocks, block_size,
        kv_heads, head_dim), ALL the layer's kv heads whatever the stage's
        TP degree, for every global layer l, in layer order, as tensors on
        its stage's first device. ``stage_blocks[si]`` is the
        (ordered) physical block list of one request on stage si — whole
        blocks, so a partial tail block ships its masked rows rather than a
        ragged slice. Quantized pools ship at wire width with their
        ``k_scale`` / ``v_scale`` leaves: the one-byte payload is what
        crosses the link, so the modelled transfer bytes drop with the pool
        dtype. Attention-only stacks."""
        if self.paged_caches is None:
            raise RuntimeError("no paged caches to extract")
        return [lkv for si, st in enumerate(self.stages)
                for lkv in st.gather_pages(self.paged_caches[si],
                                           stage_blocks[si])]

    @torch.inference_mode()
    def scatter_kv_pages(self, stage_blocks: Sequence[Optional[Sequence[int]]],
                         layer_kv: Sequence[dict]) -> None:
        """Migrate-in: write per-layer page payloads (extract_kv_pages wire
        format, possibly from a pipeline with a DIFFERENT stage split) into
        this pipeline's pools at each stage's freshly allocated block list,
        in place, verbatim (no requantization), each shard of a TP stage
        taking its kv heads: the payload's source may have another TP
        degree. A ``None`` entry in
        ``stage_blocks`` SKIPS that stage (its layers' payload slices are
        discarded) — a cluster prefix fetch lands only in the stages that
        miss locally."""
        if self.paged_caches is None:
            raise RuntimeError("call init_paged_caches first")
        li = 0
        for si, st in enumerate(self.stages):
            n_layers = st.hi - st.lo
            if stage_blocks[si] is not None:
                st.scatter_pages(self.paged_caches[si], stage_blocks[si],
                                 layer_kv[li:li + n_layers])
            li += n_layers
        if li != len(layer_kv):
            raise ValueError(f"{len(layer_kv)} layer payloads for a "
                             f"{li}-layer pipeline")

    # ---- host page tier (device <-> host demotion/promotion) ---------------
    @torch.inference_mode()
    def extract_stage_pages(self, stage_idx: int, blocks: Sequence[int], *,
                            host: bool = False) -> List[dict]:
        """Gather stage `stage_idx`'s page contents for `blocks` — one
        ``{"k","v"[,"k_scale","v_scale"]}`` dict per layer OF THIS STAGE,
        at pool precision (quantized pages spill narrow). The single-stage
        slice of ``extract_kv_pages``: host-tier demotion is per stage
        because each stage's pool fills and evicts on its own clock.
        ``host=True`` (demotion) copies into host memory, pinned on the
        card; otherwise the payload stays on the device (a peer export)."""
        if self.paged_caches is None:
            raise RuntimeError("no paged caches to extract")
        return self.stages[stage_idx].gather_pages(
            self.paged_caches[stage_idx], blocks, host=host)

    @torch.inference_mode()
    def scatter_stage_pages(self, stage_idx: int, blocks: Sequence[int],
                            payload: Sequence[dict]) -> None:
        """Write ``extract_stage_pages`` payloads back into stage
        `stage_idx`'s pools at `blocks` — host -> device promotion. The
        payload re-lands verbatim (same pool precision it spilled at)."""
        if self.paged_caches is None:
            raise RuntimeError("call init_paged_caches first")
        self.stages[stage_idx].scatter_pages(self.paged_caches[stage_idx],
                                             blocks, payload)

    @torch.inference_mode()
    def decode_slots_paged(self, tokens: np.ndarray, positions: np.ndarray,
                           stage_tables: Sequence[np.ndarray]) -> np.ndarray:
        """One decode iteration over ALL slots through the paged caches.
        stage_tables[si]: (n_slots, max_blocks) block table of stage si
        (free slots have all-null rows and decode into the trash page).
        Returns (n_slots, V)."""
        pos = self._ints(positions)
        x = self._embed(np.asarray(tokens)[:, None])
        for si, st in enumerate(self.stages):
            x = st.decode_paged(x, self.paged_caches[si], pos,
                                self._tables(stage_tables[si]))
        return self._head(x)[:, 0]

    @torch.inference_mode()
    def verify_slots_paged(self, tokens: np.ndarray, q_len: np.ndarray,
                           q_start: np.ndarray,
                           stage_tables: Sequence[np.ndarray]) -> np.ndarray:
        """Speculative verification over ALL slots: tokens (n_slots, T) is
        each slot's candidate chunk (the bonus token plus its drafts,
        right-padded to T = k + 1), row i's candidate j at absolute position
        q_start[i] + j (the slot's committed length); q_len (n_slots,) real
        candidate counts. Rows of free / mid-prefill slots carry q_len 0
        and all-null tables, write into the trash page and come back as
        garbage the engine discards. Returns logits (n_slots, T, V) at
        every position: position j is the target's next-token distribution
        after candidate j. Attention-only stacks."""
        if not context_mode_supported(self.cfg):
            raise NotImplementedError(f"{self.cfg.name}: verification "
                                      "needs an attention-only stack")
        T = np.asarray(tokens).shape[1]
        lens_t = self._ints(q_len)
        positions = self._ints(q_start)[:, None] + torch.arange(
            T, device=self.device)
        x = self._embed(tokens)
        for si, st in enumerate(self.stages):
            x = st.verify_paged(x, self.paged_caches[si], positions, lens_t,
                                self._tables(stage_tables[si]))
        return self._head(x)
