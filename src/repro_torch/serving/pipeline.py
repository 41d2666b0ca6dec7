"""Asymmetric pipeline executor of the port (twin of
repro.serving.pipeline, Contribution 1, §3.2): the static whole-batch path
(``generate``), contiguous slot mode and paged slot mode.

Each stage owns its own contiguous span of layers and, in the plan, its own
tensor-parallel device group. The port runs every stage on the one card it
is given: the plan's TP degree collapses, as the reference engine collapses
a TP group onto fewer physical devices (numerically identical — TP only
changes layout). Stages stay separate objects with their own layer ranges
and their own page pools, sized independently, so the asymmetric split is
real.

A stage's attention layers keep page pools, its recurrent layers (Mamba,
mLSTM, sLSTM) one row of state per slot; a stage may hold no attention
layer at all (``has_attn``).

The public methods keep the reference's numpy-in / numpy-out signatures:
they are the whole seam the batcher (serving.continuous) drives. Logits come
back to the host as float32 numpy arrays every call, as in the reference.
Page payloads (KV migration, the host tier, cluster prefix fetches) are the
exception: they are torch tensors at pool precision (numpy has no bf16 or
fp8), on the card, or in pinned host memory for the host tier.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ATTN, ModelConfig
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
    """One pipeline stage: layers [lo, hi) on `device`."""

    def __init__(self, cfg: ModelConfig, params, lo: int, hi: int, *,
                 device: torch.device, dtype: torch.dtype, is_first: bool,
                 is_last: bool):
        self.cfg = cfg
        self.lo, self.hi = lo, hi
        self.is_first, self.is_last = is_first, is_last
        self.device = device
        self.dtype = dtype
        self.kinds = [cfg.layer_kind(i) for i in range(lo, hi)]

        def place(tree):
            # an int8 weight keeps its int8 payload and float32 scales, a
            # Mamba layer its float32 dynamics
            if is_quantized(tree):
                return {k: v.to(device=device) for k, v in tree.items()}
            return {k: place(v) if isinstance(v, dict)
                    else v.to(device=device,
                              dtype=torch.float32 if k in FP32_LEAVES
                              else dtype)
                    for k, v in tree.items()}
        self.layer_params = [place(M.slice_layer_params(cfg, params, i))
                             for i in range(lo, hi)]
        self.head_params = None
        if is_first or is_last:
            self.head_params = place(
                {n: params[n] for n in ("embed", "final_norm", "lm_head")})

    @property
    def has_attn(self) -> bool:
        return ATTN in self.kinds

    def make_caches(self, batch: int, max_len: int):
        """Per-layer contiguous caches of `batch` rows: attention K/V of
        max_len positions (the sliding-window ring of min(max_len, window)
        slots), recurrent state rows."""
        return [M.init_layer_cache(self.cfg, i, batch, max_len,
                                   dtype=self.dtype, device=self.device)
                for i in range(self.lo, self.hi)]

    def make_paged_caches(self, n_blocks: int, block_size: int,
                          n_slots: int, *, kv_dtype: Optional[str] = None,
                          kv_guard_layers: Sequence[int] = ()):
        """Per-layer caches: page pools for the attention layers, which
        share ONE block-id space of `n_blocks` blocks (one table addresses
        every layer), and `n_slots` rows of state for the recurrent
        layers.
        `kv_dtype` selects the pool precision (None = the model's);
        `kv_guard_layers` are GLOBAL layer indices kept at model
        precision."""
        return [M.init_layer_paged_cache(self.cfg, i, n_blocks, block_size,
                                         dtype=self.dtype, device=self.device,
                                         n_slots=n_slots, kv_dtype=kv_dtype,
                                         kv_guard_layers=kv_guard_layers)
                for i in range(self.lo, self.hi)]

    def prefill(self, x, caches, positions, *, dest_blocks=None,
                kv_start=None, valid=None, lens=None, slot_ids=None):
        """The stage's layers over whole prompts (``M.apply_sublayer_seq``):
        attention K/V into pages through dest_blocks, or into the
        contiguous `caches`."""
        for kind, lp, sc in zip(self.kinds, self.layer_params, caches):
            x = M.apply_sublayer_seq(self.cfg, kind, lp, x, sc,
                                     positions=positions,
                                     dest_blocks=dest_blocks,
                                     kv_start=kv_start, valid=valid,
                                     lens=lens, slot_ids=slot_ids)
        return x

    def decode(self, x, caches, pos, kv_start=None):
        """One decode token per row against the contiguous `caches`."""
        for kind, lp, sc in zip(self.kinds, self.layer_params, caches):
            x = M.apply_sublayer_decode(self.cfg, kind, lp, x, sc, pos=pos,
                                        kv_start=kv_start)
        return x

    def decode_paged(self, x, caches, pos, block_tables):
        for kind, lp, sc in zip(self.kinds, self.layer_params, caches):
            x = M.apply_sublayer_decode_paged(self.cfg, kind, lp, x, sc,
                                              pos=pos,
                                              block_tables=block_tables)
        return x

    def context_paged(self, x, caches, positions, q_len, block_tables):
        for kind, lp, sc in zip(self.kinds, self.layer_params, caches):
            x = M.apply_sublayer_context_paged(
                self.cfg, kind, lp, x, sc, positions=positions, q_len=q_len,
                block_tables=block_tables)
        return x

    def verify_paged(self, x, caches, positions, q_len, block_tables):
        for kind, lp, sc in zip(self.kinds, self.layer_params, caches):
            x = M.apply_sublayer_verify_paged(
                self.cfg, kind, lp, x, sc, positions=positions, q_len=q_len,
                block_tables=block_tables)
        return x


class AsymmetricPipeline:
    """A full model replica as a chain of StageExecutors on one device."""

    def __init__(self, cfg: ModelConfig, params, stage_layers: Sequence[int],
                 *, device="cuda", dtype: Optional[torch.dtype] = None):
        if sum(stage_layers) != cfg.num_layers:
            raise ValueError(f"stage layers {list(stage_layers)} do not sum "
                             f"to {cfg.num_layers}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = M.param_dtype(cfg, dtype)
        self.stages: List[StageExecutor] = []
        lo = 0
        for si, nl in enumerate(stage_layers):
            self.stages.append(StageExecutor(
                cfg, params, lo, lo + nl, device=self.device,
                dtype=self.dtype, is_first=(si == 0),
                is_last=(si == len(stage_layers) - 1)))
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

    # ---- host <-> device seam -------------------------------------------
    def _ints(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device).long()

    def _tables(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int32), device=self.device)

    def _embed(self, tokens):
        return M._embed(self.cfg, self.stages[0].head_params,
                        self._ints(tokens))

    def _head(self, x) -> np.ndarray:
        logits = M._head(self.cfg, self.stages[-1].head_params, x)
        return logits.float().cpu().numpy()

    # ---- static batching ---------------------------------------------------
    @torch.inference_mode()
    def prefill(self, tokens: np.ndarray, *, kv_start=None,
                max_new: int = 32) -> np.ndarray:
        """Prompt pass of the whole batch `tokens` (b, s), left-padded
        (kv_start (b,): each row's first real index; None: no padding),
        into fresh contiguous caches of s + max_new positions (the sliding-
        window ring of a SWA model). Returns last-position logits (b, V)."""
        tokens = np.asarray(tokens)
        b, s = tokens.shape
        self.caches = None                  # free the old batch's first
        self.caches = [st.make_caches(b, s + max_new) for st in self.stages]
        self._kv_start = None if kv_start is None else self._ints(kv_start)
        x = self._embed(tokens)
        positions = torch.arange(s, device=self.device)[None].expand(b, s)
        valid = None
        if self._kv_start is not None:
            valid = (positions >= self._kv_start[:, None]).to(torch.int32)
        for si, st in enumerate(self.stages):
            x = st.prefill(x, self.caches[si], positions,
                           kv_start=self._kv_start, valid=valid)
        self._pos = s
        return self._head(x[:, -1:])[:, 0]

    @torch.inference_mode()
    def decode_step(self, tokens: np.ndarray) -> np.ndarray:
        """tokens (b,) at the batch's next position -> logits (b, V)."""
        x = self._embed(np.asarray(tokens)[:, None])
        pos = torch.tensor(self._pos, device=self.device)
        for si, st in enumerate(self.stages):
            x = st.decode(x, self.caches[si], pos, self._kv_start)
        self._pos += 1
        return self._head(x)[:, 0]

    def generate(self, tokens: np.ndarray, *, max_new: int,
                 kv_start=None) -> np.ndarray:
        """Greedy generation of the left-padded batch: (b, max_new) ids.
        The reference also decodes the last token, whose logits nobody
        reads; that step is skipped (the same tokens)."""
        logits = self.prefill(tokens, kv_start=kv_start, max_new=max_new)
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
            for pool, rows in zip(self.slot_caches[si], scratch):
                M.scatter_cache_rows(pool, rows, slot_ids, batch_axis=0)
        ridx = torch.arange(m, device=self.device)
        return self._head(x[ridx, lens_t - 1][:, None])[:, 0]

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
        ridx = torch.arange(m, device=self.device)
        return self._head(x[ridx, lens_t - 1][:, None])[:, 0]

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
        ridx = torch.arange(m, device=self.device)
        return self._head(x[ridx, lens_t - 1][:, None])[:, 0]

    @torch.inference_mode()
    def copy_pages(self, stage_idx: int, src_blocks: Sequence[int],
                   dst_blocks: Sequence[int]) -> None:
        """Copy-on-write: duplicate page contents src -> dst in every layer
        of stage `stage_idx`, in place."""
        if not src_blocks:
            return
        M.copy_cache_pages(self.paged_caches[stage_idx],
                           self._ints(src_blocks), self._ints(dst_blocks))

    # ---- KV migration (disaggregated prefill/decode) -----------------------
    # The wire format is per-GLOBAL-LAYER so the source and destination
    # pipelines may split their stages differently: stage si's single block
    # table addresses every one of ITS layers' page pools, but each layer
    # owns its own K/V arrays, so regrouping layers across stages is just a
    # different iteration order over the same per-layer payloads.

    def _gather_pages(self, c: dict, blocks: Sequence[int],
                      host: bool = False) -> dict:
        """One layer's payload: its K/V pages (and scale pages on a
        quantized pool) at `blocks`, copied out of the pool at pool
        precision. ``host`` puts the copy in host memory, pinned when the
        pool is on the card (one synchronous copy, so the payload is
        complete when this returns)."""
        if "k" not in c or "v" not in c:
            raise NotImplementedError("page payloads cover attention-only "
                                      "stacks (a recurrent layer's state "
                                      "has no pages)")
        idx = torch.as_tensor(np.asarray(blocks, np.int64),
                              device=self.device)
        out = {}
        for n in ("k", "v") + KV_SCALE_LEAVES:
            if n not in c:
                continue
            t = bits(c[n]).index_select(0, idx).view(c[n].dtype)
            if host and t.is_cuda:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                bits(h).copy_(bits(t))
                t = h
            out[n] = t
        return out

    def _scatter_pages(self, caches: Sequence[dict], blocks: Sequence[int],
                       payload: Sequence[dict]) -> None:
        """Write per-layer payloads into `caches`' pools at `blocks`, in
        place; a host payload is copied to the card first (synchronously:
        the host buffer may be dropped as soon as this returns)."""
        idx = torch.as_tensor(np.asarray(blocks, np.int64),
                              device=self.device)
        for c, lkv in zip(caches, payload):
            if set(lkv) != {n for n in ("k", "v") + KV_SCALE_LEAVES
                            if n in c}:
                raise ValueError(f"payload leaves {sorted(lkv)} do not "
                                 f"match the pool's {sorted(c)}")
            for n, a in lkv.items():
                if a.dtype != c[n].dtype:
                    raise ValueError(f"payload {n} is {a.dtype}, the pool "
                                     f"{c[n].dtype}: pages land verbatim")
                bits(c[n]).index_copy_(0, idx, bits(a).to(self.device))

    @torch.inference_mode()
    def extract_kv_pages(self, stage_blocks: Sequence[Optional[Sequence[int]]]
                         ) -> List[dict]:
        """Gather the page CONTENTS of each stage's block list: returns
        ``layer_kv[l] = {"k","v"}`` of shape (n_blocks, block_size,
        kv_heads, head_dim) for every global layer l, in layer order, as
        tensors on this pipeline's device. ``stage_blocks[si]`` is the
        (ordered) physical block list of one request on stage si — whole
        blocks, so a partial tail block ships its masked rows rather than a
        ragged slice. Quantized pools ship at wire width with their
        ``k_scale`` / ``v_scale`` leaves: the one-byte payload is what
        crosses the link, so the modelled transfer bytes drop with the pool
        dtype. Attention-only stacks."""
        if self.paged_caches is None:
            raise RuntimeError("no paged caches to extract")
        return [self._gather_pages(c, stage_blocks[si])
                for si in range(len(self.stages))
                for c in self.paged_caches[si]]

    @torch.inference_mode()
    def scatter_kv_pages(self, stage_blocks: Sequence[Optional[Sequence[int]]],
                         layer_kv: Sequence[dict]) -> None:
        """Migrate-in: write per-layer page payloads (extract_kv_pages wire
        format, possibly from a pipeline with a DIFFERENT stage split) into
        this pipeline's pools at each stage's freshly allocated block list,
        in place, verbatim (no requantization). A ``None`` entry in
        ``stage_blocks`` SKIPS that stage (its layers' payload slices are
        discarded) — a cluster prefix fetch lands only in the stages that
        miss locally."""
        if self.paged_caches is None:
            raise RuntimeError("call init_paged_caches first")
        li = 0
        for si, st in enumerate(self.stages):
            n_layers = st.hi - st.lo
            if stage_blocks[si] is not None:
                self._scatter_pages(self.paged_caches[si], stage_blocks[si],
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
        return [self._gather_pages(c, blocks, host=host)
                for c in self.paged_caches[stage_idx]]

    @torch.inference_mode()
    def scatter_stage_pages(self, stage_idx: int, blocks: Sequence[int],
                            payload: Sequence[dict]) -> None:
        """Write ``extract_stage_pages`` payloads back into stage
        `stage_idx`'s pools at `blocks` — host -> device promotion. The
        payload re-lands verbatim (same pool precision it spilled at)."""
        if self.paged_caches is None:
            raise RuntimeError("call init_paged_caches first")
        self._scatter_pages(self.paged_caches[stage_idx], blocks, payload)

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
