"""Continuous (iteration-level) batching — the port of
repro.serving.continuous: the SlotEngine, its contiguous executors
(``ContinuousBatcher`` on the whole model, ``PipelineBatcher`` on an
asymmetric pipeline with per-stage slot pools) and the paged
``PagedPipelineBatcher`` with these paths:

  * cold joint prefill: admitted prompts are prefilled JOINTLY (one
    right-padded batch with per-row real lengths) and their K/V land in
    freshly allocated pages (``_insert_batch`` / ``_prefill_insert``);
  * decode, growth and preemption: every iteration decodes all slots
    jointly with PER-SLOT positions, tables grow one block at a time, and a
    dry pool preempts the youngest slot by recompute (``_before_decode``,
    ``_ensure_blocks``, ``_preempt``, ``_on_slot_free``, ``_decode_all``);
  * prefix caching and chunked prefill: prompts run through the paged
    CONTEXT path, aliasing the longest indexed prefix and prefilling only
    the cold suffix, in chunks interleaved with decode (``_setup_slot``,
    ``_match_slot``, ``_prepare_chunk``, ``_prefill_step``,
    ``_dispatch_chunks``, ``_register_prefix``);
  * speculative decoding: each decode iteration becomes propose, verify
    every slot's candidate chunk in one multi-token step, accept the
    longest prefix matching the target's argmax chain and roll back the
    speculative pages past it (``_spec_iteration``);
  * quantized pools: ``kv_dtype="int8"`` / ``"fp8"`` stores every page
    pool (but the guard layers') as one-byte payloads with per-token
    scales, written quantized by every path above and read through the
    quantized paged kernels (``_ensure_device_caches``,
    ``_account_kv_bytes``);
  * recurrent layers (Jamba's Mamba + attention, xlstm-125m's mLSTM and
    sLSTM): the cold joint prefill writes each recurrent layer's final
    state into the slot's rows beside the attention pages, decode steps it, and a preempted request's re-prefill
    rewrites it. As in the reference, prefix caching, chunked prefill,
    quantized pools and speculation warn and serve without themselves on
    such a stack (a recurrent state has no per-block piece to share,
    resume, quantize or roll back).

  * disaggregated prefill/decode (``role``): a prefill replica hands
    every prefill-complete slot to a decode replica as a ``KVMigration``
    (its pages, cached length and last logits), and the decode replica
    resumes it where the prefill stopped (``_migrate_ready``,
    ``migrate_in``, ``_place_migrations``);
  * the host page tier (``host_blocks``): a prefix block the index evicts
    spills its pages to a ``HostPagePool`` in host memory and a later
    match promotes them back (``_make_spill``, ``_materialize_hash``);
  * the cluster prefix directory (``attach_cluster``): a prefix resident
    only on a peer replica is fetched from it over the modelled KV link
    (``export_prefix_block``, ``_materialize_hash``);
  * online rescheduling: a decoding slot moves to another replica mid-
    decode with its pages, sampling state and emitted tokens
    (``extract_live_slots``, the live branch of ``_place_migrations``),
    and a killed replica releases everything in flight and hands its
    requests back for a cold re-prefill elsewhere (``evacuate``);
  * KVSAN (``kvsan=True``): every pool's page lifecycle shadowed and
    audited at each iteration boundary (``_kvsan_audit``);
  * tracing: a live ``Tracer`` in ``self.tracer`` records the lifecycle
    spans, and ``metrics_gauges`` the pools' occupancy.

The host logic is the reference's, line for line where it can be, so both
engines make the same admission, allocation, preemption, migration and
tier decisions and the same ServeStats counters and trace events come
out.
"""
from __future__ import annotations

import dataclasses
import heapq
import warnings
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models.quant import kv_is_quantized
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serving.block_manager import (BlockPool, BlockTable,
                                               HostPagePool, PrefixIndex,
                                               blocks_for_tokens,
                                               chunk_hashes)
from repro_torch.serving.disagg import KVLink, KVMigration
from repro_torch.serving.pipeline import (context_mode_supported,
                                          slot_mode_supported)
from repro_torch.serving.loop import (ServeStats, VirtualClock, WallClock,
                                     run_serve_loop)
from repro_torch.serving.request import Request
from repro_torch.serving.spec import SpecConfig, greedy_accept


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    pos: int = 0               # next write position (tokens cached so far)
    remaining: int = 0
    out: Optional[list] = None
    seq: int = 0               # admission order (preemption victims)
    # incremental-prefill state (prefix caching / chunked prefill): tokens
    # of the prompt not yet prefilled; None once decode can start
    pending: Optional[np.ndarray] = None
    hashes: Optional[list] = None   # full-block chunk hashes of the prompt
    matched: bool = False           # prefix lookup ran (lazily, first chunk)

    @property
    def free(self) -> bool:
        return self.req is None

    @property
    def decoding(self) -> bool:
        """Occupied and past prefill: participates in decode iterations."""
        return self.req is not None and self.pending is None


class SlotEngine:
    """Slot bookkeeping + the joint insert/decode iteration. Subclasses
    provide:

      _prefill_insert(toks (b,P), lens (b,), slot_ids) -> logits (m, V)
          where m = len(slot_ids) <= b; rows beyond m are shape padding
      _decode_all(toks (n_slots,), pos (n_slots,))     -> logits (n_slots, V)
    """

    def __init__(self, *, n_slots: int, max_len: int, vocab_size: int,
                 pad_id: int = 0, virtual_step_cost: float = 1.0):
        self.n_slots = n_slots
        self.max_len = max_len
        self.pad_id = pad_id
        self.virtual_step_cost = virtual_step_cost
        # the Router (or a test) swaps in a live Tracer; the null default
        # keeps every emission site a single attribute check
        self.tracer = NULL_TRACER
        self.replica_id = 0
        self.slots = [_Slot() for _ in range(n_slots)]
        self._queue: Deque[Request] = deque()
        self._last_logits = np.zeros((n_slots, vocab_size), np.float32)
        self.rejected = 0          # oversized requests turned away
        self.preemptions = 0       # slots recomputed after eviction
        self._admit_seq = 0

    # ---- slot state ------------------------------------------------------
    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s.free]

    @property
    def active(self) -> bool:
        return any(not s.free for s in self.slots)

    # ---- replica port (serving.loop) -------------------------------------
    def capacity(self, now: float) -> int:
        return max(len(self.free_slots()) - len(self._queue), 0)

    def load(self, now: float) -> float:
        return (self.n_slots - len(self.free_slots())) + len(self._queue)

    def admit(self, reqs: Sequence[Request], now: float) -> None:
        self._queue.extend(reqs)

    def busy(self, now: float) -> bool:
        return bool(self._queue) or self.active

    def inflight(self) -> int:
        return len(self._queue) + (self.n_slots - len(self.free_slots()))

    def next_event(self, now: float):
        return None                # compute worker: work runs when busy

    def run_iteration(self, now: float):
        """Insert buffered admissions, then one joint decode iteration."""
        comps = []
        free = self.free_slots()
        if self._queue and free:
            batch = []
            while self._queue and len(batch) < len(free):
                r = self._queue[0]
                # a request that can never fit this engine is rejected
                # alone (empty output, ServeStats.rejected) instead of
                # crashing the loop and losing every in-flight request
                if not self._fits(r):
                    self._queue.popleft()
                    self.rejected += 1
                    warnings.warn(
                        f"request {r.rid}: prompt {len(r.prompt)} + "
                        f"max_new {r.max_new_tokens} cannot fit this "
                        "engine; rejected with empty output")
                    comps.append((r, np.zeros(0, np.int32), None))
                    continue
                # admissible later but not right now (not enough free
                # blocks yet): keep it queued, FIFO order intact
                if not self._can_admit(r, batch):
                    break
                self._queue.popleft()
                batch.append(r)
            if batch:
                self._insert_batch(batch, free[:len(batch)])
        done = self._step(now) if self.active else []
        comps.extend((req, np.asarray(out, np.int32), None)
                     for req, out in done)
        return comps, self.virtual_step_cost

    # ---- admission / paging hooks -------------------------------------------
    def _fits(self, r: Request) -> bool:
        return len(r.prompt) + r.max_new_tokens <= self.max_len - 1

    def _can_admit(self, r: Request, batch: Sequence[Request]) -> bool:
        return True

    def _step(self, now: float):
        return self._decode_iteration(now)

    def _before_decode(self) -> None:
        pass

    def _on_slot_free(self, i: int) -> None:
        pass

    # ---- engine internals ------------------------------------------------
    def _insert_batch(self, reqs: Sequence[Request],
                      slot_ids: Sequence[int]) -> None:
        m = len(reqs)
        lens = np.asarray([len(r.prompt) for r in reqs], np.int32)
        assert int(lens.max()) < self.max_len, "prompt exceeds slot length"
        # the reference buckets both shape axes (width to multiples of 16,
        # row count to a power of two) for its jit; the same padded width
        # keeps the two engines' prefill inputs identical
        P = min(-(-int(lens.max()) // 16) * 16, self.max_len - 1)
        m_pad = min(1 << (m - 1).bit_length(), self.n_slots)
        toks = np.full((m_pad, P), self.pad_id, np.int32)
        plens = np.ones((m_pad,), np.int32)
        plens[:m] = lens
        for i, r in enumerate(reqs):
            toks[i, :lens[i]] = r.prompt                   # right pad
        logits = self._prefill_insert(toks, plens, list(slot_ids))
        if self.tracer.enabled:
            # one-shot joint prefill: every admitted prompt completes its
            # prefill within this iteration
            ntok = int(lens.sum())
            self.tracer.complete(
                "prefill",
                self.virtual_step_cost
                * getattr(self, "prefill_token_cost", 0.0) * ntok,
                pid=self.replica_id, tokens=ntok, slots=m)
            for r in reqs:
                self.tracer.mark(r.rid, "prefill_finish",
                                 self.tracer.now())
        for i, (r, slot) in enumerate(zip(reqs, slot_ids)):
            self._last_logits[slot] = np.asarray(logits[i])
            self.slots[slot] = _Slot(req=r, pos=int(lens[i]),
                                     remaining=r.max_new_tokens, out=[],
                                     seq=self._admit_seq)
            self._admit_seq += 1

    def _decode_iteration(self, now: float = 0.0):
        self._before_decode()      # grow tables, maybe preempt
        toks = np.zeros((self.n_slots,), np.int32)
        pos = np.zeros((self.n_slots,), np.int32)
        n_dec = 0
        for i, s in enumerate(self.slots):
            if s.decoding:         # mid-prefill slots sit this one out
                toks[i] = int(self._last_logits[i].argmax())
                pos[i] = s.pos
                n_dec += 1
        logits = self._decode_all(toks, pos)
        if self.tracer.enabled and n_dec:
            # one joint decode step; its virtual cost is the flat
            # iteration cost whatever the batch width
            self.tracer.complete("decode", self.virtual_step_cost, ts=now,
                                 pid=self.replica_id, tokens=n_dec)
        done = []
        for i, s in enumerate(self.slots):
            if not s.decoding:
                continue
            s.out.append(int(toks[i]))
            if len(s.out) == 1:
                # first-wins: a preempt-recompute re-produces the stream,
                # but the client saw the first token at the first emission
                # (trace marks share this discipline)
                if s.req.first_token_time is None:
                    s.req.first_token_time = now
                self.tracer.mark(s.req.rid, "first_token", now)
            s.pos += 1
            s.remaining -= 1
            self._last_logits[i] = logits[i]
            if s.remaining <= 0 or s.pos >= self.max_len - 1:
                done.append((s.req, s.out))
                self._on_slot_free(i)
                self.slots[i] = _Slot()
        return done

    def _prefill_insert(self, toks, lens, slot_ids):
        raise NotImplementedError

    def _decode_all(self, toks, pos):
        raise NotImplementedError

    def serve(self, requests: Sequence[Request], *, deadline: float,
              realtime: bool = False) -> ServeStats:
        """Replays a workload on this replica alone: on the virtual clock
        (deterministic latencies in iteration units), or the wall clock."""
        return run_serve_loop([self], requests, deadline=deadline,
                              clock=WallClock() if realtime
                              else VirtualClock(),
                              tracer=(self.tracer if self.tracer.enabled
                                      else None))

    # seed-API shims (tests, notebooks) ------------------------------------
    def insert(self, req: Request) -> int:
        """Immediate single insert; returns the slot index."""
        free = self.free_slots()
        if not free:
            raise RuntimeError("no free slot")
        self._insert_batch([req], free[:1])
        return free[0]

    def step(self) -> Dict[int, List[int]]:
        """One engine step (prefill chunks where pending, then the joint
        decode — identical to what run_iteration drives). Returns
        {rid: finished tokens}."""
        return {req.rid: out for req, out in self._step(0.0)}


class ContinuousBatcher(SlotEngine):
    """Slot-based continuous batching on the whole model at once
    (``models.model.prefill`` / ``decode_step`` on one contiguous cache
    whose batch rows are the slots); ``PipelineBatcher`` is the
    asymmetric-pipeline variant. ``params`` lie on the device to serve
    on."""

    def __init__(self, cfg: ModelConfig, params, *, n_slots: int = 8,
                 max_len: int = 256, pad_id: int = 0,
                 virtual_step_cost: float = 1.0):
        if not slot_mode_supported(cfg):
            raise NotImplementedError(f"{cfg.name}: slot mode needs a "
                                      "uniform text decoder; use static "
                                      "batching")
        super().__init__(n_slots=n_slots, max_len=max_len,
                         vocab_size=cfg.vocab_size, pad_id=pad_id,
                         virtual_step_cost=virtual_step_cost)
        self.cfg = cfg
        self.params = params
        emb = params["embed"]
        self._cache_kw = dict(dtype=emb.dtype, device=emb.device)
        self.cache = M.init_cache(cfg, n_slots, max_len, **self._cache_kw)

    @torch.inference_mode()
    def _prefill_insert(self, toks, lens, slot_ids):
        m = len(slot_ids)          # rows beyond m are shape padding
        scratch = M.init_cache(self.cfg, m, self.max_len, **self._cache_kw)
        logits, scratch = M.prefill(self.cfg, self.params,
                                    {"tokens": np.asarray(toks)[:m]},
                                    scratch, lens=np.asarray(lens)[:m])
        M.scatter_cache_rows(self.cache, scratch, slot_ids)
        return logits.float().cpu().numpy()

    @torch.inference_mode()
    def _decode_all(self, toks, pos):
        logits, _ = M.decode_step(self.cfg, self.params, toks, self.cache,
                                  pos)
        return logits.float().cpu().numpy()


class PipelineBatcher(SlotEngine):
    """Slot-based continuous batching over an ``AsymmetricPipeline``
    replica with contiguous per-stage cache pools (``cache_layout=
    "contiguous"``): a joint right-padded insert prefill and one joint
    decode iteration over every slot at per-slot positions."""

    def __init__(self, pipeline, *, n_slots: int = 8, max_len: int = 256,
                 pad_id: int = 0, virtual_step_cost: float = 1.0):
        if not slot_mode_supported(pipeline.cfg):
            raise NotImplementedError(f"{pipeline.cfg.name}: slot mode "
                                      "needs a uniform text decoder; use "
                                      "static batching")
        super().__init__(n_slots=n_slots, max_len=max_len,
                         vocab_size=pipeline.cfg.vocab_size, pad_id=pad_id,
                         virtual_step_cost=virtual_step_cost)
        self.pipeline = pipeline

    def _prefill_insert(self, toks, lens, slot_ids):
        # the pools are allocated on first use, so an engine that only
        # generates never pays for them
        p = self.pipeline
        if (p.slot_caches is None or p.n_slots != self.n_slots
                or p.slot_len != self.max_len):
            p.init_slot_caches(self.n_slots, self.max_len)
        return p.insert_slots(toks, lens, slot_ids)

    def _decode_all(self, toks, pos):
        return self.pipeline.decode_slots(toks, pos)


class PagedPipelineBatcher(SlotEngine):
    """Continuous batching over an ``AsymmetricPipeline`` with a PAGED KV
    cache: each stage owns a block pool sized independently
    (``stage_blocks``, the asymmetric-capacity point), requests hold
    per-stage BlockTables, admission needs free blocks for the prompt plus
    headroom rather than a worst-case ``max_len`` row, decode grows tables
    one block at a time, and a dry pool preempts the youngest slot by
    recompute (blocks freed, request requeued at the front; greedy decode
    regenerates the same tokens).

    ``prefix_caching=True``: each stage keeps a ``PrefixIndex``; admission
    aliases a new prompt's longest indexed prefix and prefills only the
    cold suffix through the paged context path; a write landing in a
    still-shared block copies it first. ``prefill_chunk=N`` splits any
    prefill longer than N tokens into N-token chunks, one per iteration.
    ``prefill_token_cost`` (virtual clock) charges each prefilled token
    that fraction of an iteration.

    ``spec`` (a ``serving.spec.SpecConfig``) turns on speculative
    decoding: a proposer guesses up to ``spec.k`` candidates per slot, the
    target verifies the bonus token plus all candidates in ONE multi-token
    step (``pipeline.verify_slots_paged``), greedy acceptance commits 1 to
    k + 1 tokens, and the pages past the committed length go back to the
    pool (``BlockTable.truncate``). The committed stream is the same as
    plain greedy decode's; only the step count changes. Needs an
    attention-only stack.

    ``kv_dtype`` ("int8" / "fp8", or the model's own width; None = the
    model's) sets the page pools' precision and ``kv_guard_layers`` the
    GLOBAL layer indices kept at model precision; ServeStats then reports
    the pools' bytes (``kv_bytes_resident``, scales included) and what they
    save against model-precision pools (``kv_bytes_saved``).

    ``host_blocks > 0`` adds a HOST-MEMORY PAGE TIER (needs prefix
    caching): ``PrefixIndex`` eviction under pool pressure DEMOTES a
    prefix block's page payload into a per-stage ``HostPagePool`` (at
    pool precision, in pinned host memory on the card) instead of
    deleting it, and a later prompt that matches past the device-resident
    prefix PROMOTES pages back into fresh device blocks, block by block.
    ``host_swap_cost`` (virtual clock) charges each block moved across the
    device<->host boundary that fraction of an iteration.

    ``attach_cluster`` (serving.cluster_kv.wire_cluster_prefix) joins a
    CLUSTER PREFIX DIRECTORY: the replica publishes its (hash -> tier)
    residency, and a prompt whose prefix lives only on a PEER replica
    fetches those pages in the ``KVMigration`` wire format, charged at
    ``KVLink.delay`` on the serving clock, before falling back to cold
    prefill.

    ``role`` splits the two inference phases across replicas
    (serving.disagg): "both" (colocated, the default), "prefill" (a slot
    whose prompt is fully cached is EXTRACTED — pages, cached length and
    last logits — and handed to ``self.dispatcher`` instead of decoding)
    or "decode" (no fresh arrivals; migrations land in free slots once
    their transfer delay elapses and resume decode from the migrated
    pages and logits). Needs an attention-only stack.

    ``kvsan=True`` serves under the KVSAN page-lifecycle sanitizer
    (repro_torch.analysis.kvsan): pure observation, leaks counted in
    ``kvsan_leaks``.
    """

    def __init__(self, pipeline, *, n_slots: int = 8, max_len: int = 256,
                 block_size: int = 16,
                 stage_blocks: Optional[Sequence[int]] = None,
                 admit_headroom: Optional[int] = None, pad_id: int = 0,
                 virtual_step_cost: float = 1.0,
                 prefix_caching: bool = False, prefill_chunk: int = 0,
                 prefill_token_cost: float = 0.0,
                 host_blocks: int = 0, host_swap_cost: float = 0.0,
                 role: str = "both", replica_id: int = 0,
                 spec: Optional[SpecConfig] = None,
                 kv_dtype: Optional[str] = None,
                 kv_guard_layers: Sequence[int] = (),
                 kvsan: bool = False):
        if not slot_mode_supported(pipeline.cfg):
            raise NotImplementedError(f"{pipeline.cfg.name}: slot mode "
                                      "needs a uniform text decoder")
        if max_len % block_size:
            raise ValueError(f"max_len {max_len} is not a multiple of "
                             f"block_size {block_size}")
        if role not in ("both", "prefill", "decode"):
            raise ValueError(f"role {role!r}")
        if role != "both" and not context_mode_supported(pipeline.cfg):
            raise NotImplementedError(
                "disaggregation needs an attention-only stack (recurrent "
                "running state has no pages to migrate)")
        if (prefix_caching or prefill_chunk) \
                and not context_mode_supported(pipeline.cfg):
            warnings.warn(
                f"{pipeline.cfg.name}: prefix caching / chunked prefill "
                "need an attention-only stack (recurrent state has no "
                "per-block identity); serving without them", stacklevel=2)
            prefix_caching, prefill_chunk = False, 0
        super().__init__(n_slots=n_slots, max_len=max_len,
                         vocab_size=pipeline.cfg.vocab_size, pad_id=pad_id,
                         virtual_step_cost=virtual_step_cost)
        self.pipeline = pipeline
        self.replica_id = replica_id
        # quantized pools need the paged context / verify write paths,
        # which exist for attention-only stacks only
        if kv_dtype is not None and kv_is_quantized(kv_dtype) \
                and not context_mode_supported(pipeline.cfg):
            warnings.warn(
                f"{pipeline.cfg.name}: quantized KV pages need an "
                "attention-only stack (recurrent slot state has no paged "
                "rows to quantize); serving at model precision",
                stacklevel=2)
            kv_dtype = None
        # refuses an unquantized kv_dtype of another width than the model's
        M.pool_dtype(kv_dtype, pipeline.dtype)
        self.kv_dtype = kv_dtype
        self.kv_guard_layers = tuple(kv_guard_layers)
        self.spec = spec
        self._proposer = None
        if spec is not None and not context_mode_supported(pipeline.cfg):
            warnings.warn(
                f"{pipeline.cfg.name}: speculative decoding needs an "
                "attention-only stack (a recurrent sublayer's state cannot "
                "roll back past a rejected candidate); serving without it",
                stacklevel=2)
            self.spec = None
        if self.spec is not None:
            self._proposer = self.spec.build(
                n_slots=n_slots, max_len=max_len,
                vocab_size=pipeline.cfg.vocab_size, pad_id=pad_id,
                device=pipeline.device, dtype=pipeline.dtype)
        self.block_size = block_size
        self.max_blocks = max_len // block_size
        # tokens of decode headroom a request must find free at admission
        self.admit_headroom = (block_size if admit_headroom is None
                               else admit_headroom)
        full = n_slots * self.max_blocks + 1
        if stage_blocks is None:
            stage_blocks = [full] * len(pipeline.stages)
        self.stage_blocks = list(stage_blocks)
        if len(self.stage_blocks) != len(pipeline.stages):
            raise ValueError("one pool size per stage")
        # host-side bookkeeping exists from construction (capacity() needs
        # it before any insert); device page arrays allocate lazily
        self._pools: List[Optional[BlockPool]] = []
        self._tables: List[Optional[List[BlockTable]]] = []
        for st, nb in zip(pipeline.stages, self.stage_blocks):
            if st.has_attn:
                pool = BlockPool(nb, block_size)
                self._pools.append(pool)
                self._tables.append([BlockTable(pool)
                                     for _ in range(n_slots)])
            else:
                self._pools.append(None)
                self._tables.append(None)
        # KVSAN: opt-in page-lifecycle sanitizer (repro_torch.analysis.
        # kvsan) shadowing every pool's alloc/incref/free, the kernels'
        # write/read coverage per block, and refcount conservation each
        # iteration. Pure observation: the same tokens with it on or off.
        self.kvsan = bool(kvsan)
        self.kvsan_leaks = 0
        self._san = None
        if self.kvsan:
            from repro_torch.analysis.kvsan import KVSanitizer
            self._san = KVSanitizer(
                quant=(self.kv_dtype is not None
                       and kv_is_quantized(self.kv_dtype)))
            for si, p in enumerate(self._pools):
                if p is not None:
                    self._san.attach_pool(si, p)
        # typical next-request footprint for capacity(), learned from
        # admitted traffic (start at one block)
        self._need_sum = 0
        self._need_cnt = 0
        # per-stage stacked block-table arrays for the decode hot path;
        # rebuilt only when a table mutates (insert / growth / release)
        self._bt_cache: Optional[List[np.ndarray]] = None
        self.prefix_caching = prefix_caching
        self.prefill_chunk = int(prefill_chunk)
        self.prefill_token_cost = prefill_token_cost
        # incremental mode routes prompts through the per-slot context
        # path instead of the joint one-shot insert
        self._incremental = prefix_caching or self.prefill_chunk > 0
        self._prefix: List[Optional[PrefixIndex]] = [
            PrefixIndex(p) if (prefix_caching and p is not None) else None
            for p in self._pools]
        # ---- host page tier (device -> host demotion) ------------------
        if host_blocks and not self.prefix_caching:
            warnings.warn(
                "host_blocks needs prefix_caching=True (the host tier is "
                "keyed by prefix chunk hashes); serving without a host "
                "tier", stacklevel=2)
            host_blocks = 0
        self.host_blocks = int(host_blocks)
        self.host_swap_cost = host_swap_cost
        self._host: List[Optional[HostPagePool]] = [
            HostPagePool(self.host_blocks, block_size)
            if (self.host_blocks > 0 and p is not None) else None
            for p in self._pools]
        # the first attention stage is the cluster directory's
        # REPRESENTATIVE: tier transitions publish once per hash, not once
        # per stage (stages register/evict near-symmetrically; the
        # directory is a hint and export verifies every stage anyway)
        self._rep_stage = next(
            (si for si, p in enumerate(self._pools) if p is not None), None)
        for si, (ix, host) in enumerate(zip(self._prefix, self._host)):
            if ix is not None and host is not None:
                ix.spill = self._make_spill(si)
                host.on_evict = self._make_host_drop(si)
        if self._san is not None:
            # after the on_evict wiring so the sanitizer's LRU-drop
            # shadowing chains onto (not replaces) the directory hook
            for si, host in enumerate(self._host):
                if host is not None:
                    self._san.attach_host(si, host)
        # ---- cluster prefix directory (attach_cluster wires these) -----
        self.cluster_dir = None
        self.cluster_link: Optional[KVLink] = None
        self._cluster_peers: Dict[int, "PagedPipelineBatcher"] = {}
        # ---- disaggregated prefill/decode ------------------------------
        self.role = role
        # set by serving.disagg.wire_disaggregation (role="prefill" only)
        self.dispatcher = None
        # in-transit migrations: heap of (ready_time, seq, KVMigration)
        self._migrations: List = []
        self._mig_seq = 0
        # counters surfaced through ServeStats (the loop reports deltas)
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.prefill_tokens = 0
        self.cow_copies = 0
        self.migrations = 0            # prefills handed off (sender side)
        self.migrated_kv_bytes = 0     # payload bytes shipped (sender side)
        self.spec_steps = 0            # target multi-token verify steps
        self.spec_proposed = 0         # draft tokens proposed
        self.spec_accepted = 0         # draft tokens the target agreed with
        self.spec_tokens = 0           # tokens committed via verify steps
        self.kv_bytes_resident = 0     # allocated page-pool bytes (+scales)
        self.kv_bytes_saved = 0        # vs model-precision pools
        self.host_demotions = 0        # blocks spilled device -> host
        self.host_promotions = 0       # blocks swapped back host -> device
        self.host_evictions = 0        # host-tier LRU drops (pages lost)
        self.host_hit_tokens = 0       # prompt tokens served from host tier
        self.prefix_fetches = 0        # prefix blocks fetched from peers
        self.prefix_fetched_bytes = 0  # payload bytes shipped for fetches
        self._iter_prefill_tokens = 0
        self._iter_spec_proposed = 0
        self._iter_swap_blocks = 0
        self._iter_fetch_cost = 0.0

    # ---- block accounting -------------------------------------------------
    def _min_pool_free(self) -> int:
        # cached-prefix blocks held only by the index are reclaimable on
        # demand (LRU eviction), so admission counts them as free
        frees = [p.n_free + (ix.n_evictable() if ix is not None else 0)
                 for p, ix in zip(self._pools, self._prefix)
                 if p is not None]
        return min(frees) if frees else 1 << 30

    def _usable_blocks(self) -> int:
        sizes = [p.n_blocks - 1 for p in self._pools if p is not None]
        return min(sizes) if sizes else 1 << 30

    def _blocks_needed(self, r: Request) -> int:
        """Admission footprint: prompt + decode headroom (not worst case)."""
        toks = len(r.prompt) + min(self.admit_headroom, r.max_new_tokens)
        return blocks_for_tokens(toks, self.block_size)

    def _typical_blocks(self) -> int:
        if self._need_cnt == 0:
            return 1
        return -(-self._need_sum // self._need_cnt)

    # ---- replica port -----------------------------------------------------
    def capacity(self, now: float) -> int:
        """Admission needs a free slot AND, beyond the queued requests'
        needs, a typical request's prompt + headroom in every pool. A
        decode-role replica admits NO fresh arrivals — its work arrives
        as migrations."""
        if self.role == "decode":
            return 0
        slots = len(self.free_slots()) - len(self._queue)
        if slots <= 0:
            return 0
        queued = sum(self._blocks_needed(r) for r in self._queue)
        if self._min_pool_free() < queued + self._typical_blocks():
            return 0
        return slots

    def load(self, now: float) -> float:
        # in-transit migrations are queue depth too: the dispatcher picks
        # decode replicas by this number
        return super().load(now) + len(self._migrations)

    def busy(self, now: float) -> bool:
        if super().busy(now):
            return True
        return bool(self._migrations) and self._migrations[0][0] <= now

    def inflight(self) -> int:
        return super().inflight() + len(self._migrations)

    def next_event(self, now: float):
        # earliest in-transit migration arrival: the idle loop must jump
        # there, not strand the request
        if self._migrations and self._migrations[0][0] > now:
            return self._migrations[0][0]
        return None

    def metrics_gauges(self):
        """Gauge snapshot for the loop's metrics publication: per-stage
        device-pool occupancy (current + high-water) and host-tier
        residency."""
        out = []
        for si, (pool, host) in enumerate(zip(self._pools, self._host)):
            if pool is None:
                continue
            st = {"stage": si}
            out.append(("kv_pool_used_blocks", st, pool.n_used))
            out.append(("kv_pool_peak_blocks", st, pool.peak_used))
            if host is not None:
                out.append(("host_pool_used_blocks", st, len(host)))
        return out

    # ---- KV migration (disaggregated prefill/decode) -----------------------
    def migrate_in(self, mig: KVMigration, ready: float) -> None:
        """Accept a finished prefill from another replica; it becomes
        placeable once the serving clock reaches `ready` (the modelled
        transfer completion)."""
        if mig.block_size != self.block_size:
            raise ValueError(f"migrated pages of block size "
                             f"{mig.block_size}, this replica's "
                             f"{self.block_size}")
        heapq.heappush(self._migrations, (ready, self._mig_seq, mig))
        self._mig_seq += 1

    def _place_migrations(self, now: float) -> List:
        """Land every arrived migration a free slot + blocks can take:
        allocate each stage's blocks, scatter the page payloads, and seed
        the slot at the migrated position with the migrated sampling state
        — the next decode iteration continues exactly where the prefill
        replica stopped. Returns reject completions (a migration whose
        full generation can never fit this replica's pools)."""
        comps: List = []
        while self._migrations and self._migrations[0][0] <= now:
            mig = self._migrations[0][2]
            r = mig.req
            # a LIVE migration (online rescheduler moving a mid-decode
            # slot) arrives with the tokens the source already emitted;
            # the destination owes only the remainder of the generation
            out = list(mig.out_tokens) if mig.out_tokens is not None \
                else []
            remaining = r.max_new_tokens - len(out)
            need_all = blocks_for_tokens(
                mig.n_tokens + remaining, self.block_size)
            if need_all > self._usable_blocks() \
                    or mig.n_tokens + remaining > self.max_len - 1:
                heapq.heappop(self._migrations)
                self.rejected += 1
                warnings.warn(
                    f"request {r.rid}: migrated KV ({mig.n_tokens} tokens) "
                    f"+ {remaining} more cannot fit this decode "
                    "replica; rejected with empty output")
                comps.append((r, np.zeros(0, np.int32), None))
                continue
            free = self.free_slots()
            need_now = blocks_for_tokens(
                mig.n_tokens + min(self.admit_headroom, remaining),
                self.block_size)
            if not free or self._min_pool_free() < need_now:
                break                  # wait for slots/blocks to free
            heapq.heappop(self._migrations)
            if remaining <= 0:
                # the source extracted a slot that had already emitted its
                # whole budget: nothing left to decode, complete it here
                comps.append((r, np.asarray(out, np.int32), None))
                continue
            self._ensure_device_caches()
            slot = free[0]
            dest = []
            for si, tabs in enumerate(self._tables):
                if tabs is None:
                    dest.append(None)
                    continue
                t = tabs[slot]
                assert not t.blocks, "slot freed without releasing blocks"
                ok = self._stage_alloc(si, t, mig.n_tokens)
                assert ok, "placement checked free blocks yet ran dry"
                dest.append(list(t.blocks))
            self.pipeline.scatter_kv_pages(dest, mig.layer_kv)
            if self._san is not None:
                for si, d in enumerate(dest):
                    if d is not None:
                        self._san.slot_access(si, d, mig.n_tokens, 0,
                                              self.block_size)
            self.slots[slot] = _Slot(req=r, pos=mig.n_tokens,
                                     remaining=remaining, out=out,
                                     seq=self._admit_seq)
            self._admit_seq += 1
            self._last_logits[slot] = mig.last_logits
            self._bt_cache = None
        return comps

    def _migrate_ready(self, now: float) -> None:
        """Hand every prefill-complete slot to the dispatcher: extract its
        pages and sampling state, free its blocks (index-registered prefix
        blocks stay resident), and clear the slot. Oldest first, so
        dispatch order matches admission order."""
        if self.dispatcher is None:
            raise RuntimeError("role='prefill' needs wire_disaggregation "
                               "to set a dispatcher")
        order = sorted((i for i, s in enumerate(self.slots)
                        if s.decoding), key=lambda i: self.slots[i].seq)
        for i in order:
            s = self.slots[i]
            blocks = [list(tabs[i].blocks) if tabs is not None else None
                      for tabs in self._tables]
            if self._san is not None:
                for si, b in enumerate(blocks):
                    if b is not None:   # pure read: the handoff extraction
                        self._san.slot_access(si, b, s.pos, s.pos,
                                              self.block_size)
            layer_kv = self.pipeline.extract_kv_pages(blocks)
            mig = KVMigration(
                req=s.req, n_tokens=s.pos, block_size=self.block_size,
                layer_kv=layer_kv,
                last_logits=np.array(self._last_logits[i]),
                kv_bytes=KVMigration.payload_bytes(layer_kv))
            s.req.prefill_finish_time = now
            self.tracer.mark(s.req.rid, "prefill_finish", now)
            self.migrations += 1
            self.migrated_kv_bytes += mig.kv_bytes
            self.dispatcher.send(self, mig, now)
            self._on_slot_free(i)
            self.slots[i] = _Slot()

    # ---- live migration / evacuation (online rescheduling) -----------------
    def extract_live_slots(self, now: float,
                           slot_ids: Optional[Sequence[int]] = None
                           ) -> List[KVMigration]:
        """Package DECODING slots as live ``KVMigration``s — pages (torch
        payloads at pool precision, with their scales on int8 / fp8 pools),
        sampling state, AND the tokens already emitted (``out_tokens``) —
        then free them. The destination's ``_place_migrations`` resumes
        the stream mid-flight: same pages, same ``last_logits``, same
        ``out`` prefix, so the token stream is identical to never having
        moved. Mid-prefill slots are not extractable (their cache is
        partial); ``evacuate`` requeues those for a cold re-prefill.

        This is the PLANNED-migration half of the online rescheduler: a
        healthy replica being rebalanced away hands its in-flight work to
        the new layout without draining."""
        ids = range(self.n_slots) if slot_ids is None else slot_ids
        order = sorted((i for i in ids if self.slots[i].decoding),
                       key=lambda i: self.slots[i].seq)
        migs: List[KVMigration] = []
        for i in order:
            s = self.slots[i]
            blocks = [list(tabs[i].blocks) if tabs is not None else None
                      for tabs in self._tables]
            if self._san is not None:
                for si, b in enumerate(blocks):
                    if b is not None:   # pure read: the handoff extraction
                        self._san.slot_access(si, b, s.pos, s.pos,
                                              self.block_size)
            layer_kv = self.pipeline.extract_kv_pages(blocks)
            migs.append(KVMigration(
                req=s.req, n_tokens=s.pos, block_size=self.block_size,
                layer_kv=layer_kv,
                last_logits=np.array(self._last_logits[i]),
                kv_bytes=KVMigration.payload_bytes(layer_kv),
                out_tokens=np.asarray(s.out, np.int32)))
            self.migrations += 1
            self.migrated_kv_bytes += migs[-1].kv_bytes
            if self.tracer.enabled:
                self.tracer.instant("live_move", ts=now,
                                    pid=self.replica_id, rid=s.req.rid,
                                    tokens=s.pos,
                                    bytes=migs[-1].kv_bytes)
            self._on_slot_free(i)
            self.slots[i] = _Slot()
        return migs

    def evacuate(self, now: float) -> List[Request]:
        """Release EVERYTHING in flight and return the orphaned requests:
        queued arrivals, mid-prefill slots, decoding slots, and in-transit
        migrations parked at this replica. Every page is released through
        the normal table path (KVSAN-clean — death must not leak), and the
        requests restart from their prompts wherever the caller
        re-dispatches them; greedy decode regenerates the identical token
        stream, so a replica kill costs latency, never correctness.

        This is the FAILURE half of the online rescheduler (and the
        drain-free teardown for planned removals after
        ``extract_live_slots`` took the movable slots)."""
        orphans: List[Request] = list(self._queue)
        self._queue.clear()
        for i, s in enumerate(self.slots):
            if s.free:
                continue
            orphans.append(s.req)
            self._on_slot_free(i)
            self.slots[i] = _Slot()
        while self._migrations:
            _, _, mig = heapq.heappop(self._migrations)
            orphans.append(mig.req)
        return orphans

    # ---- SlotEngine hooks --------------------------------------------------
    def _fits(self, r: Request) -> bool:
        if len(r.prompt) + r.max_new_tokens > self.max_len - 1:
            return False
        # a request whose full generation cannot fit the pool even alone
        # would preempt itself forever; turn it away instead
        need = blocks_for_tokens(len(r.prompt) + r.max_new_tokens,
                                 self.block_size)
        return need <= self._usable_blocks()

    def _can_admit(self, r: Request, batch: Sequence[Request]) -> bool:
        # prompt + headroom, the footprint capacity() advertises
        pending = sum(self._blocks_needed(q) for q in batch)
        if self._min_pool_free() < pending + self._blocks_needed(r):
            return False
        self._need_sum += self._blocks_needed(r)
        self._need_cnt += 1
        return True

    def _ensure_device_caches(self) -> None:
        p = self.pipeline
        if (p.paged_caches is None or p.n_slots != self.n_slots
                or p.slot_len != self.max_len
                or p.block_size != self.block_size
                or p.stage_blocks != self.stage_blocks
                or p.kv_dtype != self.kv_dtype
                or p.kv_guard_layers != self.kv_guard_layers):
            p.init_paged_caches(self.n_slots, self.max_len,
                                block_size=self.block_size,
                                stage_blocks=self.stage_blocks,
                                kv_dtype=self.kv_dtype,
                                kv_guard_layers=self.kv_guard_layers)
            self._account_kv_bytes()

    def _account_kv_bytes(self) -> None:
        """ServeStats counters: bytes the page pools actually occupy
        (payload and scale leaves) and bytes saved against pools at the
        model's dtype (what kv_dtype=None would have allocated)."""
        base_itemsize = torch.empty((), dtype=self.pipeline.dtype
                                    ).element_size()
        resident, baseline = 0, 0
        for caches in self.pipeline.paged_caches:
            for c in caches:
                if "k" not in c:
                    continue       # a recurrent layer's slot state
                for n, t in c.items():
                    resident += t.numel() * t.element_size()
                    if n in ("k", "v"):
                        baseline += t.numel() * base_itemsize
        self.kv_bytes_resident += resident
        self.kv_bytes_saved += max(baseline - resident, 0)

    def _stage_alloc(self, si: int, table: BlockTable,
                     n_tokens: int) -> bool:
        """Grow `table` to hold n_tokens, reclaiming cached-prefix blocks
        from stage si's index if the pool proper is dry."""
        pool, ix = self._pools[si], self._prefix[si]
        need = blocks_for_tokens(n_tokens, self.block_size) - table.n_blocks
        if need <= 0:
            return True
        if pool.n_free < need and ix is not None:
            ix.evict(need - pool.n_free)
        before = table.n_blocks
        ok = table.allocate_tokens(n_tokens)
        if table.n_blocks != before:
            self._bt_cache = None
        return ok

    def _prefill_insert(self, toks, lens, slot_ids):
        self._ensure_device_caches()
        self._bt_cache = None
        m = len(slot_ids)
        self.prefill_tokens += int(np.sum(lens[:m]))
        self._iter_prefill_tokens += int(np.sum(lens[:m]))
        stage_dest = []
        for si, tabs in enumerate(self._tables):
            if tabs is None:
                stage_dest.append(np.zeros(m * self.max_blocks, np.int32))
                continue
            dest = np.zeros((m, self.max_blocks), np.int32)
            for row, slot in enumerate(slot_ids):
                t = tabs[slot]
                assert not t.blocks, "slot freed without releasing blocks"
                ok = self._stage_alloc(si, t, int(lens[row]))
                assert ok, "admission admitted more blocks than the pool has"
                if self._san is not None:
                    self._san.slot_access(si, t.blocks, int(lens[row]), 0,
                                          self.block_size)
                dest[row] = t.as_array(self.max_blocks)
            stage_dest.append(dest.reshape(-1))
        return self.pipeline.insert_slots_paged(toks, lens, slot_ids,
                                                stage_dest)

    # ---- incremental insert: prefix match + deferred (chunked) prefill ----
    def _insert_batch(self, reqs: Sequence[Request],
                      slot_ids: Sequence[int]) -> None:
        if not self._incremental:
            return super()._insert_batch(reqs, slot_ids)
        self._ensure_device_caches()
        for r, slot in zip(reqs, slot_ids):
            self._setup_slot(r, slot)

    def _setup_slot(self, r: Request, slot: int) -> None:
        """Admission in incremental mode: queue the whole prompt as pending
        prefill. The prefix lookup runs LAZILY at the slot's first prefill
        step (_match_slot), so a later arrival admitted in the same batch
        still sees the blocks an earlier one registered this iteration."""
        hashes = chunk_hashes(r.prompt, self.block_size) \
            if self.prefix_caching else []
        self.slots[slot] = _Slot(req=r, pos=0,
                                 remaining=r.max_new_tokens, out=[],
                                 seq=self._admit_seq,
                                 pending=np.asarray(r.prompt, np.int32),
                                 hashes=hashes,
                                 matched=not self.prefix_caching)
        self._admit_seq += 1

    def _match_slot(self, i: int) -> None:
        """First-touch prefix lookup for slot i: alias the longest
        device-indexed prefix (incref per stage), then EXTEND the match
        down the memory hierarchy — host-tier pages swap back into fresh
        device blocks, pages resident only on peer replicas migrate over
        the KV link — and drop the whole matched prefix from the pending
        prefill."""
        s = self.slots[i]
        s.matched = True
        if not s.hashes:
            return
        self.prefix_lookups += 1
        L = min(ix.match_len(s.hashes)
                for ix in self._prefix if ix is not None)
        if L:
            # alias the hit prefix in EVERY stage, incref-ing BEFORE any
            # tier promotion so a promotion's eviction can never take what
            # this very match already claimed
            for tabs, ix in zip(self._tables, self._prefix):
                if tabs is None:
                    continue
                t = tabs[i]
                assert not t.blocks, "slot freed without releasing"
                t.adopt(ix.acquire(s.hashes[:L]))
        Lx = L
        if self._tiered:
            while Lx < len(s.hashes) \
                    and self._materialize_hash(i, s.hashes[Lx]):
                Lx += 1
        if not Lx:
            return
        # always leave >= 1 cold token: the final logits must come from a
        # real forward pass (a fully cached prompt re-runs its last token,
        # copy-on-write duplicating the shared tail block)
        cold = min(Lx * self.block_size, len(s.req.prompt) - 1)
        s.pos = cold
        s.pending = s.pending[cold:]
        self.prefix_hits += 1
        self.prefix_hit_tokens += cold
        self._bt_cache = None

    def _prepare_chunk(self, i: int, target_tokens: int) -> bool:
        """Make slot i's tables able to hold target_tokens AND its next
        write position exclusively owned (copy-on-write). False when some
        pool is dry even after eviction — the caller preempts and
        retries."""
        pos = self.slots[i].pos
        for si, tabs in enumerate(self._tables):
            if tabs is None:
                continue
            t = tabs[i]
            if not self._stage_alloc(si, t, target_tokens):
                return False
            bi = pos // self.block_size
            if bi < t.n_blocks:
                pool, ix = self._pools[si], self._prefix[si]
                if pool.n_free < 1 and ix is not None \
                        and pool.ref(t.blocks[bi]) > 1:
                    ix.evict(1)
                cow = t.writable(bi)
                if cow is False:
                    return False
                if cow is not None:
                    src, dst = cow
                    self.pipeline.copy_pages(si, [src], [dst])
                    if self._san is not None:
                        self._san.on_copy(si, src, dst)
                    self.cow_copies += 1
                    self._bt_cache = None
        return True

    def _prefill_step(self, now: float) -> None:
        """Run ONE prefill chunk for every mid-prefill slot, oldest first.
        Same-iteration chunks coalesce into joint context dispatches; the
        batch flushes whenever a slot COMPLETES its prompt (it registers
        its blocks on flush, so a later same-iteration arrival with the
        same prefix still matches instead of re-prefilling)."""
        order = sorted((i for i, s in enumerate(self.slots)
                        if not s.free and s.pending is not None),
                       key=lambda i: self.slots[i].seq)
        group: List = []               # (slot, chunk) awaiting one dispatch
        for i in order:
            s = self.slots[i]
            if s.free or s.pending is None:
                continue               # preempted by an earlier slot's turn
            if not s.matched:
                # match AFTER flushing so this lookup sees every block the
                # batch's completed prompts just registered
                self._dispatch_chunks(group)
                self._match_slot(i)
            chunk = len(s.pending) if self.prefill_chunk <= 0 \
                else min(self.prefill_chunk, len(s.pending))
            while not self.slots[i].free \
                    and not self._prepare_chunk(i, s.pos + chunk):
                active = [j for j, sl in enumerate(self.slots)
                          if not sl.free]
                self._preempt(max(active,
                                  key=lambda j: self.slots[j].seq))
            if self.slots[i].free:
                continue               # evicted itself; requeued up front
            group.append((i, chunk))
            if self.prefix_caching and chunk == len(s.pending):
                self._dispatch_chunks(group)
        self._dispatch_chunks(group)

    def _dispatch_chunks(self, group: List) -> None:
        """Joint (m, C) right-padded context-prefill call for the queued
        (slot, chunk) pairs: slot i's next `chunk` pending tokens run at
        absolute positions [pos, pos+chunk). Width pads to a multiple of 16
        (the reference's compile bucket). Clears `group`."""
        pairs = [(i, c) for i, c in group
                 if not self.slots[i].free]   # a later prepare may preempt
        group.clear()
        if not pairs:
            return
        m = len(pairs)
        C = min(-(-max(c for _, c in pairs) // 16) * 16, self.max_len - 1)
        toks = np.full((m, C), self.pad_id, np.int32)
        lens = np.zeros(m, np.int32)
        starts = np.zeros(m, np.int32)
        for row, (i, c) in enumerate(pairs):
            s = self.slots[i]
            toks[row, :c] = s.pending[:c]
            lens[row] = c
            starts[row] = s.pos
        if self._san is not None:
            for si, tabs in enumerate(self._tables):
                if tabs is None:
                    continue
                for row, (i, c) in enumerate(pairs):
                    self._san.slot_access(
                        si, tabs[i].blocks, int(starts[row]) + c,
                        int(starts[row]), self.block_size)
        tables = [np.zeros((m, self.max_blocks), np.int32) if tabs is None
                  else np.stack([tabs[i].as_array(self.max_blocks)
                                 for i, _ in pairs])
                  for tabs in self._tables]
        logits = self.pipeline.context_slots_paged(toks, lens, starts, tables)
        if self.tracer.enabled:
            ntok = int(lens.sum())
            self.tracer.complete(
                "prefill",
                self.virtual_step_cost * self.prefill_token_cost * ntok,
                pid=self.replica_id, tokens=ntok, slots=m)
        for row, (i, c) in enumerate(pairs):
            s = self.slots[i]
            s.pos += c
            s.pending = s.pending[c:]
            self.prefill_tokens += c
            self._iter_prefill_tokens += c
            if len(s.pending) == 0:    # prompt fully cached: decode next
                s.pending = None
                self._last_logits[i] = logits[row]
                self._register_prefix(i, s)
                self._bt_cache = None
                self.tracer.mark(s.req.rid, "prefill_finish",
                                 self.tracer.now())

    def _register_prefix(self, i: int, s: _Slot) -> None:
        """Index the prompt's full blocks so later prompts can alias them
        (the index takes its own reference; entries already present keep
        their canonical block). Registration supersedes any host-tier copy
        (one-tier invariant) and publishes device residency to the cluster
        directory."""
        if not self.prefix_caching or not s.hashes:
            return
        for tabs, ix, host in zip(self._tables, self._prefix, self._host):
            if tabs is None or ix is None:
                continue
            ix.register(s.hashes, tabs[i].blocks[:len(s.hashes)])
            if host is not None:
                for h in s.hashes:
                    host.discard(h)
        if self.cluster_dir is not None:
            for h in s.hashes:
                self.cluster_dir.publish(h, self.replica_id, "device")

    # ---- tiered pages: host spill pool + cluster prefix directory ---------
    @property
    def _tiered(self) -> bool:
        return (any(hp is not None for hp in self._host)
                or self.cluster_dir is not None)

    def _make_spill(self, si: int):
        """Demotion closure for stage si's PrefixIndex: an evicted prefix
        block's page payload moves device -> host instead of vanishing."""
        host = self._host[si]

        def spill(h: int, bid: int) -> None:
            if self.pipeline.paged_caches is None:
                return             # nothing ever materialized on device
            if self._san is not None:
                self._san.on_spill(si, bid)
            host.put(h, self.pipeline.extract_stage_pages(si, [bid],
                                                          host=True))
            self.host_demotions += 1
            self._iter_swap_blocks += 1
            if self.tracer.enabled:
                self.tracer.complete(
                    "host_spill",
                    self.virtual_step_cost * self.host_swap_cost,
                    pid=self.replica_id, tid=si)
            if si == self._rep_stage and self.cluster_dir is not None:
                self.cluster_dir.publish(h, self.replica_id, "host")
        return spill

    def _make_host_drop(self, si: int):
        """LRU-bound closure for stage si's HostPagePool: the page has now
        left this replica entirely (bottom of the hierarchy)."""
        def dropped(h: int) -> None:
            self.host_evictions += 1
            if si == self._rep_stage and self.cluster_dir is not None:
                self.cluster_dir.unpublish(h, self.replica_id)
        return dropped

    def attach_cluster(self, directory, peers: Dict[int, object],
                       link: Optional[KVLink]) -> None:
        """Join a cluster prefix directory (cluster_kv.wire_cluster_prefix):
        publish this replica's residency and fetch hot prefixes from
        `peers` (replica_id -> engine) over `link`."""
        if not self.prefix_caching:
            raise ValueError("cluster prefix sharing needs "
                             "prefix_caching=True")
        self.cluster_dir = directory
        self.cluster_link = link if link is not None else KVLink()
        self._cluster_peers = {rid: w for rid, w in peers.items()
                               if rid != self.replica_id}
        # without a host tier, an evicted prefix block leaves the replica
        # entirely — retract the directory claim at eviction time so the
        # published residency never outlives the page
        ix = (self._prefix[self._rep_stage]
              if self._rep_stage is not None else None)
        if ix is not None and ix.spill is None:
            def _unpublish_on_evict(h: int, bid: int) -> None:
                self.cluster_dir.unpublish(h, self.replica_id)
            ix.spill = _unpublish_on_evict

    def export_prefix_block(self, h: int):
        """Package chain hash `h`'s page payload for a peer replica —
        global layer order, the ``KVMigration`` wire format — sourcing
        each stage from its device index or host tier (a COPY ships;
        local residency is untouched). None when some stage no longer
        holds the page (the caller unpublishes the stale directory
        entry and prefills cold)."""
        if self.pipeline.paged_caches is None:
            return None
        layer_kv: List[dict] = []
        for si, (pool, ix, host) in enumerate(
                zip(self._pools, self._prefix, self._host)):
            if pool is None or ix is None:
                return None        # non-attention stage: nothing to export
            bid = ix.lookup(h)
            if bid is not None:
                if self._san is not None:   # peer export reads the page
                    self._san.on_spill(si, bid)
                layer_kv.extend(self.pipeline.extract_stage_pages(si, [bid]))
                continue
            payload = host.peek(h) if host is not None else None
            if payload is None:
                return None
            layer_kv.extend(payload)
        return layer_kv

    def _materialize_hash(self, i: int, h: int) -> bool:
        """Make chain hash `h` device-resident, registered, and aliased
        into slot i's tables in EVERY attention stage. Per stage the
        source is the device index (plain alias), this replica's host
        tier (swap-in: the payload scatters into a fresh block), or a
        peer replica named by the cluster directory (hot-prefix migration
        in the KVMigration wire format, charged at KVLink delay on the
        serving clock). False when some stage holds the page nowhere
        reachable or a pool stays dry even after eviction — the caller
        stops extending and prefills the remainder cold."""
        plan: List = []            # (si, "device" | "host" | "fetch")
        need_fetch = False
        for si, (pool, ix, host) in enumerate(
                zip(self._pools, self._prefix, self._host)):
            if pool is None or ix is None:
                continue
            if ix.lookup(h) is not None:
                plan.append((si, "device"))
            elif host is not None and h in host:
                plan.append((si, "host"))
            else:
                plan.append((si, "fetch"))
                need_fetch = True
        if not plan:
            return False
        layer_kv, src_rid = None, None
        if need_fetch:
            if self.cluster_dir is None:
                return False
            for rid, _tier in self.cluster_dir.holders(
                    h, exclude=self.replica_id):
                peer = self._cluster_peers.get(rid)
                if peer is None:
                    continue
                layer_kv = peer.export_prefix_block(h)
                if layer_kv is not None:
                    src_rid = rid
                    break
                self.cluster_dir.unpublish(h, rid)   # stale entry
            if layer_kv is None:
                return False
        # pop host payloads BEFORE allocating: allocation may evict-demote
        # other blocks into the host pool, and the LRU drop absorbing them
        # must never take the very payload being promoted
        payloads = {}
        for si, kind in plan:
            if kind == "host":
                payloads[si] = self._host[si].get(h)
                assert payloads[si] is not None, "planned host page vanished"
        alloc: Dict[int, int] = {}
        for si, kind in plan:
            if kind == "device":
                continue
            pool, ix = self._pools[si], self._prefix[si]
            if pool.n_free < 1:
                ix.evict(1)
            got = pool.alloc(1)
            if got is None:        # dry even after eviction: roll back
                for sj, bid in alloc.items():
                    self._pools[sj].free(bid)
                for sj, payload in payloads.items():
                    self._host[sj].restore(h, payload)
                return False
            alloc[si] = got[0]
        # land the payloads
        promoted = False
        dest: List = [None] * len(self._tables)
        for si, kind in plan:
            if kind == "host":
                self.pipeline.scatter_stage_pages(si, [alloc[si]],
                                                  payloads[si])
                if self._san is not None:
                    self._san.note_write(si, [alloc[si]])
                promoted = True
                self.host_promotions += 1
                self._iter_swap_blocks += 1
                if self.tracer.enabled:
                    self.tracer.complete(
                        "host_promote",
                        self.virtual_step_cost * self.host_swap_cost,
                        pid=self.replica_id, tid=si)
            elif kind == "fetch":
                dest[si] = [alloc[si]]
        if need_fetch:
            # only the locally-missing stages' layer slices cross the link
            self.pipeline.scatter_kv_pages(dest, layer_kv)
            if self._san is not None:
                for sj, d in enumerate(dest):
                    if d is not None:
                        self._san.note_write(sj, d)
            fetch_bytes, li = 0, 0
            for si, st in enumerate(self.pipeline.stages):
                n_layers = st.hi - st.lo
                if dest[si] is not None:
                    fetch_bytes += KVMigration.payload_bytes(
                        layer_kv[li:li + n_layers])
                li += n_layers
            self.prefix_fetches += 1
            self.prefix_fetched_bytes += fetch_bytes
            fetch_cost = self.cluster_link.delay(
                fetch_bytes, src_rid, self.replica_id)
            self._iter_fetch_cost += fetch_cost
            if self.tracer.enabled:
                self.tracer.complete("prefix_fetch", fetch_cost,
                                     pid=self.replica_id,
                                     src=src_rid, bytes=fetch_bytes)
        if promoted:
            self.host_hit_tokens += self.block_size
        # register + alias: the index takes its own reference, the table
        # takes over the allocation's — refcount 2, exactly the prefill
        # registration shape, so the new block is immune to eviction while
        # deeper hashes of this very chain materialize
        for si, kind in plan:
            ix, t = self._prefix[si], self._tables[si][i]
            if kind == "device":
                t.adopt(ix.acquire([h]))
            else:
                ix.register([h], [alloc[si]])
                t.adopt([alloc[si]])
        if self.cluster_dir is not None:
            self.cluster_dir.publish(h, self.replica_id, "device")
        return True

    def _ensure_blocks(self, i: int) -> bool:
        # decode writes at pos: grow to hold it AND copy-on-write if the
        # target block is still shared
        return self._prepare_chunk(i, self.slots[i].pos + 1)

    def _before_decode(self) -> None:
        """Allocate-on-decode growth; preempt-by-recompute when a pool runs
        dry. Oldest slots grow first and the YOUNGEST active slot is
        evicted — possibly the requester itself — so the head of the line
        always makes progress."""
        order = sorted((i for i, s in enumerate(self.slots)
                        if s.decoding), key=lambda i: self.slots[i].seq)
        for i in order:
            while self.slots[i].decoding and not self._ensure_blocks(i):
                active = [j for j, sl in enumerate(self.slots)
                          if not sl.free]
                self._preempt(max(active, key=lambda j: self.slots[j].seq))

    def _preempt(self, i: int) -> None:
        s = self.slots[i]
        for tabs in self._tables:
            if tabs is not None:
                tabs[i].release()
        self._bt_cache = None
        if self._proposer is not None:
            self._proposer.release(i)
        # recompute: the request restarts from its prompt (greedy decode
        # regenerates the same prefix), at the FRONT of the queue
        self._queue.appendleft(s.req)
        self.slots[i] = _Slot()
        self.preemptions += 1
        if self.tracer.enabled:
            # the recompute itself shows up as this request's next
            # prefill span; the eviction is the instant
            self.tracer.instant("preempt", pid=self.replica_id,
                                rid=s.req.rid, slot=i, pos=s.pos)

    def _on_slot_free(self, i: int) -> None:
        for tabs in self._tables:
            if tabs is not None:
                tabs[i].release()
        self._bt_cache = None
        if self._proposer is not None:
            self._proposer.release(i)

    # ---- speculative decoding (draft -> multi-token verify -> accept) ----
    def _spec_iteration(self, now: float):
        """One target step under speculative decoding: PROPOSE a candidate
        chunk per decoding slot (the bonus token, the argmax plain decode
        would feed next, plus up to ``spec.k`` drafts), ENSURE blocks and
        copy-on-write for the whole chunk (a dry pool preempts the
        youngest active slot, as decode growth does), VERIFY every slot's
        chunk in one pipeline step, ACCEPT the longest draft prefix that
        matches the target's argmax chain and ROLL BACK the pages past the
        committed length."""
        k = self.spec.k
        items = []
        for i, s in enumerate(self.slots):
            if not s.decoding:
                continue
            bonus = int(self._last_logits[i].argmax())
            # the chunk must fit the request's remaining budget AND the
            # slot ceiling (writes stop at max_len - 2, like decode)
            cap = max(min(k, s.remaining - 1, self.max_len - 2 - s.pos), 0)
            hist = np.concatenate([
                np.asarray(s.req.prompt, np.int32),
                np.asarray(s.out, np.int32),
                np.asarray([bonus], np.int32)])
            items.append((i, bonus, hist, cap))
        props = self._proposer.propose(
            [(i, hist, cap) for i, _, hist, cap in items])
        n_prop = sum(len(p) for p in props.values())
        self._iter_spec_proposed += n_prop
        if self.tracer.enabled and n_prop:
            self.tracer.complete(
                "spec_propose",
                self.virtual_step_cost * self.spec.draft_token_cost
                * n_prop,
                ts=now, pid=self.replica_id, tokens=n_prop)
        # block growth + copy-on-write for the whole chunk, oldest first
        plan = {}
        empty = np.zeros(0, np.int32)
        for i, bonus, hist, cap in sorted(
                items, key=lambda it: self.slots[it[0]].seq):
            if not self.slots[i].decoding:
                continue           # preempted by an earlier slot's turn
            drafts = np.asarray(props.get(i, empty), np.int32)[:cap]
            while self.slots[i].decoding and not self._prepare_chunk(
                    i, self.slots[i].pos + 1 + len(drafts)):
                active = [j for j, sl in enumerate(self.slots)
                          if not sl.free]
                self._preempt(max(active, key=lambda j: self.slots[j].seq))
            if self.slots[i].decoding:
                plan[i] = (bonus, drafts)
        if not plan:
            return []              # everyone preempted themselves away
        # joint verification: FIXED chunk width k + 1, per-slot real
        # counts; absent slots are dead rows with null tables
        T = k + 1
        toks = np.zeros((self.n_slots, T), np.int32)
        qlen = np.zeros((self.n_slots,), np.int32)
        starts = np.zeros((self.n_slots,), np.int32)
        for i, (bonus, drafts) in plan.items():
            toks[i, 0] = bonus
            toks[i, 1:1 + len(drafts)] = drafts
            qlen[i] = 1 + len(drafts)
            starts[i] = self.slots[i].pos
        tables = [np.zeros((self.n_slots, self.max_blocks), np.int32)
                  if tabs is None else
                  np.stack([t.as_array(self.max_blocks) if j in plan
                            else np.zeros(self.max_blocks, np.int32)
                            for j, t in enumerate(tabs)])
                  for tabs in self._tables]
        if self._san is not None:
            for si, tabs in enumerate(self._tables):
                if tabs is None:
                    continue
                for i in plan:
                    self._san.slot_access(
                        si, tabs[i].blocks, int(starts[i]) + int(qlen[i]),
                        int(starts[i]), self.block_size)
        logits = self.pipeline.verify_slots_paged(toks, qlen, starts, tables)
        if self.tracer.enabled:
            # the multi-token verification step is the iteration's target
            # pass: flat iteration cost, like a plain decode step
            self.tracer.complete("spec_verify", self.virtual_step_cost,
                                 ts=now, pid=self.replica_id,
                                 slots=len(plan))
        done = []
        for i, (bonus, drafts) in plan.items():
            s = self.slots[i]
            commit, a = greedy_accept(logits[i], bonus, drafts)
            self.spec_steps += 1
            self.spec_proposed += len(drafts)
            self.spec_accepted += a
            self.spec_tokens += len(commit)
            # logits[a] follows the last committed token: its argmax is the
            # next step's bonus token
            self._last_logits[i] = logits[i, a]
            if not s.out:
                # first-wins across preempt-recompute, like plain decode
                if s.req.first_token_time is None:
                    s.req.first_token_time = now
                self.tracer.mark(s.req.rid, "first_token", now)
            s.out.extend(commit)
            s.pos += len(commit)
            s.remaining -= len(commit)
            # speculative-page rollback: blocks wholly past the committed
            # length go back to the pool (prefix-index aliases survive:
            # truncate drops one reference like any release)
            freed = 0
            for tabs in self._tables:
                if tabs is not None:
                    freed += tabs[i].truncate(s.pos)
            if freed:
                self._bt_cache = None
                if self.tracer.enabled:
                    self.tracer.instant("spec_rollback", ts=now,
                                        pid=self.replica_id, slot=i,
                                        blocks=freed)
            if s.remaining <= 0 or s.pos >= self.max_len - 1:
                done.append((s.req, s.out))
                self._on_slot_free(i)
                self.slots[i] = _Slot()
            else:
                self._proposer.commit(i, a)
        return done

    def _step(self, now: float):
        if self._incremental:
            self._prefill_step(now)
        if self.role == "prefill":
            self._migrate_ready(now)   # hand off instead of decoding
            return []
        if any(s.decoding for s in self.slots):
            if self.spec is not None:
                return self._spec_iteration(now)
            return self._decode_iteration(now)
        return []                  # every occupied slot is still prefilling

    def run_iteration(self, now: float):
        self._iter_prefill_tokens = 0
        self._iter_spec_proposed = 0
        self._iter_swap_blocks = 0
        self._iter_fetch_cost = 0.0
        # land arrived migrations BEFORE the base iteration so their slots
        # join this very decode step (mirrors colocated serving, where a
        # prefill finishing in iteration i decodes its first token in i)
        mig_comps = self._place_migrations(now) if self._migrations else []
        comps, cost = super().run_iteration(now)
        # virtual accounting: charge prefilled tokens a fraction of an
        # iteration so chunking and prefix hits show up in latency
        if self._iter_prefill_tokens and self.prefill_token_cost:
            cost += (self.virtual_step_cost * self.prefill_token_cost
                     * self._iter_prefill_tokens)
        # ... and draft proposals their configured fraction
        if self._iter_spec_proposed and self.spec is not None \
                and self.spec.draft_token_cost:
            cost += (self.virtual_step_cost * self.spec.draft_token_cost
                     * self._iter_spec_proposed)
        # ... and every block crossing the device<->host boundary its swap
        # cost, plus cluster prefix fetches their modelled link delay — the
        # tiers are only a win when the swap is cheaper than the recompute
        # it replaces, and the clock must be able to say so
        if self._iter_swap_blocks and self.host_swap_cost:
            cost += (self.virtual_step_cost * self.host_swap_cost
                     * self._iter_swap_blocks)
        if self._iter_fetch_cost:
            cost += self._iter_fetch_cost
        if self._san is not None:
            self._kvsan_audit()
        return mig_comps + comps, cost

    def _kvsan_audit(self) -> None:
        """Iteration-boundary KVSAN audit: every pool reference must be
        explained by a slot's BlockTable or a PrefixIndex entry
        (unexplained references count as leaks -> kvsan_leaks; a
        reference a table expects but the pool lost raises), the host
        shadow must match the actual host tier, and every directory
        entry this replica published must point at a page it still
        holds."""
        san = self._san
        for si, pool in enumerate(self._pools):
            if pool is None:
                continue
            expected: Dict[int, int] = {}
            for t in self._tables[si]:
                for b in t.blocks:
                    expected[b] = expected.get(b, 0) + 1
            ix = self._prefix[si]
            if ix is not None:
                for bid in ix.indexed_blocks():
                    expected[bid] = expected.get(bid, 0) + 1
            self.kvsan_leaks += san.audit_pool(si, pool, expected)
            host = self._host[si]
            if host is not None:
                san.audit_host(si, host)
        if self.cluster_dir is not None and self._rep_stage is not None:
            ix = self._prefix[self._rep_stage]
            host = self._host[self._rep_stage]
            for h, tier in self.cluster_dir.entries_for(self.replica_id):
                if tier == "device" and (ix is None
                                         or ix.lookup(h) is None):
                    san.violate(
                        f"kvsan replica {self.replica_id}: directory "
                        f"says device for hash {h} but no block is "
                        "resident")
                elif tier == "host" and (host is None or h not in host):
                    san.violate(
                        f"kvsan replica {self.replica_id}: directory "
                        f"says host for hash {h} but the host tier "
                        "lacks it")

    def _decode_all(self, toks, pos):
        if self._san is not None:
            for si, tabs in enumerate(self._tables):
                if tabs is None:
                    continue
                for j, s in enumerate(self.slots):
                    if s.decoding:
                        self._san.slot_access(
                            si, tabs[j].blocks, int(pos[j]) + 1,
                            int(pos[j]), self.block_size)
        if self._bt_cache is None:
            # rows of slots that are NOT decoding (free, or mid-prefill)
            # present an all-null table so their joint-iteration garbage
            # write lands in the trash page, never in allocated blocks
            self._bt_cache = [
                np.zeros((self.n_slots, self.max_blocks), np.int32)
                if tabs is None else
                np.stack([t.as_array(self.max_blocks)
                          if self.slots[j].decoding else
                          np.zeros(self.max_blocks, np.int32)
                          for j, t in enumerate(tabs)])
                for tabs in self._tables]
        return self.pipeline.decode_slots_paged(toks, pos, self._bt_cache)
