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

The host logic is the reference's, line for line where it can be, so both
engines make the same admission, allocation and preemption decisions and
the same ServeStats counters come out. Disaggregated roles, the host page
tier, the cluster prefix directory, KVSAN and tracing wait for later
slices (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import warnings
from collections import deque
from typing import Deque, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models.quant import kv_is_quantized
from repro_torch.serving.block_manager import (BlockPool, BlockTable,
                                               PrefixIndex, blocks_for_tokens,
                                               chunk_hashes)
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
        for i, s in enumerate(self.slots):
            if s.decoding:         # mid-prefill slots sit this one out
                toks[i] = int(self._last_logits[i].argmax())
                pos[i] = s.pos
        logits = self._decode_all(toks, pos)
        done = []
        for i, s in enumerate(self.slots):
            if not s.decoding:
                continue
            s.out.append(int(toks[i]))
            if len(s.out) == 1 and s.req.first_token_time is None:
                # first-wins: a preempt-recompute re-produces the stream,
                # but the client saw the first token at the first emission
                s.req.first_token_time = now
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
                              else VirtualClock())


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
    """

    def __init__(self, pipeline, *, n_slots: int = 8, max_len: int = 256,
                 block_size: int = 16,
                 stage_blocks: Optional[Sequence[int]] = None,
                 admit_headroom: Optional[int] = None, pad_id: int = 0,
                 virtual_step_cost: float = 1.0,
                 prefix_caching: bool = False, prefill_chunk: int = 0,
                 prefill_token_cost: float = 0.0, replica_id: int = 0,
                 spec: Optional[SpecConfig] = None,
                 kv_dtype: Optional[str] = None,
                 kv_guard_layers: Sequence[int] = ()):
        if not slot_mode_supported(pipeline.cfg):
            raise NotImplementedError(f"{pipeline.cfg.name}: slot mode "
                                      "needs a uniform text decoder")
        if max_len % block_size:
            raise ValueError(f"max_len {max_len} is not a multiple of "
                             f"block_size {block_size}")
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
        # counters surfaced through ServeStats (the loop reports deltas)
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.prefill_tokens = 0
        self.cow_copies = 0
        self.spec_steps = 0            # target multi-token verify steps
        self.spec_proposed = 0         # draft tokens proposed
        self.spec_accepted = 0         # draft tokens the target agreed with
        self.spec_tokens = 0           # tokens committed via verify steps
        self.kv_bytes_resident = 0     # allocated page-pool bytes (+scales)
        self.kv_bytes_saved = 0        # vs model-precision pools
        self._iter_prefill_tokens = 0
        self._iter_spec_proposed = 0

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
        needs, a typical request's prompt + headroom in every pool."""
        slots = len(self.free_slots()) - len(self._queue)
        if slots <= 0:
            return 0
        queued = sum(self._blocks_needed(r) for r in self._queue)
        if self._min_pool_free() < queued + self._typical_blocks():
            return 0
        return slots

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
        """First-touch prefix lookup for slot i: alias the longest indexed
        prefix in every stage and drop it from the pending prefill."""
        s = self.slots[i]
        s.matched = True
        if not s.hashes:
            return
        self.prefix_lookups += 1
        L = min(ix.match_len(s.hashes)
                for ix in self._prefix if ix is not None)
        if not L:
            return
        for tabs, ix in zip(self._tables, self._prefix):
            if tabs is None:
                continue
            t = tabs[i]
            assert not t.blocks, "slot freed without releasing"
            t.adopt(ix.acquire(s.hashes[:L]))
        # always leave >= 1 cold token: the final logits must come from a
        # real forward pass (a fully cached prompt re-runs its last token,
        # copy-on-write duplicating the shared tail block)
        cold = min(L * self.block_size, len(s.req.prompt) - 1)
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
        tables = [np.zeros((m, self.max_blocks), np.int32) if tabs is None
                  else np.stack([tabs[i].as_array(self.max_blocks)
                                 for i, _ in pairs])
                  for tabs in self._tables]
        logits = self.pipeline.context_slots_paged(toks, lens, starts, tables)
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

    def _register_prefix(self, i: int, s: _Slot) -> None:
        """Index the prompt's full blocks so later prompts can alias them
        (the index takes its own reference; entries already present keep
        their canonical block)."""
        if not self.prefix_caching or not s.hashes:
            return
        for tabs, ix in zip(self._tables, self._prefix):
            if tabs is None or ix is None:
                continue
            ix.register(s.hashes, tabs[i].blocks[:len(s.hashes)])

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
        self._iter_spec_proposed += sum(len(p) for p in props.values())
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
        logits = self.pipeline.verify_slots_paged(toks, qlen, starts, tables)
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
            if not s.out and s.req.first_token_time is None:
                s.req.first_token_time = now   # first-wins, like decode
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
        if any(s.decoding for s in self.slots):
            if self.spec is not None:
                return self._spec_iteration(now)
            return self._decode_iteration(now)
        return []                  # every occupied slot is still prefilling

    def run_iteration(self, now: float):
        self._iter_prefill_tokens = 0
        self._iter_spec_proposed = 0
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
        return comps, cost

    def _decode_all(self, toks, pos):
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
