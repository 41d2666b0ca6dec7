"""KVSAN: an opt-in runtime sanitizer for the paged-KV lifecycle.

Every KV page in the serving stack moves through a small state machine::

      alloc            write             free
    FREE ----> ALLOC --------> WRITTEN --------> FREE
                 |    (prefill/decode/   ^  (release/truncate/
                 |     COW-copy/scatter) |   evict, ref -> 0)
                 +--- incref/free move the refcount without
                      changing the page state

and, for prefix pages, across tiers: device-resident (PrefixIndex) ->
host-resident (HostPagePool, spill) -> device again (promote) or gone
(LRU drop), with exactly ONE tier holding the payload at any instant.

``KVSanitizer`` shadows all of it in pure Python: it wraps a
``BlockPool``'s ``alloc``/``incref``/``free`` (sanitizer checks run
BEFORE the pool's own asserts, so a double free raises ``KVSanViolation``
with the stage and block id instead of a bare assert), tracks per-block
write state from the engine's kernel-dispatch hooks, mirrors each
``HostPagePool``'s resident-hash set, and audits refcount conservation
every serve iteration (every reference must be explained by a slot's
BlockTable, a PrefixIndex entry, or the pinned null block).

Violation classes:

  * double free / incref of a dead block / realloc of a live block
  * use-after-free: a kernel dispatch touches a freed block
  * read-before-write: a kernel reads a page no write ever landed in
  * two-tier aliasing: a hash demoted while already host-resident, or a
    host shadow diverging from the pool's actual contents
  * scale/payload disagreement: a quantized engine spilling pages
    without their scale leaves (or an unquantized one with them)
  * refcount leak: a pool reference no live table or index explains
    (counted, surfaced as ``ServeStats.kvsan_leaks``; conversely a
    DANGLING table reference raises immediately)

The sanitizer only observes — wrapped methods return exactly what the
originals return — so serving under ``kvsan=True`` is token-identical
to sanitizer-off runs.

Port of repro.analysis.kvsan, line for line below the imports. Wire-up:
``PagedPipelineBatcher(kvsan=True)``, ``InferenceEngine(kvsan=True)``,
``python -m repro_torch.launch.serve --kvsan``. Hand-driven use for
tests::

    san = KVSanitizer()
    san.attach_pool(0, pool)
    blocks = pool.alloc(2)
    san.note_write(0, blocks)
    san.slot_access(0, blocks, kv_len=20, write_start=16, block_size=16)
    pool.free(blocks[0]); pool.free(blocks[0])   # -> KVSanViolation
"""
from __future__ import annotations

import weakref
from typing import Dict, List, Mapping, Optional, Sequence, Set

from repro_torch.serving.block_manager import NULL_BLOCK, blocks_for_tokens

FREE = "free"
ALLOC = "alloc"          # allocated, no write landed yet
WRITTEN = "written"


class KVSanViolation(AssertionError):
    """A KV-page lifecycle invariant was broken (see module docstring)."""


class KVSanitizer:
    """Shadow model of every attached pool's page lifecycle.

    ``quant=True`` additionally demands scale leaves on every spilled
    page payload (the twin-pool invariant: scales ride with their
    payload through every tier move).
    """

    def __init__(self, *, quant: bool = False):
        self.quant = quant
        self.violations: List[str] = []   # every violation ever raised
        self.leaks = 0                    # distinct leaked (stage, block)s
        self._state: Dict[int, Dict[int, str]] = {}
        self._ref: Dict[int, Dict[int, int]] = {}     # shadow refcounts
        self._host: Dict[int, Set[int]] = {}          # shadow host hashes
        self._leaked: Dict[int, Set[int]] = {}        # already-counted

    def violate(self, msg: str) -> None:
        self.violations.append(msg)
        raise KVSanViolation(msg)

    # ---- pool wrapping ---------------------------------------------------
    def attach_pool(self, si: int, pool) -> None:
        """Shadow ``pool`` (stage ``si``): wrap alloc/incref/free with
        sanitizer checks that run BEFORE the pool's own asserts."""
        st = self._state.setdefault(si, {})
        rf = self._ref.setdefault(si, {NULL_BLOCK: 1})
        for bid in range(1, pool.n_blocks):   # adopt pre-existing state
            r = pool.ref(bid)
            if r > 0:
                rf[bid] = r
                st[bid] = WRITTEN
        orig_alloc, orig_incref, orig_free = \
            pool.alloc, pool.incref, pool.free

        def alloc(n: int = 1):
            out = orig_alloc(n)
            if out is not None:
                for b in out:
                    if rf.get(b, 0) != 0:
                        self.violate(f"kvsan stage {si}: block {b} handed "
                                     "out while still referenced")
                    rf[b] = 1
                    st[b] = ALLOC
            return out

        def incref(bid: int):
            if rf.get(bid, 0) <= 0:
                self.violate(f"kvsan stage {si}: incref of dead block "
                             f"{bid} (use-after-free alias)")
            orig_incref(bid)
            rf[bid] += 1

        def free(bid: int):
            if bid != NULL_BLOCK:
                if rf.get(bid, 0) <= 0:
                    self.violate(f"kvsan stage {si}: double free of "
                                 f"block {bid}")
                rf[bid] -= 1
                if rf[bid] == 0:
                    st[bid] = FREE
            return orig_free(bid)

        pool.alloc, pool.incref, pool.free = alloc, incref, free

    # ---- write/read tracking (engine kernel-dispatch hooks) --------------
    def note_write(self, si: int, bids: Sequence[int]) -> None:
        """A page write landed in each of ``bids`` (scatter/copy paths)."""
        st = self._state.setdefault(si, {})
        for b in bids:
            if b == NULL_BLOCK:
                continue
            if st.get(b, FREE) == FREE:
                self.violate(f"kvsan stage {si}: write into freed block "
                             f"{b} (use-after-free write)")
            st[b] = WRITTEN

    def slot_access(self, si: int, blocks: Sequence[int], kv_len: int,
                    write_start: int, block_size: int) -> None:
        """One slot's kernel dispatch: writes tokens
        [write_start, kv_len), attends over [0, kv_len). Checks every
        touched block is live, every block read below ``write_start``
        was written, and marks the write range written.
        ``write_start == kv_len`` is a pure read (KV extraction)."""
        st = self._state.setdefault(si, {})
        nb = blocks_for_tokens(kv_len, block_size)
        if nb > len(blocks):
            self.violate(f"kvsan stage {si}: table holds {len(blocks)} "
                         f"blocks but kv_len {kv_len} needs {nb}")
        for bi in range(nb):
            bid = blocks[bi]
            if bid == NULL_BLOCK:
                self.violate(f"kvsan stage {si}: null block inside "
                             f"kv_len at block index {bi}")
            s = st.get(bid, FREE)
            if s == FREE:
                self.violate(f"kvsan stage {si}: kernel touches freed "
                             f"block {bid} (use-after-free)")
            if (bi + 1) * block_size <= write_start:
                if s != WRITTEN:
                    self.violate(f"kvsan stage {si}: kernel reads block "
                                 f"{bid} that no write ever landed in")
            else:
                if s == ALLOC and bi * block_size < write_start:
                    self.violate(f"kvsan stage {si}: kernel reads "
                                 f"unwritten tokens of block {bid}")
                if bi * block_size < kv_len and write_start < kv_len:
                    st[bid] = WRITTEN

    def on_copy(self, si: int, src: int, dst: int) -> None:
        """A COW page copy src -> dst (both must be live, src written)."""
        st = self._state.setdefault(si, {})
        if st.get(src, FREE) != WRITTEN:
            self.violate(f"kvsan stage {si}: COW copies from block {src} "
                         f"in state {st.get(src, FREE)!r}")
        if st.get(dst, FREE) == FREE:
            self.violate(f"kvsan stage {si}: COW copies into freed "
                         f"block {dst}")
        st[dst] = WRITTEN

    def on_spill(self, si: int, bid: int) -> None:
        """A prefix block's payload is about to demote device -> host."""
        st = self._state.setdefault(si, {})
        if st.get(bid, FREE) != WRITTEN:
            self.violate(f"kvsan stage {si}: spill extracts block {bid} "
                         f"in state {st.get(bid, FREE)!r}")

    # ---- host-tier wrapping ----------------------------------------------
    def attach_host(self, si: int, host) -> None:
        """Mirror ``host``'s resident-hash set and check tier/scale
        coherence on every demotion. Wrap AFTER the engine wires
        ``host.on_evict`` so the LRU-drop chain stays intact."""
        shadow = self._host.setdefault(si, set())
        shadow.update(getattr(host, "_pages", ()))
        # the wrappers live on `host` and hold its methods weakly: bound
        # methods would make a cycle that keeps the host pages until a full
        # garbage collection
        orig_put, orig_get, orig_discard = (
            weakref.WeakMethod(m) for m in (host.put, host.get, host.discard))
        orig_ev = host.on_evict

        def put(h: int, payload) -> None:
            if h in shadow:
                self.violate(f"kvsan stage {si}: hash {h} demoted while "
                             "already host-resident (two-tier alias)")
            self._check_payload(si, h, payload)
            shadow.add(h)
            orig_put()(h, payload)

        def get(h: int):
            payload = orig_get()(h)
            if payload is not None:
                shadow.discard(h)
            return payload

        def discard(h: int) -> None:
            shadow.discard(h)
            orig_discard()(h)

        def on_evict(h: int) -> None:
            shadow.discard(h)
            if orig_ev is not None:
                orig_ev(h)

        # host.restore re-enters the wrapped put (instance attribute), so
        # it needs no wrapper of its own
        host.put, host.get, host.discard = put, get, discard
        host.on_evict = on_evict

    def _check_payload(self, si: int, h: int, payload) -> None:
        """Quantized pools must spill scales with their payload (and
        unquantized pools must not grow them): a page whose scales live
        in a different tier than its int8/fp8 payload dequantizes
        garbage on promotion."""
        if not isinstance(payload, (list, tuple)):
            return                 # opaque payload (hand-driven tests)
        kv_layers = [L for L in payload
                     if isinstance(L, dict) and "k" in L]
        if not kv_layers:
            return
        scaled = any("k_scale" in L or "v_scale" in L for L in kv_layers)
        if self.quant and not scaled:
            self.violate(f"kvsan stage {si}: quantized page {h} spilled "
                         "without scale leaves (scale/payload tier "
                         "disagreement)")
        if not self.quant and scaled:
            self.violate(f"kvsan stage {si}: unquantized page {h} "
                         "spilled with scale leaves (scale/payload "
                         "disagreement)")

    # ---- iteration-boundary audits ---------------------------------------
    def audit_pool(self, si: int, pool,
                   expected: Mapping[int, int]) -> int:
        """Refcount conservation for stage ``si``: ``expected`` maps block
        id -> references the engine can explain (slot tables + prefix
        index; the null block's pin is implied). Unexplained references
        are LEAKS (counted once per block, returned); a reference the
        engine expects but the pool lost is corruption and raises."""
        rf = self._ref.get(si, {})
        leaked = self._leaked.setdefault(si, set())
        fresh = 0
        for bid in range(pool.n_blocks):
            actual = pool.ref(bid)
            shadow = rf.get(bid, 1 if bid == NULL_BLOCK else 0)
            if actual != shadow:
                self.violate(f"kvsan stage {si}: shadow refcount for "
                             f"block {bid} diverged (shadow {shadow}, "
                             f"pool {actual})")
            exp = expected.get(bid, 0) + (1 if bid == NULL_BLOCK else 0)
            if actual > exp:
                if bid not in leaked:
                    leaked.add(bid)
                    fresh += 1
                    self.violations.append(
                        f"kvsan stage {si}: block {bid} holds "
                        f"{actual - exp} reference(s) no table or index "
                        "explains (leak)")
            else:
                leaked.discard(bid)
                if exp > actual:
                    self.violate(f"kvsan stage {si}: dangling "
                                 f"reference(s) to block {bid} "
                                 f"(expected {exp}, pool holds {actual})")
        self.leaks += fresh
        return fresh

    def audit_host(self, si: int, host) -> None:
        """The shadow hash set must equal the host pool's actual
        contents — a divergence means a payload moved tiers behind the
        wrapped methods' back."""
        actual = set(getattr(host, "_pages", ()))
        shadow = self._host.get(si, set())
        if actual != shadow:
            extra = sorted(actual - shadow)
            missing = sorted(shadow - actual)
            self.violate(f"kvsan stage {si}: host tier diverged from "
                         f"shadow (untracked={extra[:4]}, "
                         f"vanished={missing[:4]})")

    def state(self, si: int, bid: int) -> str:
        return self._state.get(si, {}).get(bid, FREE)
