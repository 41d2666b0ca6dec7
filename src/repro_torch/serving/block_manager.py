"""Paged KV-cache bookkeeping of the port (copy of
repro.serving.block_manager): the device tier, and the host page tier
under it.

A fixed pool of cache BLOCKS per stage and a per-request BlockTable mapping
logical token positions to physical blocks: admission needs only the
prompt's blocks plus headroom, decode grows tables one block at a time, and
when a pool runs dry the engine preempts a slot by recompute.

Block ids are plain ints into per-stage page arrays
``(n_blocks, block_size, heads, head_dim)``. Block 0 is the NULL/trash
block: unallocated table entries point at it, padding writes land in it,
and attention never unmasks it.

Refcounts back PREFIX SHARING: ``PrefixIndex`` maps a chained hash of each
block-aligned token chunk to the resident block holding its K/V, holding
one reference per indexed block so cached prefixes survive their request.
Writing into a still-shared block first goes through
``BlockTable.writable`` (copy-on-write). Blocks whose only reference is the
index's are evictable, LRU-first, when the pool runs dry.

``HostPagePool`` is the tier below: a prefix block the index evicts under
pool pressure demotes its page payload there (``PrefixIndex.spill``)
instead of vanishing, and a later match promotes it back into a fresh
device block. Payloads are the pipeline's per-layer dicts of torch
tensors, at pool precision.

Everything here is host-side Python.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

NULL_BLOCK = 0


def blocks_for_tokens(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold n_tokens (>= 0)."""
    return -(-max(n_tokens, 0) // block_size)


class BlockPool:
    """Fixed pool of cache blocks with a free list and per-block refcounts.

    Block 0 is reserved (NULL/trash) and never handed out; ``n_blocks``
    counts it, so a pool of n_blocks has n_blocks - 1 usable blocks.
    """

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks < 2 or block_size < 1:
            raise ValueError("a pool needs the null block + one, and "
                             "block_size >= 1")
        self.n_blocks = n_blocks
        self.block_size = block_size
        self._free: deque = deque(range(1, n_blocks))
        self._ref = np.zeros(n_blocks, np.int32)
        self._ref[NULL_BLOCK] = 1          # pinned forever
        # optional PrefixIndex notified on 1<->2 ref transitions so it can
        # keep its evictable count O(1) (set by PrefixIndex.__init__)
        self.observer = None
        # occupancy high-water mark, exported as the kv_pool_peak_blocks
        # gauge (repro_torch.obs.metrics)
        self.peak_used = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return (self.n_blocks - 1) - len(self._free)

    def alloc(self, n: int = 1) -> Optional[List[int]]:
        """All-or-nothing allocation of n blocks; None when the pool is dry."""
        if n > len(self._free):
            return None
        out = [self._free.popleft() for _ in range(n)]
        for b in out:
            assert self._ref[b] == 0, b
            self._ref[b] = 1
        used = self.n_used
        if used > self.peak_used:
            self.peak_used = used
        return out

    def incref(self, bid: int) -> None:
        assert bid != NULL_BLOCK and self._ref[bid] > 0, bid
        self._ref[bid] += 1
        if self._ref[bid] == 2 and self.observer is not None:
            self.observer._ref_rose_above_one(bid)

    def free(self, bid: int) -> None:
        """Drop one reference; the block returns to the free list at zero."""
        if bid == NULL_BLOCK:
            return
        assert self._ref[bid] > 0, f"double free of block {bid}"
        self._ref[bid] -= 1
        if self._ref[bid] == 0:
            self._free.append(bid)
        elif self._ref[bid] == 1 and self.observer is not None:
            self.observer._ref_fell_to_one(bid)

    def ref(self, bid: int) -> int:
        return int(self._ref[bid])


@dataclasses.dataclass
class BlockTable:
    """One request's logical->physical block map within a single pool."""

    pool: BlockPool
    blocks: List[int] = dataclasses.field(default_factory=list)

    @property
    def n_blocks(self) -> int:
        return len(self.blocks)

    def allocate_tokens(self, n_tokens: int) -> bool:
        """Grow the table to hold n_tokens total; all-or-nothing."""
        need = blocks_for_tokens(n_tokens, self.pool.block_size) \
            - len(self.blocks)
        if need <= 0:
            return True
        got = self.pool.alloc(need)
        if got is None:
            return False
        self.blocks.extend(got)
        return True

    def ensure(self, pos: int) -> bool:
        """Make position `pos` writable (allocate-on-decode growth)."""
        return self.allocate_tokens(pos + 1)

    def release(self) -> None:
        for b in self.blocks:
            self.pool.free(b)
        self.blocks.clear()

    def truncate(self, n_tokens: int) -> int:
        """Speculative-page rollback: shrink the table to the blocks that
        hold ``n_tokens``, dropping one reference to each trailing block
        (so a block aliased elsewhere, by the prefix index or another
        table, stays resident for its other holders). Stale candidate K/V
        in the kept tail block is masked by kv_len and overwritten by the
        next chunk. Returns the number of blocks dropped."""
        keep = blocks_for_tokens(n_tokens, self.pool.block_size)
        dropped = 0
        while len(self.blocks) > keep:
            self.pool.free(self.blocks.pop())
            dropped += 1
        return dropped

    def adopt(self, blocks: Sequence[int]) -> None:
        """Append already-referenced block ids to the table, taking over
        their references (the landing step of prefix aliasing)."""
        assert not (set(blocks) & set(self.blocks)), "block adopted twice"
        self.blocks.extend(int(b) for b in blocks)

    def fork(self) -> "BlockTable":
        """Alias every block (refcount++) — the prefix-sharing enabler.
        Callers must copy-on-write before mutating a shared block."""
        for b in self.blocks:
            self.pool.incref(b)
        return BlockTable(self.pool, list(self.blocks))

    def writable(self, block_idx: int
                 ) -> Union[None, Tuple[int, int], bool]:
        """Copy-on-write: make ``blocks[block_idx]`` exclusively owned.

        Returns None when the block is already exclusive (ref == 1), a
        ``(src, dst)`` pair when it was aliased onto a fresh block — the
        caller must copy the page contents src -> dst on device; the shared
        block loses this table's reference here — or False when the pool
        has no free block for the copy (caller evicts or preempts)."""
        bid = self.blocks[block_idx]
        assert bid != NULL_BLOCK, "COW on the null block"
        if self.pool.ref(bid) == 1:
            return None
        got = self.pool.alloc(1)
        if got is None:
            return False
        self.blocks[block_idx] = got[0]
        self.pool.free(bid)          # drop OUR reference; sharers keep theirs
        return (bid, got[0])

    def as_array(self, max_blocks: int) -> np.ndarray:
        """(max_blocks,) int32 padded with the NULL block."""
        assert len(self.blocks) <= max_blocks, (len(self.blocks), max_blocks)
        out = np.full(max_blocks, NULL_BLOCK, np.int32)
        out[:len(self.blocks)] = self.blocks
        return out

    def gather_positions(self, n_tokens: int) -> np.ndarray:
        """Flat physical slot index (block * block_size + offset) of each of
        the first n_tokens logical positions — the host-side round-trip
        oracle the property tests check gather/scatter against."""
        bs = self.pool.block_size
        pos = np.arange(n_tokens)
        return np.asarray(self.blocks, np.int64)[pos // bs] * bs + pos % bs


# ---------------------------------------------------------------------------
# Prefix index (vLLM-style automatic prefix caching)
# ---------------------------------------------------------------------------

def chunk_hashes(tokens: Sequence[int], block_size: int) -> List[int]:
    """Chained hash of each FULL block-aligned token chunk: hash j covers
    tokens [0, (j+1)*block_size), so equal hash <=> equal prefix (modulo
    hash collisions, negligible for host-side dedup). Partial tail chunks
    are never hashed — only whole blocks are shareable."""
    out: List[int] = []
    h = 0
    for j in range(len(tokens) // block_size):
        chunk = tuple(int(t) for t in
                      tokens[j * block_size:(j + 1) * block_size])
        h = hash((h, chunk))
        out.append(h)
    return out


class PrefixIndex:
    """Chained-hash -> resident physical block, one per FULL prompt chunk.

    The index holds ONE reference on every block it maps, so a cached
    prefix outlives the request that wrote it. A block whose only
    remaining reference is the index's is EVICTABLE; ``evict`` frees
    such blocks LRU-first when the pool runs dry. ``acquire`` increfs
    matched blocks on behalf of a new request (which releases them through
    its BlockTable like any other block).
    """

    def __init__(self, pool: BlockPool):
        assert pool.observer is None, "one PrefixIndex per pool"
        self.pool = pool
        pool.observer = self
        self._block_of: dict = {}            # chain hash -> block id
        self._hash_of: dict = {}             # block id -> chain hash
        self._lru: OrderedDict = OrderedDict()   # block id -> None, LRU order
        # indexed blocks whose ONLY reference is the index's, kept O(1)
        # through the pool's ref-transition notifications
        self._evictable = 0
        # optional demotion hook: ``spill(chain_hash, block_id)`` runs for
        # every evicted block BEFORE its pool slot is freed (page contents
        # still valid on device), turning eviction into device -> host
        # demotion when a HostPagePool is wired (serving.continuous)
        self.spill = None

    # ---- BlockPool observer hooks (1 <-> 2 ref transitions) -------------
    def _ref_fell_to_one(self, bid: int) -> None:
        if bid in self._hash_of:
            self._evictable += 1

    def _ref_rose_above_one(self, bid: int) -> None:
        if bid in self._hash_of:
            self._evictable -= 1

    def __len__(self) -> int:
        return len(self._block_of)

    def match_len(self, hashes: Sequence[int]) -> int:
        """Length (in blocks) of the longest indexed prefix of `hashes`."""
        n = 0
        for h in hashes:
            if h not in self._block_of:
                break
            n += 1
        return n

    def lookup(self, h: int) -> Optional[int]:
        """Resident block id for chain hash `h` (None = not indexed); no
        refcount or LRU side effects — tier planning and cluster export
        peek without claiming."""
        return self._block_of.get(h)

    def acquire(self, hashes: Sequence[int]) -> List[int]:
        """Alias the indexed prefix `hashes` (all must be resident):
        increfs every block on the caller's behalf and marks it
        recently-used. The caller owns the new references."""
        blocks = []
        for h in hashes:
            bid = self._block_of[h]
            self.pool.incref(bid)
            blocks.append(bid)
        # LRU-touch in REVERSE chain order so the chain's HEAD ends up the
        # most recently used: chained hashes only ever match head-first,
        # so eviction must trim a chain TAIL-first
        for bid in reversed(blocks):
            self._lru.move_to_end(bid)
        return blocks

    def register(self, hashes: Sequence[int], blocks: Sequence[int]) -> int:
        """Index freshly written blocks under their chunk hashes (incref —
        the index's own reference). Hashes already resident are skipped:
        the first writer stays canonical. Returns the number of new
        entries."""
        added = 0
        new: List[int] = []
        for h, bid in zip(hashes, blocks):
            if h in self._block_of:
                continue
            assert bid not in self._hash_of, (bid, "indexed twice")
            self.pool.incref(bid)
            self._block_of[h] = bid
            self._hash_of[bid] = h
            self._lru[bid] = None
            new.append(bid)
            added += 1
        # same reverse-order touch as acquire: heads newer than tails
        for bid in reversed(new):
            self._lru.move_to_end(bid)
        return added

    def indexed_blocks(self) -> List[int]:
        """Every block id the index currently holds a reference on
        (KVSAN's refcount-conservation audit enumerates these)."""
        return list(self._hash_of)

    def n_evictable(self) -> int:
        """Blocks reclaimable right now (referenced only by the index)."""
        return self._evictable

    def evict(self, n: int) -> int:
        """Free up to `n` evictable blocks, least-recently-used first;
        returns how many were freed."""
        freed = 0
        for bid in list(self._lru):
            if freed >= n:
                break
            if self.pool.ref(bid) != 1:
                continue                      # still aliased by a request
            h = self._hash_of.pop(bid)
            del self._block_of[h]
            del self._lru[bid]
            self._evictable -= 1
            if self.spill is not None:
                self.spill(h, bid)            # demote before the slot frees
            self.pool.free(bid)               # 1 -> 0: back to the free list
            freed += 1
        return freed

    def clear(self) -> None:
        """Drop every cached prefix (frees the index's references). A reset,
        not pressure: nothing spills to the host tier."""
        for bid in list(self._lru):
            h = self._hash_of.pop(bid)
            del self._block_of[h]
            del self._lru[bid]
            self.pool.free(bid)
        self._evictable = 0


# ---------------------------------------------------------------------------
# Host-memory page tier (device -> host demotion)
# ---------------------------------------------------------------------------

class HostPagePool:
    """Host-memory (CPU DRAM) tier for demoted prefix pages.

    Device eviction under pool pressure DEMOTES a prefix block's page
    payload here instead of deleting it, keyed by the same chained chunk
    hash the ``PrefixIndex`` uses; a later prompt that matches the hash
    PROMOTES the payload back into a fresh device block (``get`` pops —
    every page lives in exactly one tier). Capacity is counted in blocks
    and enforced LRU, like the device index but with true deletion at the
    bottom of the hierarchy (``on_evict`` lets the cluster directory track
    the final drop).

    The payload is opaque to the pool: the engine stores one pytree per
    stage layer (``{"k","v"[,"k_scale","v_scale"]}`` torch tensors in host
    memory, leading axis = one block) captured at POOL precision, so
    quantized pages spill at their narrow width and re-land verbatim.
    """

    def __init__(self, capacity: int, block_size: int):
        if capacity < 1:
            raise ValueError("host tier needs at least one block")
        self.capacity = capacity
        self.block_size = block_size
        self._pages: OrderedDict = OrderedDict()   # chain hash -> payload
        # callback(chain_hash) when the LRU bound drops an entry — the page
        # has now left the replica entirely (directory unpublish)
        self.on_evict = None
        self.demotions = 0         # payloads accepted (device -> host)
        self.promotions = 0        # payloads popped back out (host -> device)
        self.evictions = 0         # payloads dropped at the LRU bound

    def __len__(self) -> int:
        return len(self._pages)

    def __contains__(self, h) -> bool:
        return h in self._pages

    def match_len(self, hashes: Sequence[int]) -> int:
        """Length (in blocks) of the longest resident prefix of `hashes`."""
        n = 0
        for h in hashes:
            if h not in self._pages:
                break
            n += 1
        return n

    def put(self, h: int, payload) -> None:
        """Demote a page payload under its chain hash; over capacity the
        least-recently-touched payload is dropped (true eviction)."""
        if h in self._pages:
            self._pages.move_to_end(h)     # refresh, keep first demotion
            return
        self._pages[h] = payload
        self.demotions += 1
        while len(self._pages) > self.capacity:
            old, _ = self._pages.popitem(last=False)
            self.evictions += 1
            if self.on_evict is not None:
                self.on_evict(old)

    def get(self, h: int):
        """Promote: POP the payload for `h` (None on miss). Popping keeps
        the one-tier invariant — the caller re-registers the page on
        device, so a host copy left behind would alias it."""
        payload = self._pages.pop(h, None)
        if payload is not None:
            self.promotions += 1
        return payload

    def peek(self, h: int):
        """Read without promoting (cluster export: the payload stays
        host-resident on this replica while a COPY migrates to a peer)."""
        return self._pages.get(h)

    def restore(self, h: int, payload) -> None:
        """Undo a ``get`` whose promotion could not allocate a device
        block: the payload returns to the host tier, counter-neutral."""
        self.promotions -= 1
        self.demotions -= 1
        self.put(h, payload)

    def discard(self, h: int) -> None:
        """Drop a stale host copy without eviction accounting — the page
        was re-registered on device (one-tier invariant), the host copy
        no longer exists anywhere."""
        self._pages.pop(h, None)

    def hashes(self) -> List[int]:
        """Resident chain hashes, LRU order (KVSAN's tier audit)."""
        return list(self._pages)

    def nbytes(self) -> int:
        return int(sum(a.numel() * a.element_size()
                       for payload in self._pages.values()
                       for lkv in payload for a in lkv.values()))
