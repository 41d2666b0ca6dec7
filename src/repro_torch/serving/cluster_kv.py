"""Cluster prefix directory: replica-spanning KV residency (beyond-paper,
cf. HexGen-2's disaggregated KV transfer + Helix's routing argument).

Each replica's ``PrefixIndex`` is private: the hottest KV in a real
deployment — system prompts, few-shot headers, RAG boilerplate — is
recomputed and evicted independently on every replica. This module turns
those private caches into one cluster-wide memory hierarchy:

  * ``ClusterPrefixDirectory`` — a shared map from chained chunk hashes
    (block_manager.chunk_hashes) to per-replica residency TIER ("device"
    page pool or "host" spill pool). Engines keep it coherent on
    register / demote / promote / evict; the Router reads it to score
    replicas by resident prefix length (prefix-aware routing), and an
    engine that misses locally reads it to find a peer to fetch from.
  * ``wire_cluster_prefix`` — attaches one directory + the peer table +
    a ``KVLink`` transfer model to every ``PagedPipelineBatcher``, the
    same wiring shape as ``disagg.wire_disaggregation``.

The directory is a HINT, not ground truth: a stale entry (the peer
evicted the page after publishing) makes the fetch fail gracefully — the
exporter returns None, the reader unpublishes the entry and prefills the
remainder cold. Token streams therefore never depend on directory
coherence, only the amount of recompute does.

Hot-prefix migration itself lives engine-side
(``continuous.PagedPipelineBatcher._materialize_hash`` /
``export_prefix_block``) and reuses the disaggregation wire format:
per-GLOBAL-layer ``{"k","v"[,scales]}`` page payloads
(``KVMigration``-shaped, so source and destination may split stages
differently) charged at ``KVLink.delay`` on the serving clock.

Port of repro.serving.cluster_kv, line for line.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.disagg import KVLink

TIERS = ("device", "host")


class ClusterPrefixDirectory:
    """Chained chunk hash -> {replica_id: tier} residency map.

    ``publish`` upserts one replica's tier for a hash (a promotion or
    demotion just re-publishes at the new tier); ``unpublish`` drops the
    replica's claim entirely (the page left both tiers). Reads never
    mutate.
    """

    def __init__(self):
        self._res: Dict[int, Dict[int, str]] = {}

    def __len__(self) -> int:
        return len(self._res)

    def publish(self, h: int, replica: int, tier: str) -> None:
        assert tier in TIERS, tier
        self._res.setdefault(h, {})[replica] = tier

    def unpublish(self, h: int, replica: int) -> None:
        m = self._res.get(h)
        if m is None:
            return
        m.pop(replica, None)
        if not m:
            del self._res[h]

    def tier(self, h: int, replica: int) -> Optional[str]:
        return self._res.get(h, {}).get(replica)

    def holders(self, h: int, exclude: Optional[int] = None
                ) -> List[Tuple[int, str]]:
        """Replicas holding `h`, device tier first (an export from device
        pages skips the peer's swap-in), then by lowest replica id —
        deterministic fetch sourcing."""
        out = [(rid, t) for rid, t in self._res.get(h, {}).items()
               if rid != exclude]
        out.sort(key=lambda rt: (TIERS.index(rt[1]), rt[0]))
        return out

    def entries_for(self, replica: int) -> List[Tuple[int, str]]:
        """Every (hash, tier) this replica has published — KVSAN audits
        these against the replica's actual index / host-tier residency."""
        return [(h, m[replica]) for h, m in self._res.items()
                if replica in m]

    def resident_blocks(self, hashes: Sequence[int], replica: int
                        ) -> Tuple[int, int]:
        """(device_blocks, host_blocks) of the longest prefix of `hashes`
        resident on `replica` in ANY tier. Chained hashes only match
        head-first, so the walk stops at the first gap — exactly what a
        prefix-aware router should credit the replica for."""
        ndev = nhost = 0
        for h in hashes:
            t = self._res.get(h, {}).get(replica)
            if t == "device":
                ndev += 1
            elif t == "host":
                nhost += 1
            else:
                break
        return ndev, nhost


def wire_cluster_prefix(workers: Sequence, link: Optional[KVLink] = None,
                        directory: Optional[ClusterPrefixDirectory] = None
                        ) -> ClusterPrefixDirectory:
    """Join every worker into one shared prefix directory. Workers must be
    ``PagedPipelineBatcher``-shaped (``replica_id`` + ``attach_cluster``);
    ``link`` models the inter-replica transfer (None = ideal
    interconnect, the right default for bit-identity smokes)."""
    directory = directory if directory is not None \
        else ClusterPrefixDirectory()
    link = link if link is not None else KVLink()
    peers = {w.replica_id: w for w in workers}
    assert len(peers) == len(workers), "replica ids must be unique"
    for w in workers:
        w.attach_cluster(directory, peers, link)
    return directory
