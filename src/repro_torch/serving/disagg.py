"""Disaggregated prefill/decode serving: KV handoff between replicas.

HexGen serves each request on ONE asymmetric pipeline; its successor
(HexGen-2, cf. DistServe/Splitwise) splits the two inference phases across
replicas — prefill runs on compute-rich replicas, decode on memory-rich
ones — because the phases want opposite hardware: prefill is a
compute-bound burst over the whole prompt, decode is a memory-bandwidth
drip that monopolizes KV capacity. Colocating them makes long prefills
stall every in-flight decode (TTFT/TPOT interference); splitting them
turns the interference into an explicit, schedulable NETWORK transfer.

The paged KV subsystem makes that transfer cheap to express: a finished
prefill's cache is a set of fixed-size pages plus a block table, so the
handoff is "gather the pages, ship the bytes, scatter them into the
destination pool and hand over the table" — not a cache-layout rewrite.

This module holds the host-side pieces:

  * ``KVMigration`` — the wire format: per-LAYER page payloads (keyed by
    global layer so source and destination pipelines may split stages
    differently), the cached token count, and the sampling state (last
    prefill logits) the decode replica resumes from.
  * ``KVLink``     — the transfer model: ``delay(bytes, src, dst)`` on the
    serving clock, either a flat gigabit figure (``--kv-link-gbps``) or
    per-replica-pair alpha-beta costs from ``core.cluster`` matrices.
  * ``KVDispatcher`` — picks the decode replica by queue depth and delivers
    the migration at ``now + delay``.

Engine-side mechanics (extract/scatter, slot resume) live in
``serving.pipeline`` and ``serving.continuous``; the scheduler-side role
search lives in ``core.genetic`` / ``core.slo_sim``.

Port of repro.serving.disagg. The wire payloads are torch tensors, not
numpy arrays (numpy holds neither bf16 nor fp8): pages extracted on the
card stay on it, since every replica of the port shares one device, and
the modelled transfer is ``KVLink.delay`` on the serving clock, as in the
reference. ``payload_bytes`` counts ``numel() * element_size()``, the
reference's ``nbytes``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.obs.trace import NULL_TRACER

GBPS = 1e9 / 8.0                   # bytes per second per Gbit/s


@dataclasses.dataclass
class KVMigration:
    """One finished prefill, packaged for the wire.

    ``layer_kv[l]`` holds global layer l's page payload ``{"k", "v"}`` of
    shape (n_blocks, block_size, kv_heads, head_dim) (torch tensors at
    pool precision, plus ``k_scale`` / ``v_scale`` on quantized pools) —
    whole blocks, the
    partial tail block travelling with its (masked, never-read) garbage.
    ``last_logits`` is the prefill's last-position logits: greedy decode on
    the destination argmaxes exactly what the colocated engine would have,
    so the handoff is bit-invisible to the token stream.

    ``out_tokens`` rides along for MID-DECODE migrations (the online
    rescheduler moving a live slot between layouts): the tokens the source
    already emitted, so the destination resumes the stream mid-flight
    instead of restarting it. ``n_tokens`` then counts prompt + emitted
    tokens resident in the pages. None for the ordinary prefill handoff.
    """

    req: object                    # serving.request.Request
    n_tokens: int                  # prompt tokens resident in the pages
    block_size: int
    layer_kv: List[Dict[str, "torch.Tensor"]]
    last_logits: np.ndarray        # (vocab,) float32 sampling state
    kv_bytes: int                  # payload size, drives the transfer model
    out_tokens: Optional[np.ndarray] = None   # emitted tokens (live move)

    @staticmethod
    def payload_bytes(layer_kv: Sequence[Dict[str, "torch.Tensor"]]) -> int:
        return int(sum(a.numel() * a.element_size() for lkv in layer_kv
                       for a in lkv.values()))


class KVLink:
    """Transfer-time model for KV handoffs, in serving-clock units.

    Flat mode (``KVLink(gbps=...)``) charges ``bytes / bandwidth`` plus a
    fixed latency for every pair — the ``--kv-link-gbps`` surface knob;
    ``gbps=0`` means an ideal (instantaneous) interconnect, the right
    default for bit-identity smokes. ``from_cluster`` derives PER-PAIR
    alpha-beta costs from the pool's comm matrices: the transfer takes the
    best link between the source replica's last stage and the destination
    replica's first stage, exactly like the cost model's pipeline-comm
    term (cost_model.comm_pp_cost).
    """

    def __init__(self, gbps: float = 0.0, latency: float = 0.0):
        self.bandwidth = gbps * GBPS if gbps > 0 else float("inf")
        self.latency = latency
        self._pairs: Optional[Dict] = None   # (src, dst) -> (lat, bw)

    @classmethod
    def from_cluster(cls, cluster, replica_devices: Sequence[Sequence[int]],
                     src_stage_devices: Optional[Sequence[Sequence[int]]]
                     = None,
                     dst_stage_devices: Optional[Sequence[Sequence[int]]]
                     = None) -> "KVLink":
        """Per-pair link costs from ``core.cluster.Cluster`` matrices.

        ``replica_devices[i]`` are replica i's global device ids (used for
        both endpoints unless the finer-grained ``src_stage_devices`` /
        ``dst_stage_devices`` — last-stage and first-stage ids — are
        given)."""
        link = cls()
        src = (list(src_stage_devices) if src_stage_devices is not None
               else [list(d) for d in replica_devices])
        dst = (list(dst_stage_devices) if dst_stage_devices is not None
               else [list(d) for d in replica_devices])
        pairs = {}
        for i, sd in enumerate(src):
            for j, dd in enumerate(dst):
                if i == j:
                    continue
                # keep every Pareto-optimal (lat, bw) candidate: which
                # link is best depends on the payload size, so the winner
                # is chosen per transfer in delay() — exactly the
                # min(lat + bytes/bw) criterion the scheduler's role
                # search scores with (genetic.Evaluator._pair_delay_fn)
                cands = sorted({(float(cluster.lat[a, b]),
                                 float(cluster.bw[a, b]))
                                for a in sd for b in dd})
                pareto = []
                best_bw = -1.0
                for lat, bw in cands:          # lat ascending
                    if bw > best_bw:
                        pareto.append((lat, bw))
                        best_bw = bw
                pairs[(i, j)] = pareto
        link._pairs = pairs
        return link

    def delay(self, n_bytes: int, src: int = 0, dst: int = 0) -> float:
        if self._pairs is not None:
            return min(lat + (n_bytes / bw if np.isfinite(bw) else 0.0)
                       for lat, bw in self._pairs[(src, dst)])
        xfer = n_bytes / self.bandwidth if np.isfinite(self.bandwidth) \
            else 0.0
        return self.latency + xfer


class KVDispatcher:
    """Routes finished prefills to decode replicas.

    The destination is the decode replica with the smallest queue depth
    (resident + queued + in-transit migrations — each worker's ``load``),
    mirroring the router's least-loaded arrival dispatch one phase later.
    """

    def __init__(self, targets: Sequence, link: Optional[KVLink] = None):
        assert targets, "disaggregation needs at least one decode replica"
        self.targets = list(targets)
        self.link = link if link is not None else KVLink()
        self.tracer = NULL_TRACER      # Router.serve swaps in the live one

    def send(self, src, mig: KVMigration, now: float) -> float:
        """Deliver `mig` to the least-loaded decode replica; returns the
        arrival (ready) time on the serving clock."""
        dst = min(self.targets, key=lambda w: (w.load(now), w.replica_id))
        delay = self.link.delay(mig.kv_bytes,
                                getattr(src, "replica_id", 0),
                                dst.replica_id)
        ready = now + delay
        if self.tracer.enabled:
            self.tracer.complete("kv_migration", delay, ts=now,
                                 pid=getattr(src, "replica_id", 0),
                                 rid=mig.req.rid, dst=dst.replica_id,
                                 bytes=mig.kv_bytes)
        dst.migrate_in(mig, ready)
        return ready


def wire_disaggregation(workers: Sequence, roles: Sequence[str],
                        link: Optional[KVLink] = None) -> Optional[KVDispatcher]:
    """Attach a shared KVDispatcher to every prefill worker, targeting the
    decode workers. Roles: "prefill" | "decode" | "both"; all-"both" is
    colocated serving and returns None. Used by the Router and directly by
    benches/tests that build workers by hand."""
    assert len(workers) == len(roles)
    for i, w in enumerate(workers):
        w.replica_id = i
    if all(r == "both" for r in roles):
        return None
    prefills = [w for w, r in zip(workers, roles) if r == "prefill"]
    decodes = [w for w, r in zip(workers, roles) if r == "decode"]
    assert prefills and decodes, \
        f"disaggregation needs >=1 prefill and >=1 decode replica: {roles}"
    disp = KVDispatcher(decodes, link)
    for w in prefills:
        w.dispatcher = disp
    return disp
