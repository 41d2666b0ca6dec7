"""Online rescheduling executor: the serve loop's closed feedback loop.

``OnlineRescheduler`` is a CONTROLLER THAT RIDES THE SERVE LOOP as one
more worker (the replica port of ``serving.loop``): it never admits
requests (capacity 0), but each cycle it may

  1. execute scheduled replica kills (chaos injection) or react to
     deaths reported by the caller,
  2. poll the drift detector (core.resched.DriftDetector) and, when a
     signal fires, invoke the re-solve callback and apply the new layout
     through the live migration executor, and
  3. re-dispatch orphaned requests onto surviving replicas.

Membership is DYNAMIC: the controller mutates the same ``workers`` list
the loop re-reads every cycle (serving.loop grew per-cycle registration
for exactly this), so a removed replica stops receiving work next
iteration and an added one becomes a dispatch candidate immediately.

Token safety is the invariant the whole design hangs on:

  * a PLANNED move extracts a decoding slot's pages + sampling state +
    emitted tokens (``PagedPipelineBatcher.extract_live_slots``) and
    re-seeds them at the destination (``_place_migrations``) — the
    stream continues exactly where it stopped, never re-emitting or
    skipping a token;
  * a KILL loses the replica's pages, so its requests re-dispatch from
    their prompts — greedy decode regenerates the identical stream, so
    failure costs latency, never correctness ("never a wrong token, at
    worst a cold re-prefill").

The port's copy of repro.serving.resched. Live moves carry torch page
payloads at pool precision (their scales with them on int8 / fp8 pools,
``PagedPipelineBatcher.extract_live_slots``). Where the reference asserts
on a caller's arguments (a role list of the wrong length, a split with
only one side, an unbound controller), the port raises ValueError or
RuntimeError.
"""
from __future__ import annotations

import weakref
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.core.resched import DriftDetector, DriftSignal
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serving.disagg import KVDispatcher, KVLink
from repro_torch.serving.request import Request

__all__ = ["OnlineRescheduler", "evacuate_worker"]


def evacuate_worker(w, now: float) -> List[Request]:
    """Pull every in-flight request out of `w` and release its state.

    Real paged engines implement ``evacuate`` themselves (KVSAN-clean
    page release); analytic workers (core.slo_sim) and the static batcher
    are drained generically through their queues/heaps so the chaos
    benchmark can kill simulated replicas through the same controller."""
    if hasattr(w, "evacuate"):
        return list(w.evacuate(now))
    orphans: List[Request] = []
    for attr in ("_queue", "_pending", "_events", "_migrations"):
        store = getattr(w, attr, None)
        if store is None:
            continue
        for item in list(store):
            if isinstance(item, tuple):      # heap entries (..., request)
                orphans.append(item[-1])
            else:
                orphans.append(item)
        try:
            store.clear()
        except AttributeError:               # plain list heaps
            del store[:]
    return [r for r in orphans if isinstance(r, Request)]


class OnlineRescheduler:
    """Drift-aware controller + live migration executor, as a loop worker.

    Parameters
    ----------
    detector: optional ``core.resched.DriftDetector``; polled every cycle
        once bound. Replica kills are reported to it automatically.
    resolver: optional callback ``resolver(signal, controller, now)``
        invoked when the detector fires. It may return None (signal
        noted, nothing applied) or a dict of actions understood by
        ``apply_actions``:
          {"roles": [...]}            live role re-split of the survivors
          {"workers": [...], "roles": [...]}
                                      whole-set replacement (re-solved
                                      layout); old workers evacuate, their
                                      requests re-dispatch onto the new set
    kills: scheduled chaos events, (time, replica_id) pairs — executed on
        the serving clock. Replica ids are the workers' ``replica_id``s
        at bind time.
    link: KVLink pricing live slot moves (None = instantaneous).
    """

    def __init__(self, *, detector: Optional[DriftDetector] = None,
                 resolver: Optional[Callable] = None,
                 kills: Sequence[Tuple[float, int]] = (),
                 link: Optional[KVLink] = None):
        self.detector = detector
        self.resolver = resolver
        self._kills = sorted(kills)
        self.link = link if link is not None else KVLink()
        self._router = None
        self.workers: Optional[List] = None
        self._by_id: dict = {}
        self._orphans: List[Request] = []
        self._signal: Optional[DriftSignal] = None
        self._spec_seen = (0, 0)
        self.events: List[dict] = []
        self.redispatches = 0
        self.tracer = NULL_TRACER  # Router.bind_tracer swaps in the live one

    # ---- binding ---------------------------------------------------------
    @property
    def router(self):
        """The bound Router, held weakly: the Router holds its controller
        (``attach_controller``), and the pair would otherwise be a cycle
        that keeps every replica's pools until a full collection."""
        return self._router() if self._router is not None else None

    @router.setter
    def router(self, router) -> None:
        self._router = weakref.ref(router) if router is not None else None

    def bind(self, router) -> None:
        """Bind to a Router (its live ``workers`` list and dispatcher)."""
        self.router = router
        self.bind_workers(router.workers)

    def bind_workers(self, workers: List) -> None:
        """Bind to a bare worker list (analytic chaos benchmarks); the
        list object is shared with ``run_serve_loop`` so membership edits
        are visible to the loop."""
        self.workers = workers
        self._by_id = {getattr(w, "replica_id", i): w
                       for i, w in enumerate(workers)}

    def _peers(self) -> List:
        return [w for w in (self.workers or []) if w is not self]

    # ---- observation hooks (Router._dispatch) ----------------------------
    def observe_admit(self, now: float, req: Request) -> None:
        if self.detector is not None:
            self.detector.observe_admit(now, len(req.prompt))

    def _harvest_spec(self) -> None:
        if self.detector is None:
            return
        prop = sum(getattr(w, "spec_proposed", 0) for w in self._peers())
        acc = sum(getattr(w, "spec_accepted", 0) for w in self._peers())
        p0, a0 = self._spec_seen
        if prop > p0 or acc > a0:
            self.detector.observe_spec(prop - p0, acc - a0)
            self._spec_seen = (prop, acc)

    # ---- the replica port (serving.loop) ---------------------------------
    def capacity(self, now: float) -> int:
        return 0                   # never a dispatch candidate

    def load(self, now: float) -> float:
        return float("inf")

    def admit(self, reqs, now: float) -> None:
        raise AssertionError("the controller admits nothing")

    def inflight(self) -> int:
        # orphans keep the loop alive until they land somewhere
        return len(self._orphans)

    def next_event(self, now: float):
        for t, _ in self._kills:
            if t > now:
                return t
        return None

    def busy(self, now: float) -> bool:
        if self._kills and self._kills[0][0] <= now:
            return True
        if self._orphans and self._placeable(now):
            return True
        if self._signal is None and self.detector is not None:
            self._harvest_spec()
            self._signal = self.detector.poll(now)
        return self._signal is not None

    def _placeable(self, now: float) -> bool:
        return any(w.capacity(now) > 0 for w in self._peers())

    def run_iteration(self, now: float):
        while self._kills and self._kills[0][0] <= now:
            _, rid = self._kills.pop(0)
            self.kill(rid, now)
        if self._signal is None and self.detector is not None:
            self._harvest_spec()
            self._signal = self.detector.poll(now)
        if self._signal is not None:
            sig, self._signal = self._signal, None
            self.events.append({"t": now, "kind": "signal",
                                "what": sig.describe()})
            if self.resolver is not None:
                actions = self.resolver(sig, self, now)
                if actions:
                    self.apply_actions(actions, now)
        self._redispatch(now)
        return [], 0.0

    # ---- failure path ----------------------------------------------------
    def kill(self, replica_id, now: float) -> None:
        """Replica death: its pages are gone. Evacuate its in-flight
        requests (cold re-prefill elsewhere), remove it from the live
        membership, and repair the dispatcher wiring so the surviving
        role graph stays serveable."""
        w = self._by_id.get(replica_id)
        if w is None or w not in self._peers():
            return                 # already dead / unknown
        self._orphans.extend(evacuate_worker(w, now))
        self.workers.remove(w)
        self.events.append({"t": now, "kind": "kill",
                            "replica": replica_id,
                            "orphans": len(self._orphans)})
        if self.tracer.enabled:
            self.tracer.instant("replica_kill", ts=now, pid=replica_id,
                                orphans=len(self._orphans))
        if self.detector is not None:
            key = frozenset(getattr(w, "device_ids", ())) \
                or frozenset({replica_id})
            self.detector.observe_death(key)
        self._repair_wiring(now)

    def _repair_wiring(self, now: float) -> None:
        """Post-removal dispatcher repair: prune dead decode targets; if
        either side of a disaggregated split died out entirely, flip the
        survivors to colocated "both" — always serveable, never an
        island of prefill-only or decode-only replicas."""
        peers = self._peers()
        roles = [getattr(w, "role", "both") for w in peers]
        prefills = [w for w, r in zip(peers, roles) if r == "prefill"]
        decodes = [w for w, r in zip(peers, roles) if r == "decode"]
        disp = getattr(self.router, "dispatcher", None) \
            if self.router is not None else None
        if disp is None:
            for w in peers:
                d = getattr(w, "dispatcher", None)
                if d is not None:
                    disp = d
                    break
        if disp is not None:
            disp.targets = [t for t in disp.targets if t in peers]
        for w in peers:
            # analytic prefill workers (core.slo_sim) wire their decode
            # targets directly; prune the dead ones there too
            tg = getattr(w, "targets", None)
            if isinstance(tg, list):
                w.targets = [t for t in tg if t in peers]
        if (prefills and not decodes) or (decodes and not prefills) or \
                (disp is not None and not disp.targets and prefills):
            for w in peers:
                if getattr(w, "role", "both") != "both":
                    w.role = "both"
            if self.router is not None:
                self.router.roles = ["both"] * len(peers)
            self.events.append({"t": now, "kind": "colocate_fallback"})
        elif self.router is not None:
            self.router.roles = [getattr(w, "role", "both") for w in peers]

    # ---- planned migration (the live executor) ---------------------------
    def apply_actions(self, actions: dict, now: float) -> None:
        if "workers" in actions:
            self.replace_workers(actions["workers"], now,
                                 roles=actions.get("roles"))
        elif "roles" in actions:
            self.apply_roles(actions["roles"], now)

    def apply_roles(self, new_roles: Sequence[str], now: float) -> None:
        """Live role re-split of the surviving replicas WITHOUT draining:
        replicas losing decode capability hand their decoding slots to
        the new decode side as live migrations (pages + sampling state +
        emitted tokens); replicas turning pure-decode requeue their
        waiting arrivals for re-dispatch to a prefill-capable peer."""
        peers = self._peers()
        if len(new_roles) != len(peers):
            raise ValueError(f"roles {list(new_roles)} for {len(peers)} "
                             "replicas")
        old_roles = [getattr(w, "role", "both") for w in peers]
        decodes = [w for w, r in zip(peers, new_roles) if r == "decode"]
        prefills = [w for w, r in zip(peers, new_roles) if r == "prefill"]
        if bool(prefills) != bool(decodes):
            raise ValueError(f"roles {list(new_roles)}: a split needs "
                             "prefill and decode replicas both")
        disp = KVDispatcher(decodes, self.link) if decodes else None
        if disp is not None:
            disp.tracer = self.tracer
        for w, old, new in zip(peers, old_roles, new_roles):
            w.role = new
            if new == "prefill":
                w.dispatcher = disp
        moved = 0
        for w, old, new in zip(peers, old_roles, new_roles):
            if new == "prefill" and old in ("both", "decode") \
                    and disp is not None \
                    and hasattr(w, "extract_live_slots"):
                for mig in w.extract_live_slots(now):
                    disp.send(w, mig, now)
                    moved += 1
            if new == "decode" and hasattr(w, "_queue") and w._queue:
                # waiting arrivals need a prefill-capable home
                self._orphans.extend(w._queue)
                w._queue.clear()
        if self.router is not None:
            self.router.roles = list(new_roles)
            self.router.dispatcher = disp
        self.events.append({"t": now, "kind": "roles",
                            "roles": list(new_roles), "moved": moved})

    def replace_workers(self, new_workers: Sequence, now: float, *,
                        roles: Optional[Sequence[str]] = None) -> None:
        """Swap the whole replica set for a re-solved layout: evacuate
        every current worker (their requests re-dispatch onto the new
        set) and install the new workers in the live membership list.
        Used by re-solves that change the device partitioning itself —
        per-slot live moves only work between layouts sharing a page
        size, so a repartition restarts in-flight work from prompts
        (still token-identical under greedy decode)."""
        if self.workers is None:
            raise RuntimeError("bind the controller first")
        for w in self._peers():
            self._orphans.extend(evacuate_worker(w, now))
            self.workers.remove(w)
        insert = list(new_workers)
        if roles is not None:
            if len(roles) != len(insert):
                raise ValueError(f"roles {list(roles)} for {len(insert)} "
                                 "new workers")
            for w, r in zip(insert, roles):
                w.role = r
        if self.tracer.enabled:
            for w in insert:
                if hasattr(w, "tracer"):
                    w.tracer = self.tracer
        # keep the controller LAST so new workers admit before we run
        pos = self.workers.index(self) if self in self.workers \
            else len(self.workers)
        self.workers[pos:pos] = insert
        self._by_id.update({getattr(w, "replica_id", i): w
                            for i, w in enumerate(insert)})
        if self.router is not None:
            self.router.roles = [getattr(w, "role", "both")
                                 for w in insert]
        self.events.append({"t": now, "kind": "replace",
                            "n": len(insert)})

    # ---- orphan re-dispatch ----------------------------------------------
    def _redispatch(self, now: float) -> None:
        """Admit orphans onto surviving replicas, least-loaded first —
        the loop's own admission policy, re-applied after the membership
        change. Unplaceable orphans stay with the controller (inflight()
        keeps the loop alive) until a completion frees capacity."""
        kept: List[Request] = []
        for r in sorted(self._orphans,
                        key=lambda r: (r.arrival, r.rid)):
            cands = [w for w in self._peers() if w.capacity(now) > 0]
            if not cands:
                kept.append(r)
                continue
            w = min(cands, key=lambda c: (c.load(now),
                                          getattr(c, "replica_id", 0)))
            w.admit([r], now)
            self.redispatches += 1
        self._orphans = kept
