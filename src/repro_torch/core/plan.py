"""Plan dataclasses: the output of the scheduler.

An Assignment maps the device pool onto independent inference pipelines
(model replicas); each pipeline is a list of stages; each stage owns a
disjoint GPU set (its tensor-parallel group) and a contiguous span of layers.
This mirrors the paper's sigma: D -> {(d_ij, l_ij)}.

A DeploymentPlan is the UNIFIED plan surface on top of that: one
ReplicaSpec per replica carrying the pipeline layout plus every per-replica
serving decision the search makes (disaggregated role, speculation depth,
KV pool precision, host-tier capacity). The online rescheduler diffs two
DeploymentPlans to compute the migrations that turn one into the other.

The port's copy of repro.core.plan. Where the reference asserts (a layer
split that does not sum, a device assigned twice, a per-replica list of
the wrong length, duplicate device sets in a diff), the port raises
ValueError.
"""
from __future__ import annotations

import dataclasses
from typing import FrozenSet, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class StagePlan:
    device_ids: List[int]          # the TP group (>=1 devices, same machine/type)
    num_layers: int                # l_ij

    @property
    def tp_degree(self) -> int:
        return len(self.device_ids)


@dataclasses.dataclass
class PipelinePlan:
    stages: List[StagePlan]
    cost: float = float("inf")     # end-to-end latency estimate (Eq. 2)
    bottleneck: float = 0.0        # max per-stage time (pipelining throughput)

    @property
    def device_ids(self) -> List[int]:
        return [d for s in self.stages for d in s.device_ids]

    @property
    def layer_split(self) -> List[int]:
        return [s.num_layers for s in self.stages]

    def describe(self) -> str:
        return "[" + ",".join(str(s.tp_degree) for s in self.stages) + "]" \
            + " layers=" + str(self.layer_split)


@dataclasses.dataclass
class Assignment:
    pipelines: List[PipelinePlan]

    def validate(self, total_layers: int) -> None:
        seen = set()
        for p in self.pipelines:
            if sum(s.num_layers for s in p.stages) != total_layers:
                raise ValueError(f"layer split {p.layer_split} does not sum "
                                 f"to {total_layers}")
            for d in p.device_ids:
                if d in seen:
                    raise ValueError(f"device {d} assigned twice")
                seen.add(d)

    @property
    def num_replicas(self) -> int:
        return len(self.pipelines)

    def describe(self) -> str:
        return "; ".join(p.describe() for p in self.pipelines)


# ---------------------------------------------------------------------------
# The unified plan surface
# ---------------------------------------------------------------------------

# the per-replica dimensions a search may (or may not) have decided; a
# DeploymentPlan records WHICH were searched so "dimension off" and
# "dimension chose the default" stay distinguishable
PLAN_DIMS = ("roles", "spec", "kv_dtype", "host_tier")


@dataclasses.dataclass
class ReplicaSpec:
    """One replica's complete serving contract: its pipeline layout plus
    every per-replica decision the scheduler made for it."""

    pipeline: PipelinePlan
    role: str = "both"             # "prefill" | "decode" | "both"
    spec_k: int = 0                # speculation depth (0 = plain decode)
    kv_dtype: Optional[str] = None  # pool precision (None = model default)
    host_blocks: int = 0           # host page tier capacity in blocks

    @property
    def device_ids(self) -> List[int]:
        return self.pipeline.device_ids

    @property
    def key(self) -> FrozenSet[int]:
        """Replica identity for plan diffing: the device set is disjoint
        across a valid plan, so it names the replica across re-solves."""
        return frozenset(self.pipeline.device_ids)

    def describe(self) -> str:
        bits = [self.pipeline.describe()]
        if self.role != "both":
            bits.append(self.role)
        if self.spec_k:
            bits.append(f"k={self.spec_k}")
        if self.kv_dtype:
            bits.append(self.kv_dtype)
        if self.host_blocks:
            bits.append(f"host={self.host_blocks}")
        return " ".join(bits)


@dataclasses.dataclass
class PlanDiff:
    """The migrations turning one DeploymentPlan into another.

    Replicas are matched by device-set identity (`ReplicaSpec.key`):
    `removed` replicas exist only in the old plan (their in-flight slots
    must evacuate or migrate), `added` only in the new one, and `changed`
    pairs share devices but differ in layout or any serving dimension
    (role flips re-wire the dispatcher; the executor moves decoding slots
    off replicas that lose decode capability)."""

    removed: List[ReplicaSpec] = dataclasses.field(default_factory=list)
    added: List[ReplicaSpec] = dataclasses.field(default_factory=list)
    changed: List[Tuple[ReplicaSpec, ReplicaSpec]] = \
        dataclasses.field(default_factory=list)      # (old, new) pairs
    dims: FrozenSet[str] = frozenset()               # target plan's dims

    @property
    def is_empty(self) -> bool:
        return not (self.removed or self.added or self.changed)

    def describe(self) -> str:
        if self.is_empty:
            return "no-op"
        bits = []
        if self.removed:
            bits.append("-[" + "; ".join(r.describe()
                                         for r in self.removed) + "]")
        if self.added:
            bits.append("+[" + "; ".join(r.describe()
                                         for r in self.added) + "]")
        for old, new in self.changed:
            bits.append(f"{old.describe()} -> {new.describe()}")
        return ", ".join(bits)


@dataclasses.dataclass
class DeploymentPlan:
    """Per-replica ReplicaSpecs plus the set of searched dimensions.

    This replaces SearchResult's parallel-list fields (roles / spec_ks /
    kv_dtypes / host_blocks): every per-replica decision lives on the
    replica it belongs to, and `dims` records which dimensions the search
    actually ran — the legacy list properties return None for a dimension
    that was never searched, exactly like the old fields did."""

    replicas: List[ReplicaSpec]
    dims: FrozenSet[str] = frozenset()

    @classmethod
    def from_search(cls, assignment: Assignment, *,
                    roles: Optional[Sequence[str]] = None,
                    spec_ks: Optional[Sequence[int]] = None,
                    kv_dtypes: Optional[Sequence[Optional[str]]] = None,
                    host_blocks: Optional[Sequence[int]] = None
                    ) -> "DeploymentPlan":
        """Zip the legacy parallel lists into per-replica specs. A None
        list means that dimension was not searched (dims omits it)."""
        n = assignment.num_replicas
        for name, lst in (("roles", roles), ("spec_ks", spec_ks),
                          ("kv_dtypes", kv_dtypes),
                          ("host_blocks", host_blocks)):
            if lst is not None and len(lst) != n:
                raise ValueError(f"{name} {list(lst)} has {len(lst)} "
                                 f"entries for {n} replicas")
        reps = [ReplicaSpec(
            pipeline=p,
            role=roles[i] if roles is not None else "both",
            spec_k=int(spec_ks[i]) if spec_ks is not None else 0,
            kv_dtype=kv_dtypes[i] if kv_dtypes is not None else None,
            host_blocks=int(host_blocks[i]) if host_blocks is not None
            else 0)
            for i, p in enumerate(assignment.pipelines)]
        dims = frozenset(d for d, lst in (("roles", roles),
                                          ("spec", spec_ks),
                                          ("kv_dtype", kv_dtypes),
                                          ("host_tier", host_blocks))
                         if lst is not None)
        return cls(replicas=reps, dims=dims)

    # ---- views -----------------------------------------------------------
    @property
    def assignment(self) -> Assignment:
        return Assignment([r.pipeline for r in self.replicas])

    @property
    def num_replicas(self) -> int:
        return len(self.replicas)

    @property
    def roles(self) -> Optional[List[str]]:
        return [r.role for r in self.replicas] if "roles" in self.dims \
            else None

    @property
    def spec_ks(self) -> Optional[List[int]]:
        return [r.spec_k for r in self.replicas] if "spec" in self.dims \
            else None

    @property
    def kv_dtypes(self) -> Optional[List[Optional[str]]]:
        return [r.kv_dtype for r in self.replicas] \
            if "kv_dtype" in self.dims else None

    @property
    def host_blocks(self) -> Optional[List[int]]:
        return [r.host_blocks for r in self.replicas] \
            if "host_tier" in self.dims else None

    def validate(self, total_layers: int) -> None:
        self.assignment.validate(total_layers)

    def describe(self) -> str:
        return "; ".join(r.describe() for r in self.replicas)

    # ---- diff / apply ----------------------------------------------------
    def canonical(self) -> "DeploymentPlan":
        """Replicas in a device-order-independent canonical order, so two
        plans built through different routes compare equal."""
        return DeploymentPlan(
            replicas=sorted(self.replicas, key=lambda r: sorted(r.key)),
            dims=self.dims)

    def diff(self, new: "DeploymentPlan") -> PlanDiff:
        """Migrations turning `self` into `new`, keyed by device set."""
        mine = {r.key: r for r in self.replicas}
        theirs = {r.key: r for r in new.replicas}
        if len(mine) != len(self.replicas) \
                or len(theirs) != len(new.replicas):
            raise ValueError("duplicate device sets")
        removed = [mine[k] for k in mine if k not in theirs]
        added = [theirs[k] for k in theirs if k not in mine]
        changed = [(mine[k], theirs[k]) for k in mine
                   if k in theirs and mine[k] != theirs[k]]
        return PlanDiff(removed=removed, added=added, changed=changed,
                        dims=new.dims)

    def apply(self, diff: PlanDiff) -> "DeploymentPlan":
        """Apply a diff; `a.apply(a.diff(b)).canonical() == b.canonical()`
        round-trips by construction (the property test's contract)."""
        gone = {r.key for r in diff.removed}
        swap = {old.key: new for old, new in diff.changed}
        reps = [swap.get(r.key, r) for r in self.replicas
                if r.key not in gone]
        reps.extend(diff.added)
        return DeploymentPlan(replicas=reps, dims=diff.dims).canonical()
