"""Plan dataclasses (copy of repro.core.plan's StagePlan, PipelinePlan and
Assignment): an Assignment maps devices onto model replicas; each replica
is a pipeline of stages; each stage owns a device group (its tensor-parallel
group) and a contiguous span of layers. The paper's sigma: D -> {(d_ij,
l_ij)}. DeploymentPlan and the scheduler wait for a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import List


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
