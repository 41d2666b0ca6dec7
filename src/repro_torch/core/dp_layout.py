"""Algorithm 1: dynamic programming over (stage, type-vector) to find the
optimal per-stage GPU allocation of ONE pipeline, given a layer partition.

Faithful to the paper with one refinement (documented in DESIGN.md): the
paper's DP state tracks GPU-*type* counts and relies on the heuristic that a
TP group uses one type on one machine; we track per-*machine* counts (a
machine's GPUs are one type, and machines are what the comm matrices
distinguish), and extend the state with the previous stage's machine so the
PP link cost is exact rather than estimated.

The EM heuristic from §4.3 ("Determine the pipeline partitions") is also
here: even split -> DP -> layers proportional to assigned stage memory -> DP.

The port's copy of repro.core.dp_layout, on the port's cost model and
plan; nothing is left out.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import cost_model as cm
from repro_torch.core.cluster import Cluster
from repro_torch.core.plan import PipelinePlan, StagePlan

TP_CANDIDATES = (1, 2, 4, 8)


def _pools(cluster: Cluster, device_ids: Sequence[int]) -> Dict[int, List[int]]:
    """machine -> device ids available in this pipeline group."""
    pools: Dict[int, List[int]] = {}
    for d in sorted(device_ids):
        pools.setdefault(cluster.devices[d].machine, []).append(d)
    return pools


def dp_assign(cluster: Cluster, device_ids: Sequence[int],
              layer_split: Sequence[int], model: cm.ModelProfile,
              task: cm.Task,
              tp_candidates: Sequence[int] = TP_CANDIDATES
              ) -> Optional[List[List[int]]]:
    """Returns per-stage device-id lists minimizing Eq. 2, or None."""
    pools = _pools(cluster, device_ids)
    machines = sorted(pools)
    S = len(layer_split)

    # devices within a machine are interchangeable -> memoize stage terms
    @functools.lru_cache(maxsize=None)
    def stage_cost(mi: int, tp: int, l: int) -> float:
        devs = pools[machines[mi]][:tp]
        if not cm.mem_ok(cluster, devs, l, model, task):
            return float("inf")
        return cm.comp_cost(cluster, devs, l, model, task) \
            + cm.comm_tp_cost(cluster, devs, l, model, task)

    @functools.lru_cache(maxsize=None)
    def pp_cost(prev_mi: int, mi: int) -> float:
        prev_dev = [pools[machines[prev_mi]][0]]
        devs = [pools[machines[mi]][0]]
        return cm.comm_pp_cost(cluster, prev_dev, devs, task, model)

    @functools.lru_cache(maxsize=None)
    def best(j: int, used: Tuple[int, ...], prev_m: int
             ) -> Tuple[float, Optional[Tuple[int, int]]]:
        """Min cost of stages j.. given `used` counts; returns (cost, choice)
        where choice = (machine_index, tp)."""
        if j == S:
            return 0.0, None
        out = (float("inf"), None)
        for mi, m in enumerate(machines):
            avail = len(pools[m]) - used[mi]
            for tp in tp_candidates:
                if tp > avail:
                    continue
                c = stage_cost(mi, tp, layer_split[j])
                if c == float("inf"):
                    continue
                if prev_m >= 0:
                    c += pp_cost(prev_m, mi)
                used2 = tuple(u + (tp if i == mi else 0)
                              for i, u in enumerate(used))
                rest, _ = best(j + 1, used2, mi)
                if c + rest < out[0]:
                    out = (c + rest, (mi, tp))
        return out

    cost, _ = best(0, tuple(0 for _ in machines), -1)
    if cost == float("inf"):
        return None

    # back-track
    stages: List[List[int]] = []
    used = tuple(0 for _ in machines)
    prev_m = -1
    for j in range(S):
        _, choice = best(j, used, prev_m)
        mi, tp = choice
        m = machines[mi]
        stages.append(pools[m][used[mi]:used[mi] + tp])
        used = tuple(u + (tp if i == mi else 0) for i, u in enumerate(used))
        prev_m = mi
    return stages


def _even_split(L: int, S: int) -> List[int]:
    base = L // S
    rem = L % S
    return [base + (1 if j < rem else 0) for j in range(S)]


def _mem_proportional_split(cluster: Cluster, stages: List[List[int]],
                            L: int) -> List[int]:
    caps = [sum(cluster.devices[d].spec.mem_bytes for d in devs)
            for devs in stages]
    tot = sum(caps)
    raw = [c / tot * L for c in caps]
    split = [max(1, int(round(r))) for r in raw]
    # fix rounding to sum exactly to L
    while sum(split) > L:
        i = max(range(len(split)), key=lambda i: split[i] - raw[i])
        if split[i] > 1:
            split[i] -= 1
        else:
            break
    while sum(split) < L:
        i = min(range(len(split)), key=lambda i: split[i] - raw[i])
        split[i] += 1
    return split


# DP state-space guard: above this, fall back to the greedy machine-per-stage
# layout (giant merged groups appear transiently during genetic search and
# are rarely competitive; the exact DP still covers every realistic group).
MAX_DP_STATES = 300_000


def _greedy_layout(cluster: Cluster, device_ids: Sequence[int],
                   model: cm.ModelProfile, task: cm.Task
                   ) -> Optional[PipelinePlan]:
    """Each machine = one stage (TP = machine size), layers ∝ memory."""
    pools = _pools(cluster, device_ids)
    stages = [devs for _, devs in sorted(pools.items())]
    L = model.num_layers
    split = _mem_proportional_split(cluster, stages, L)
    cost = cm.pipeline_cost(cluster, stages, split, model, task)
    if cost == float("inf"):
        return None
    bott = cm.pipeline_bottleneck(cluster, stages, split, model, task)
    return PipelinePlan(
        stages=[StagePlan(list(devs), l) for devs, l in zip(stages, split)],
        cost=cost, bottleneck=bott)


def optimize_pipeline(cluster: Cluster, device_ids: Sequence[int],
                      model: cm.ModelProfile, task: cm.Task, *,
                      max_stages: int = 8,
                      tp_candidates: Sequence[int] = TP_CANDIDATES,
                      em_iters: int = 2) -> Optional[PipelinePlan]:
    """Search stage count + EM layer partition + DP GPU assignment for one
    pipeline group. Returns the best PipelinePlan or None if infeasible."""
    L = model.num_layers
    best_plan: Optional[PipelinePlan] = None
    # quick feasibility: total memory must hold one model copy
    B = task.bytes_per_el
    total_mem = sum(cluster.devices[d].spec.mem_bytes for d in device_ids)
    if total_mem < model.params_per_layer * L * B:
        return None
    pools = _pools(cluster, device_ids)
    states = max_stages * len(pools)
    for devs in pools.values():
        states *= len(devs) + 1
    if states > MAX_DP_STATES:
        return _greedy_layout(cluster, device_ids, model, task)
    for S in range(1, min(max_stages, len(device_ids)) + 1):
        split = _even_split(L, S)
        stages = None
        for _ in range(em_iters):
            got = dp_assign(cluster, device_ids, split, model, task,
                            tp_candidates)
            if got is None:
                break
            stages = got
            new_split = _mem_proportional_split(cluster, stages, L)
            if new_split == split:
                break
            split = new_split
        if stages is None:
            continue
        cost = cm.pipeline_cost(cluster, stages, split, model, task)
        if cost == float("inf"):
            continue
        bott = cm.pipeline_bottleneck(cluster, stages, split, model, task)
        plan = PipelinePlan(
            stages=[StagePlan(list(devs), l) for devs, l in zip(stages, split)],
            cost=cost, bottleneck=bott)
        if best_plan is None or plan.cost < best_plan.cost:
            best_plan = plan
    return best_plan
