"""The paper's analytical cost model (Table 1 / Appendix B), plus a
generalized form that derives per-layer parameter counts, FLOPs and cache
bytes from any ModelConfig (GQA, MoE active experts, SSM state) so the same
scheduler plans every assigned architecture.

paper_exact=True reproduces Table 1 literally:
  params/layer = 12 H^2            (w_K,Q,V,O: 4H^2; w_1,w_2: 8H^2)
  FLOPs/layer  = 24 b s H^2        (2 FLOPs per param per token)
  KV bytes     = 2 b s H B_type / layer
  activation buffers = 4 b s H B_type (reused across layers)
TP comm: 4 AllReduce phases per layer (2 AllReduce = ReduceScatter+AllGather
x 2 per layer under the BSP model); PP comm: fastest link between stages.

The port's copy of repro.core.cost_model, on the port's own ModelConfig
and cluster; nothing is left out.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cluster import Cluster


@dataclasses.dataclass(frozen=True)
class Task:
    """One inference task t: batch, prompt length, output length."""
    batch: int                # b_t
    s_in: int
    s_out: int
    bytes_per_el: int = 2     # B_type (FP16/bf16)


# ---------------------------------------------------------------------------
# Quantized KV pages (models.quant.KV_DTYPES): effective cache bytes per
# element by pool storage precision. Quantized layouts add a float32
# per-token-per-head scale, amortized here over head_dim elements.
# ---------------------------------------------------------------------------

KV_DTYPE_PAYLOAD_BYTES = {"fp32": 4.0, "bf16": 2.0, "int8": 1.0, "fp8": 1.0}
_KV_QUANTIZED = ("int8", "fp8")
_KV_SCALE_HEAD_DIM = 128       # modeling default for the scale amortization


def kv_dtype_bytes_per_el(kv_dtype: Optional[str], *,
                          head_dim: int = _KV_SCALE_HEAD_DIM
                          ) -> Optional[float]:
    """Effective KV-cache bytes per element for a paged pool at `kv_dtype`,
    scale overhead included (4 / head_dim per element for int8/fp8).
    None (model-default precision) returns None: callers keep the
    bytes_per_el the profile was built with."""
    if kv_dtype is None:
        return None
    b = KV_DTYPE_PAYLOAD_BYTES[kv_dtype]
    if kv_dtype in _KV_QUANTIZED:
        b += 4.0 / head_dim
    return b


def _kv_width_factor(task: Task, kv_dtype: Optional[str]) -> float:
    """Multiplier rescaling a profile's kv_bytes_per_token_per_layer (baked
    at task.bytes_per_el) to the actual pool storage precision."""
    eff = kv_dtype_bytes_per_el(kv_dtype)
    if eff is None:
        return 1.0
    return eff / task.bytes_per_el


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """What the cost model needs to know about the served model."""
    name: str
    num_layers: int
    d_model: int
    params_per_layer: float        # weights scanned per generated token
    flops_per_layer_per_token: float   # 2 * active params
    kv_bytes_per_token_per_layer: float
    embed_params: float = 0.0
    paper_exact: bool = False

    @staticmethod
    def from_config(cfg: ModelConfig, paper_exact: bool = False,
                    bytes_per_el: int = 2) -> "ModelProfile":
        H = cfg.d_model
        if paper_exact:
            return ModelProfile(
                name=cfg.name, num_layers=cfg.num_layers, d_model=H,
                params_per_layer=12 * H * H,
                flops_per_layer_per_token=24 * H * H,
                kv_bytes_per_token_per_layer=2 * H * bytes_per_el,
                paper_exact=True)
        total_p = sum(cfg.params_per_layer(i) for i in range(cfg.num_layers))
        active_p = sum(cfg.active_params_per_layer(i)
                       for i in range(cfg.num_layers))
        kv = sum(cfg.kv_cache_bytes_per_token_layer(i, bytes_per_el)
                 for i in range(cfg.num_layers))
        L = cfg.num_layers
        return ModelProfile(
            name=cfg.name, num_layers=L, d_model=H,
            params_per_layer=total_p / L,
            flops_per_layer_per_token=2 * active_p / L,
            kv_bytes_per_token_per_layer=kv / L,
            embed_params=cfg.vocab_size * H * (1 if cfg.tie_embeddings else 2))


# ---------------------------------------------------------------------------
# Table 1 terms. `devices` are global device ids of one stage's TP group.
# ---------------------------------------------------------------------------

def comp_cost(cluster: Cluster, devices: Sequence[int], layers: int,
              model: ModelProfile, task: Task) -> float:
    """C_comp^{i,j}: memory-scan term + matmul term."""
    n = len(devices)
    B = task.bytes_per_el
    scan = max(model.params_per_layer * B * task.s_out
               / (n * cluster.devices[d].spec.mem_bw) for d in devices)
    flops = max(model.flops_per_layer_per_token * task.batch
                * (task.s_in + task.s_out) / (n * cluster.devices[d].spec.flops)
                for d in devices)
    return (scan + flops) * layers


def _tp_superstep(cluster: Cluster, devices: Sequence[int],
                  msg_bytes: float) -> float:
    n = len(devices)
    best = 0.0
    for d in devices:
        tot = 0.0
        for d2 in devices:
            if d2 == d:
                continue
            tot += cluster.lat[d, d2] + msg_bytes / (n * cluster.bw[d, d2])
        best = max(best, tot)
    return best


def comm_tp_phase(cluster: Cluster, devices: Sequence[int], layers: int,
                  model: ModelProfile, task: Task, phase: str) -> float:
    """One phase's share of the BSP AllReduce traffic: the prompt-wide
    supersteps belong to prefill, the per-generated-token ones to decode."""
    assert phase in ("prefill", "decode"), phase
    if len(devices) == 1:
        return 0.0
    B = task.bytes_per_el
    H = model.d_model
    if phase == "prefill":
        return _tp_superstep(cluster, devices,
                             task.batch * task.s_in * H * B) * 4 * layers
    return _tp_superstep(cluster, devices,
                         task.batch * H * B) * 4 * task.s_out * layers


def comm_tp_cost(cluster: Cluster, devices: Sequence[int], layers: int,
                 model: ModelProfile, task: Task) -> float:
    """C_comm-tp^{i,j}: BSP AllReduce pair per layer (4 supersteps)."""
    return comm_tp_phase(cluster, devices, layers, model, task, "prefill") \
        + comm_tp_phase(cluster, devices, layers, model, task, "decode")


def comm_pp_cost(cluster: Cluster, stage: Sequence[int],
                 next_stage: Sequence[int], task: Task,
                 model: ModelProfile) -> float:
    """C_comm-pp^{i,j}: fastest link between consecutive stages."""
    B = task.bytes_per_el
    H = model.d_model

    def best(msg_bytes: float) -> float:
        return min(cluster.lat[d, d2] + msg_bytes / cluster.bw[d, d2]
                   for d in stage for d2 in next_stage)

    return best(task.batch * task.s_in * H * B) \
        + best(task.batch * H * B) * task.s_out


def _kv_tokens_per_seq(task: Task, block_size: int = 0,
                       prefix_hit_rate: float = 0.0) -> int:
    """Cache tokens one sequence occupies. block_size == 0 is the contiguous
    layout (a full s_in + s_out row is reserved up front); block_size > 0 is
    the paged layout, which rounds ACTUAL usage up to whole blocks — the
    only over-reservation left is the partial tail block.

    prefix_hit_rate (paged only) is the expected fraction of prompt tokens
    served from the prefix cache: shared blocks are resident ONCE however
    many sequences alias them, so each additional sequence demands only its
    cold suffix + outputs. Sharing is block-granular, so the deduplicated
    span rounds DOWN to whole blocks (a partial chunk is never aliased)."""
    s_in = task.s_in
    if block_size and prefix_hit_rate > 0.0:
        shared = int(s_in * min(prefix_hit_rate, 1.0))
        s_in -= (shared // block_size) * block_size
    s_total = s_in + task.s_out
    if block_size:
        return -(-s_total // block_size) * block_size
    return s_total


def mem_bytes_per_device(cluster: Cluster, devices: Sequence[int],
                         layers: int, model: ModelProfile,
                         task: Task, block_size: int = 0,
                         kv_dtype: Optional[str] = None) -> float:
    """C_mem^d: params + KV cache (sharded over the TP group) + 4 activation
    buffers. block_size > 0 accounts the KV term at paged-block granularity
    (serving.block_manager) instead of contiguous rows; kv_dtype reprices
    the cache term at the pool's storage precision (int8/fp8 pages)."""
    n = len(devices)
    B = task.bytes_per_el
    H = model.d_model
    s_total = task.s_in + task.s_out
    s_kv = _kv_tokens_per_seq(task, block_size)
    kv_b = model.kv_bytes_per_token_per_layer * _kv_width_factor(task,
                                                                 kv_dtype)
    per_layer = model.params_per_layer * B / n \
        + kv_b * task.batch * s_kv / n
    return per_layer * layers + 4 * task.batch * s_total * H * B


# Fraction of device memory actually usable for weights/caches (CUDA context,
# allocator fragmentation, workspace) — reproduces the paper's Fig.1 OOMs.
MEM_UTIL = 0.9


def mem_ok(cluster: Cluster, devices: Sequence[int], layers: int,
           model: ModelProfile, task: Task, block_size: int = 0,
           kv_dtype: Optional[str] = None) -> bool:
    need = mem_bytes_per_device(cluster, devices, layers, model, task,
                                block_size, kv_dtype)
    return all(need <= MEM_UTIL * cluster.devices[d].spec.mem_bytes
               for d in devices)


def concurrent_capacity(cluster: Cluster, devices: Sequence[int],
                        layers: int, model: ModelProfile, task: Task, *,
                        max_len: int = 0, block_size: int = 0,
                        prefix_hit_rate: float = 0.0,
                        kv_dtype: Optional[str] = None) -> int:
    """How many sequences of `task`'s shape fit in the memory left after
    parameters and activation buffers on this stage's TP group — the
    scheduler-facing capacity number behind the paged refactor.

    Contiguous (block_size == 0) reserves ``max_len`` tokens per sequence
    (worst case, defaulting to s_in + s_out); paged reserves only the
    blocks the sequence actually fills. The gap between the two IS the
    slots-vs-reservation win measured by benchmarks/bench_paged.py.

    prefix_hit_rate > 0 (paged + prefix caching) plans against the
    EFFECTIVE (deduplicated) per-sequence KV demand: shared prompt blocks
    are resident once regardless of how many in-flight sequences alias
    them, so a shared-system-prompt workload fits proportionally more
    concurrent sequences (benchmarks/bench_prefix.py measures the realized
    gap).

    kv_dtype reprices the per-sequence KV demand at the pool's storage
    precision: int8/fp8 pages fit ~2x the sequences of bf16 pools in the
    same free memory (benchmarks/bench_quant_kv.py measures the realized
    capacity gap).
    """
    n = len(devices)
    B = task.bytes_per_el
    free = min(MEM_UTIL * cluster.devices[d].spec.mem_bytes
               for d in devices)
    free -= model.params_per_layer * B / n * layers
    s_total = task.s_in + task.s_out
    free -= 4 * task.batch * s_total * model.d_model * B   # activations
    if free <= 0:
        return 0
    if block_size:
        toks = _kv_tokens_per_seq(task, block_size, prefix_hit_rate)
    else:
        toks = max(max_len, s_total)
    per_seq = model.kv_bytes_per_token_per_layer \
        * _kv_width_factor(task, kv_dtype) * toks * layers / n
    if per_seq <= 0:
        return 1 << 30              # recurrent-only stacks: O(1) state
    return int(free // per_seq)


# ---------------------------------------------------------------------------
# Phase-split costs (disaggregated prefill/decode, cf. HexGen-2/DistServe)
# ---------------------------------------------------------------------------
# The Table-1 terms above fold both inference phases into one latency; the
# role scheduler needs them APART, because the phases stress different
# hardware: prefill is one compute-bound pass over the prompt (weights
# scanned once, FLOPs over s_in tokens), decode scans the weights once per
# generated token. The split is a modeling choice, not an identity —
# comp_cost_phase("prefill") + comp_cost_phase("decode") differs from
# comp_cost by one weight scan, deliberately: the combined form charges the
# scan per output token only.

def comp_cost_phase(cluster: Cluster, devices: Sequence[int], layers: int,
                    model: ModelProfile, task: Task, phase: str) -> float:
    """One phase's compute time on a stage's TP group."""
    assert phase in ("prefill", "decode"), phase
    n = len(devices)
    B = task.bytes_per_el
    if phase == "prefill":
        scan = max(model.params_per_layer * B
                   / (n * cluster.devices[d].spec.mem_bw) for d in devices)
        flops = max(model.flops_per_layer_per_token * task.batch * task.s_in
                    / (n * cluster.devices[d].spec.flops) for d in devices)
    else:
        scan = max(model.params_per_layer * B * task.s_out
                   / (n * cluster.devices[d].spec.mem_bw) for d in devices)
        flops = max(model.flops_per_layer_per_token * task.batch * task.s_out
                    / (n * cluster.devices[d].spec.flops) for d in devices)
    return (scan + flops) * layers


def comm_pp_phase(cluster: Cluster, stage: Sequence[int],
                  next_stage: Sequence[int], task: Task,
                  model: ModelProfile, phase: str) -> float:
    """One phase's share of the stage-to-stage activation relay."""
    assert phase in ("prefill", "decode"), phase
    B = task.bytes_per_el
    H = model.d_model

    def best(msg_bytes: float) -> float:
        return min(cluster.lat[d, d2] + msg_bytes / cluster.bw[d, d2]
                   for d in stage for d2 in next_stage)

    if phase == "prefill":
        return best(task.batch * task.s_in * H * B)
    return best(task.batch * H * B) * task.s_out


@dataclasses.dataclass(frozen=True)
class PhaseCosts:
    """Per-phase latency (sum over stages) and bottleneck (max stage time)
    of one pipeline — the inputs to slo_sim.PhasedReplicaModel."""
    prefill_latency: float
    prefill_bottleneck: float
    decode_latency: float
    decode_bottleneck: float

    def as_dict(self) -> dict:
        """Plain-dict view for JSON surfaces (calibration reports,
        bench rows)."""
        return dataclasses.asdict(self)


def pipeline_phase_costs(cluster: Cluster, stages: List[Sequence[int]],
                         layer_split: List[int], model: ModelProfile,
                         task: Task) -> PhaseCosts:
    """Phase-split counterpart of pipeline_cost/pipeline_bottleneck."""
    out = {}
    for phase in ("prefill", "decode"):
        total, worst = 0.0, 0.0
        for j, (devs, l) in enumerate(zip(stages, layer_split)):
            t = comp_cost_phase(cluster, devs, l, model, task, phase) \
                + comm_tp_phase(cluster, devs, l, model, task, phase)
            if j + 1 < len(stages):
                t += comm_pp_phase(cluster, devs, stages[j + 1], task,
                                   model, phase)
            total += t
            worst = max(worst, t)
        out[phase] = (total, worst)
    return PhaseCosts(prefill_latency=out["prefill"][0],
                      prefill_bottleneck=out["prefill"][1],
                      decode_latency=out["decode"][0],
                      decode_bottleneck=out["decode"][1])


def phase_service_rates(pc: PhaseCosts) -> Tuple[float, float]:
    """One replica's per-phase service rates (requests/s): the edge
    capacities of the Helix-style max-flow graph (core.resched) — a
    prefill node admits 1/prefill_bottleneck req/s, a decode node
    completes 1/decode_bottleneck req/s."""
    return (1.0 / max(pc.prefill_bottleneck, 1e-12),
            1.0 / max(pc.decode_bottleneck, 1e-12))


def kv_migration_bytes(model: ModelProfile, task: Task,
                       block_size: int = 0,
                       kv_dtype: Optional[str] = None) -> float:
    """Wire size of one request's prefilled KV (every layer, the whole
    prompt, rounded up to whole blocks when paged): what a prefill->decode
    handoff ships over the modeled link. The wire carries the CACHE dtype
    — int8/fp8 pages ship their payload + float32 scales, ~1/4 the fp32
    bytes — so kv_dtype reprices the transfer, not just residency."""
    toks = task.s_in
    if block_size:
        toks = -(-toks // block_size) * block_size
    return model.kv_bytes_per_token_per_layer \
        * _kv_width_factor(task, kv_dtype) * toks * model.num_layers \
        * task.batch


# ---------------------------------------------------------------------------
# Host page tier + cluster prefix directory (serving.block_manager.
# HostPagePool / serving.cluster_kv): planner counterparts of tiered
# residency. The serving layer demotes evicted prefix blocks to host memory
# and fetches peer-resident prefixes over the KV link; the planner's job is
# to size those tiers and to turn residency into an ACHIEVABLE prefix hit
# rate instead of trusting a static scalar.
# ---------------------------------------------------------------------------

def kv_block_bytes(model: ModelProfile, task: Task, block_size: int,
                   kv_dtype: Optional[str] = None,
                   layers: Optional[int] = None) -> float:
    """Bytes one paged KV block occupies across ``layers`` (default: the
    whole stack) at the pool's storage precision — the granule every tier
    (device pool, host tier, cluster fetch) allocates and ships in."""
    L = model.num_layers if layers is None else layers
    return model.kv_bytes_per_token_per_layer \
        * _kv_width_factor(task, kv_dtype) * block_size * L


def host_tier_blocks(host_bytes: float, model: ModelProfile, task: Task,
                     block_size: int,
                     kv_dtype: Optional[str] = None) -> int:
    """How many paged KV blocks a host-memory budget holds (whole stack
    per block, at the pool's storage precision — quantized pools spill at
    their narrow width, so the same budget holds ~2-4x the int8 blocks)."""
    if host_bytes <= 0 or block_size <= 0:
        return 0
    return int(host_bytes // kv_block_bytes(model, task, block_size,
                                            kv_dtype))


def host_swap_seconds_per_block(model: ModelProfile, task: Task,
                                block_size: int, swap_gbps: float,
                                kv_dtype: Optional[str] = None) -> float:
    """Time to move one block over the host<->device (or peer-fetch) link
    at ``swap_gbps`` Gbit/s. <= 0 models an ideal (free) swap."""
    if swap_gbps <= 0:
        return 0.0
    return kv_block_bytes(model, task, block_size, kv_dtype) \
        / (swap_gbps * 1e9 / 8)


def device_pool_blocks(cluster: Cluster, devices: Sequence[int], layers: int,
                       model: ModelProfile, task: Task, block_size: int,
                       kv_dtype: Optional[str] = None) -> int:
    """Paged KV blocks one stage's TP group can pool after parameters and
    activation buffers: the device-tier residency bound feeding
    effective_prefix_hit_rate. concurrent_capacity divides the same free
    memory by SEQUENCES; this divides it by BLOCKS."""
    if block_size <= 0:
        return 0
    n = len(devices)
    B = task.bytes_per_el
    free = min(MEM_UTIL * cluster.devices[d].spec.mem_bytes
               for d in devices)
    free -= model.params_per_layer * B / n * layers
    free -= 4 * task.batch * (task.s_in + task.s_out) * model.d_model * B
    if free <= 0:
        return 0
    per_block = kv_block_bytes(model, task, block_size, kv_dtype,
                               layers=layers) / n
    if per_block <= 0:
        return 1 << 30              # recurrent-only stacks: O(1) state
    return int(free // per_block)


def effective_prefix_hit_rate(shareable: float, *, working_set_blocks: int,
                              device_blocks: int, host_blocks: int = 0,
                              peer_blocks: int = 0,
                              tier_discount: float = 0.0) -> float:
    """The cluster hit rate that replaces the static --prefix-hit-rate
    scalar: a prefix hit needs its blocks RESIDENT somewhere reachable, so
    the workload's shareable fraction (``shareable`` — the old static
    scalar, now an upper bound) is scaled by the fraction of the hot
    working set the replica can actually reach.

    Reach = its device pool + its host tier + peer-resident blocks behind
    the cluster directory. Tiered blocks (host + peer) are discounted by
    ``tier_discount`` in [0, 1]: the share of a tiered hit's saving eaten
    by swap/fetch time (1 = moving the block costs as much as recomputing
    it, so the tier is worthless for latency; 0 = free swap)."""
    if shareable <= 0.0:
        return 0.0
    if working_set_blocks <= 0:
        return min(shareable, 1.0)
    d = min(max(1.0 - tier_discount, 0.0), 1.0)
    reach = device_blocks + d * (host_blocks + peer_blocks)
    return min(shareable, 1.0) * min(1.0, reach / working_set_blocks)


# ---------------------------------------------------------------------------
# Speculative decoding (serving.spec): decode cost per COMMITTED token.
# Plain decode commits exactly one token per weight scan; a draft-then-
# verify step spends one target step plus k draft steps and commits the
# accepted prefix — between 1 and k + 1 tokens. The scheduler reasons in
# time per COMMITTED token, which is what SLO latency is made of.
# ---------------------------------------------------------------------------

def expected_commit_per_step(alpha: float, k: int) -> float:
    """Expected tokens committed per target verification step when each
    draft token is accepted independently with probability ``alpha`` and
    ``k`` drafts are proposed: 1 + alpha + ... + alpha^k (the bonus token
    always commits; draft j commits only if drafts 1..j all match).
    k = 0 is plain decode: exactly 1."""
    if k <= 0:
        return 1.0
    alpha = min(max(alpha, 0.0), 1.0)
    if alpha >= 1.0:
        return float(k + 1)
    return (1.0 - alpha ** (k + 1)) / (1.0 - alpha)


def spec_step_cost(step_cost: float, draft_step_cost: float, alpha: float,
                   k: int) -> float:
    """Decode time per COMMITTED token at speculation depth k: one target
    step (``step_cost``) plus k draft steps (``draft_step_cost`` each)
    commit ``expected_commit_per_step(alpha, k)`` tokens. k = 0 recovers
    ``step_cost`` exactly."""
    return (step_cost + k * draft_step_cost) \
        / expected_commit_per_step(alpha, k)


def best_spec_k(step_cost: float, draft_step_cost: float, alpha: float, *,
                max_k: int = 8) -> int:
    """Acceptance-aware speculation depth for ONE replica: the k in
    [0, max_k] minimizing decode time per committed token.

    The draft cost is ABSOLUTE, not a fraction of the target step — the
    tiny draft (or the host-side n-gram lookup) runs at roughly the same
    speed wherever it lives — so a SLOW replica (large ``step_cost``)
    amortizes each extra draft over a bigger saved step and picks DEEPER
    k. This is the per-replica knob the genetic search threads through
    ``SearchResult.spec_ks``. Ties keep the shallowest k (less draft work
    wasted when the realized acceptance rate drifts below ``alpha``)."""
    best, best_c = 0, spec_step_cost(step_cost, draft_step_cost, alpha, 0)
    for k in range(1, max_k + 1):
        c = spec_step_cost(step_cost, draft_step_cost, alpha, k)
        if c < best_c - 1e-12:
            best, best_c = k, c
    return best


# ---------------------------------------------------------------------------
# Whole-pipeline cost (Eq. 2)
# ---------------------------------------------------------------------------

def pipeline_cost(cluster: Cluster, stages: List[Sequence[int]],
                  layer_split: List[int], model: ModelProfile,
                  task: Task) -> float:
    """End-to-end latency; inf if any stage violates memory."""
    total = 0.0
    for j, (devs, l) in enumerate(zip(stages, layer_split)):
        if not mem_ok(cluster, devs, l, model, task):
            return float("inf")
        total += comp_cost(cluster, devs, l, model, task)
        total += comm_tp_cost(cluster, devs, l, model, task)
        if j + 1 < len(stages):
            total += comm_pp_cost(cluster, devs, stages[j + 1], task, model)
    return total


def pipeline_bottleneck(cluster: Cluster, stages: List[Sequence[int]],
                        layer_split: List[int], model: ModelProfile,
                        task: Task) -> float:
    """Max per-stage time: the pipelined throughput limit (1/this = req/s
    capacity of the replica when stages overlap across requests)."""
    worst = 0.0
    for j, (devs, l) in enumerate(zip(stages, layer_split)):
        t = comp_cost(cluster, devs, l, model, task) \
            + comm_tp_cost(cluster, devs, l, model, task)
        if j + 1 < len(stages):
            t += comm_pp_cost(cluster, devs, stages[j + 1], task, model)
        worst = max(worst, t)
    return worst
