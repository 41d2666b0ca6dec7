"""Inference engine of the port: builds replica pipelines from an
Assignment and serves workloads through the Router (twin of
repro.serving.engine.InferenceEngine).

Each plan's global device ids map onto the engine's ``devices`` as in the
reference: stage device d runs on ``devices[d % len(devices)]``, and a
stage's repeated devices collapse (TP only changes the layout, not the
numbers), so on one card every stage runs whole there and on four a TP-2
stage runs as two shards on two cards. ``devices`` defaults to every
visible device of ``device``'s type (``device="cuda"`` by default, tests
pass ``device="cpu"``), or to ``device`` itself where it names an index.
A stage over several distinct devices runs as tensor-parallel shards
whatever the family and whether or not the weights are int8
(``serving.pipeline``), or raises NotImplementedError naming the cause (q
heads that do not split over its devices): it never runs on one device
in their stead.
"""
from __future__ import annotations

import warnings
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import Assignment
from repro_torch.models import model as M
from repro_torch.models.quant import quantize_params
from repro_torch.device import resolve_device, visible_devices
from repro_torch.serving.disagg import KVLink
from repro_torch.serving.pipeline import (AsymmetricPipeline,
                                          context_mode_supported,
                                          slot_mode_supported)
from repro_torch.serving.request import Request
from repro_torch.serving.router import Router, ServeStats, default_roles
from repro_torch.serving.spec import SpecConfig


class InferenceEngine:
    """``params`` is the reference-layout parameter tree (seeded
    ``models.model.init_params`` or ``bridge.params_from_numpy``); None
    draws seeded random weights from the integer seed ``key`` (0 by
    default; the reference takes a PRNG key) on the first device.
    ``devices`` (torch devices, or strings) are the physical devices the
    plans' device ids map onto (see the module docstring): a stage's
    distinct devices hold its tensor-parallel shards
    (``serving.pipeline.StageExecutor``). ``dtype`` overrides the config's
    parameter / KV dtype (a draft model's too).

    ``spec_decode=True`` turns on speculative decoding with ``spec_k``
    drafts per target step from the n-gram proposer, or from
    ``draft_model`` (a ModelConfig or a config name) with seeded random
    weights; ``spec_ks`` gives each replica its own depth (0 = plain
    decode) and ``spec_draft_token_cost`` charges each proposal that
    fraction of an iteration on the virtual clock. As in the reference,
    ``spec_k < 1``, a non-attention stack and an unsuitable draft warn and
    fall back.

    ``kv_dtype`` ("int8" / "fp8", or the model's own width) stores the
    page pools at that precision: int8 / fp8 pages carry per-token-per-head
    scales and are read through the quantized paged kernels. ``kv_dtypes``
    overrides it per replica (a None entry = ``kv_dtype``) and
    ``kv_guard_layers`` keeps those global layer indices at model
    precision. ``quantize=True`` serves int8 weight-only matmul weights
    (``models.quant.quantize_params``). A hybrid Mamba + attention stack
    (jamba-v0.1-52b) serves with per-slot recurrent state beside the
    attention pages; on it, as in the reference, prefix caching, chunked
    prefill, quantized pools and speculation warn and serve without
    themselves. ``route_seed`` makes the Router's least-loaded tiebreaks
    a seeded draw.

    ``disaggregate=True`` splits the inference phases across replicas:
    arrivals prefill on ``role="prefill"`` replicas and their KV pages
    migrate to ``role="decode"`` replicas (serving.disagg). ``roles``
    overrides the default split (e.g. the scheduler's SLO-scored one);
    the transfer is modelled as ``kv_bytes / link_bandwidth`` on the
    serving clock — flat via ``kv_link_gbps`` (0 = ideal interconnect),
    or per-replica-pair from ``cluster``'s comm matrices when given. As in
    the reference, a stack with recurrent layers or a single replica warns
    and serves colocated.

    ``host_blocks`` (one int, or per replica) adds a host-memory page tier
    under each replica's device pools: prefix eviction demotes pages there
    and matches swap them back in at ``host_swap_cost`` per block on the
    serving clock. ``cluster_prefix=True`` joins every replica into a
    shared prefix directory (serving.cluster_kv): prompts whose prefix
    lives only on a peer fetch the pages over the KV link, and the Router
    scores admission by resident prefix (``prefix_route_weight`` /
    ``host_route_weight``) against queue depth. Both need prefix caching.
    ``kvsan=True`` serves under the KVSAN page-lifecycle sanitizer
    (repro_torch.analysis.kvsan): pure observation, leaks surface as
    ``ServeStats.kvsan_leaks``. ``serve(..., tracer=, metrics=)`` traces
    the serve and publishes its counters (repro_torch.obs).

    ``policy`` and ``cache_layout`` choose each replica's worker as in the
    reference (``serving.router``): paged continuous batching, contiguous
    slot pools (the default layout), or ``policy="static"``, the paper's
    whole-batch engine on batches of up to ``max_batch`` left-padded
    requests. A config that slot mode cannot serve (a sliding-window
    model, h2o-danube-1.8b) falls back to static batching with the
    reference's warning. ``generate`` runs one left-padded batch on
    replica 0.

    ``from_config`` builds an engine from a ``ServingConfig`` and a
    scheduled ``DeploymentPlan``, as ``launch.serve`` does."""

    def __init__(self, cfg: ModelConfig, assignment: Assignment, *,
                 params=None, device="cuda", devices=None, key: int = 0,
                 dtype=None, n_slots: int = 8,
                 max_len: int = 256, max_batch: int = 4,
                 block_size: int = 16, stage_blocks=None,
                 prefix_caching: bool = False, prefill_chunk: int = 0,
                 step_costs: Optional[Sequence[float]] = None,
                 prefill_token_cost: float = 0.0,
                 policy: str = "continuous",
                 cache_layout: str = "contiguous",
                 spec_decode: bool = False, spec_k: int = 4,
                 draft_model=None,
                 spec_ks: Optional[Sequence[int]] = None,
                 spec_draft_token_cost: float = 0.0,
                 kv_dtype: Optional[str] = None,
                 kv_dtypes: Optional[Sequence[Optional[str]]] = None,
                 kv_guard_layers: Sequence[int] = (),
                 quantize: bool = False,
                 host_blocks=0, host_swap_cost: float = 0.0,
                 cluster_prefix: bool = False,
                 prefix_route_weight: float = 0.25,
                 host_route_weight: float = 0.5,
                 route_seed: Optional[int] = None,
                 disaggregate: bool = False,
                 roles: Optional[Sequence[str]] = None,
                 kv_link_gbps: float = 0.0, cluster=None,
                 kvsan: bool = False):
        self.cfg = cfg
        self.devices = ([resolve_device(d) for d in devices]
                        if devices is not None
                        else visible_devices(resolve_device(device)))
        if not self.devices:
            raise ValueError("devices is empty")
        self.device = self.devices[0]
        assignment.validate(cfg.num_layers)
        if params is None:
            params = M.init_params(cfg, key, device=self.device, dtype=dtype)
        if quantize:
            params = quantize_params(params)
        self.replicas: List[AsymmetricPipeline] = []
        for pipe in assignment.pipelines:
            # fewer physical devices than the plan's TP degree: duplicates
            # collapse (TP only changes the layout)
            stage_devs = [list(dict.fromkeys(
                self.devices[d % len(self.devices)] for d in st.device_ids))
                for st in pipe.stages]
            self.replicas.append(AsymmetricPipeline(
                cfg, params, pipe.layer_split, stage_devs, dtype=dtype))
        if policy != "static" and not slot_mode_supported(cfg):
            warnings.warn(
                f"{cfg.name}: slot mode needs uniform text decode "
                "(SWA ring cache / encoder-decoder / VLM); serving with "
                "policy='static'", stacklevel=2)
            policy = "static"
        # ---- disaggregated prefill/decode ------------------------------
        if disaggregate and roles is None:
            roles = default_roles(len(self.replicas))
        if roles is not None and any(r != "both" for r in roles):
            if not context_mode_supported(cfg):
                warnings.warn(
                    f"{cfg.name}: disaggregation needs an attention-only "
                    "stack (recurrent running state has no pages to "
                    "migrate); serving colocated", stacklevel=2)
                roles = None
            elif len(self.replicas) < 2:
                warnings.warn(
                    "disaggregation needs >= 2 replicas; serving "
                    "colocated", stacklevel=2)
                roles = None
        spec = None
        if spec_decode and spec_k < 1:
            # consistent with per-replica spec_ks, where 0 = plain decode
            warnings.warn("spec_k < 1 means plain decode; serving without "
                          "speculation", stacklevel=2)
            spec_decode = False
            spec_ks = None
        if spec_decode:
            spec = self._spec_config(cfg, spec_k, draft_model,
                                     spec_draft_token_cost)
            if spec is None:
                spec_ks = None
        kv_link = None
        if (roles is not None and any(r != "both" for r in roles)) \
                or cluster_prefix:
            if cluster is not None:
                # per-pair alpha-beta costs: source replica's LAST stage to
                # destination replica's FIRST stage, like the cost model's
                # pipeline-comm term
                src = [list(p.stages[-1].device_ids)
                       for p in assignment.pipelines]
                dst = [list(p.stages[0].device_ids)
                       for p in assignment.pipelines]
                kv_link = KVLink.from_cluster(
                    cluster, [p.device_ids for p in assignment.pipelines],
                    src_stage_devices=src, dst_stage_devices=dst)
            else:
                kv_link = KVLink(gbps=kv_link_gbps)
        self.router = Router(self.replicas, policy=policy,
                             cache_layout=cache_layout, max_batch=max_batch,
                             n_slots=n_slots,
                             max_len=max_len, block_size=block_size,
                             stage_blocks=stage_blocks,
                             prefix_caching=prefix_caching,
                             prefill_chunk=prefill_chunk,
                             prefill_token_cost=prefill_token_cost,
                             step_costs=step_costs, spec=spec,
                             spec_ks=(list(spec_ks)
                                      if spec_ks is not None else None),
                             kv_dtype=kv_dtype,
                             kv_dtypes=(list(kv_dtypes)
                                        if kv_dtypes is not None else None),
                             kv_guard_layers=kv_guard_layers,
                             host_blocks=host_blocks,
                             host_swap_cost=host_swap_cost,
                             cluster_prefix=cluster_prefix,
                             prefix_route_weight=prefix_route_weight,
                             host_route_weight=host_route_weight,
                             route_seed=route_seed, roles=roles,
                             kv_link=kv_link, kvsan=kvsan)
        self.roles = self.router.roles

    @classmethod
    def from_config(cls, cfg: ModelConfig, plan, serving, *,
                    assignment: Optional[Assignment] = None, cluster=None,
                    **overrides) -> "InferenceEngine":
        """Build an engine from the two typed surfaces: a
        ``serving.config.ServingConfig`` (HOW to serve — policy, layout,
        feature flags) and a ``core.plan.DeploymentPlan`` (WHERE — the
        scheduler's replica layouts, roles, spec depths, KV precisions and
        host-tier split). ``assignment`` overrides the plan's layer split
        (e.g. the reduced-model projection from launch.serve) while the
        plan keeps supplying the per-replica dimensions; ``cluster`` feeds
        the per-pair KV-link cost model when no flat bandwidth is set;
        ``overrides`` pass through any raw ``__init__`` kwarg (n_slots,
        params, device, devices, ...). Without ``params`` the weights are
        ``init_params(cfg, key)``, ``key`` ``serving.seed`` unless
        overridden. Every flag of ServingConfig is served, as in the
        reference."""
        sv = serving.normalized()
        asg = assignment if assignment is not None else plan.assignment
        kw = dict(
            policy=sv.policy, max_len=sv.max_len(),
            cache_layout=sv.cache_layout, block_size=sv.block_size,
            prefix_caching=sv.prefix_caching,
            prefill_chunk=sv.prefill_chunk,
            host_blocks=(plan.host_blocks
                         if plan.host_blocks is not None else 0),
            host_swap_cost=sv.host_swap_cost,
            cluster_prefix=sv.cluster_prefix,
            prefix_route_weight=sv.prefix_route_weight,
            route_seed=sv.route_seed,
            # the role split is the SCHEDULER's verdict: roles=None means
            # colocated serving won the search, so don't force a default
            disaggregate=(sv.disaggregate and plan.roles is not None),
            roles=(plan.roles if sv.disaggregate else None),
            kv_link_gbps=sv.kv_link_gbps,
            cluster=(cluster if sv.disaggregate and sv.kv_link_gbps <= 0
                     else None),
            spec_decode=sv.spec_decode, spec_k=sv.spec_k,
            draft_model=(sv.draft_model or None),
            spec_draft_token_cost=sv.spec_draft_cost,
            spec_ks=(plan.spec_ks if sv.spec_decode else None),
            kv_dtype=sv.fixed_kv_dtype(),
            kv_dtypes=(plan.kv_dtypes if sv.kv_dtype == "search"
                       else None),
            kv_guard_layers=sv.guard_layers(cfg.num_layers),
            kvsan=sv.kvsan)
        kw.setdefault("key", sv.seed)
        kw.update(overrides)
        return cls(cfg, asg, **kw)

    @staticmethod
    def _spec_config(cfg, spec_k, draft_model, draft_token_cost):
        """The SpecConfig the reference engine would build, with its
        warnings: None for a non-attention stack, the n-gram proposer
        when the draft model cannot serve as one."""
        if not context_mode_supported(cfg):
            warnings.warn(
                f"{cfg.name}: speculative decoding needs an attention-only "
                "stack (a recurrent sublayer's state cannot roll back past "
                "a rejected candidate); serving without it", stacklevel=3)
            return None
        draft_cfg = draft_model
        if isinstance(draft_model, str):
            draft_cfg = get_config(draft_model)
            if cfg.name.endswith("-reduced"):
                draft_cfg = draft_cfg.reduced()
        if draft_cfg is not None and not context_mode_supported(draft_cfg):
            warnings.warn(
                f"{draft_cfg.name}: draft models must be attention-only "
                "text decoders (recurrent draft state cannot roll back "
                "past a rejected candidate); falling back to the n-gram "
                "proposer", stacklevel=3)
            draft_cfg = None
        elif draft_cfg is not None \
                and draft_cfg.vocab_size != cfg.vocab_size:
            warnings.warn(
                f"{draft_cfg.name}: draft vocab ({draft_cfg.vocab_size}) "
                f"differs from the target's ({cfg.vocab_size}); falling "
                "back to the n-gram proposer", stacklevel=3)
            draft_cfg = None
        if draft_cfg is not None:
            return SpecConfig(k=spec_k, proposer="draft", draft_cfg=draft_cfg,
                              draft_token_cost=draft_token_cost)
        return SpecConfig(k=spec_k, draft_token_cost=draft_token_cost)

    def generate(self, prompts: Sequence[np.ndarray], *, max_new: int = 16
                 ) -> List[np.ndarray]:
        """One-shot batched greedy generation on replica 0: the prompts
        left-padded into one batch, max_new tokens each."""
        maxlen = max(len(p) for p in prompts)
        toks = np.zeros((len(prompts), maxlen), np.int32)
        kv_start = np.zeros(len(prompts), np.int32)
        for i, p in enumerate(prompts):
            toks[i, maxlen - len(p):] = p
            kv_start[i] = maxlen - len(p)
        out = self.replicas[0].generate(toks, max_new=max_new,
                                        kv_start=kv_start)
        return [out[i] for i in range(len(prompts))]

    def serve(self, requests: Sequence[Request], *, deadline: float,
              clock=None, tracer=None, metrics=None) -> ServeStats:
        return self.router.serve(requests, deadline, clock=clock,
                                 tracer=tracer, metrics=metrics)
