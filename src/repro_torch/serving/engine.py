"""Inference engine of the port: builds replica pipelines from an
Assignment and serves workloads through the Router (twin of
repro.serving.engine.InferenceEngine for paged continuous serving).

Every replica and stage runs on the one device given (``device="cuda"`` by
default; tests pass ``device="cpu"``). A plan's TP groups collapse onto it,
as the reference engine collapses them onto fewer physical devices.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import Assignment
from repro_torch.models import model as M
from repro_torch.device import resolve_device
from repro_torch.serving.pipeline import AsymmetricPipeline
from repro_torch.serving.request import Request
from repro_torch.serving.router import Router, ServeStats


class InferenceEngine:
    """``params`` is the reference-layout parameter tree (seeded
    ``models.model.init_params`` or ``bridge.params_from_numpy``); None
    draws seeded random weights (seed 0) on the device. ``dtype`` overrides
    the config's parameter / KV dtype. The reference's other serving
    features (speculative decoding, disaggregation, quantized KV, host
    tier, cluster prefix, KVSAN, tracing, static batching) are not ported
    yet and raise NotImplementedError."""

    def __init__(self, cfg: ModelConfig, assignment: Assignment, *,
                 params=None, device="cuda", dtype=None, n_slots: int = 8,
                 max_len: int = 256, block_size: int = 16, stage_blocks=None,
                 prefix_caching: bool = False, prefill_chunk: int = 0,
                 step_costs: Optional[Sequence[float]] = None,
                 prefill_token_cost: float = 0.0,
                 policy: str = "continuous", cache_layout: str = "paged",
                 **unported):
        if unported:
            raise NotImplementedError(
                f"not ported yet: {sorted(unported)} (see ROADMAP.md)")
        self.cfg = cfg
        self.device = resolve_device(device)
        assignment.validate(cfg.num_layers)
        if params is None:
            params = M.init_params(cfg, 0, device=self.device, dtype=dtype)
        self.replicas: List[AsymmetricPipeline] = [
            AsymmetricPipeline(cfg, params, pipe.layer_split,
                               device=self.device, dtype=dtype)
            for pipe in assignment.pipelines]
        self.router = Router(self.replicas, policy=policy,
                             cache_layout=cache_layout, n_slots=n_slots,
                             max_len=max_len, block_size=block_size,
                             stage_blocks=stage_blocks,
                             prefix_caching=prefix_caching,
                             prefill_chunk=prefill_chunk,
                             prefill_token_cost=prefill_token_cost,
                             step_costs=step_costs)

    def serve(self, requests: Sequence[Request], *, deadline: float,
              clock=None) -> ServeStats:
        return self.router.serve(requests, deadline, clock=clock)
