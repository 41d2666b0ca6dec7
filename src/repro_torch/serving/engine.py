"""Inference engine of the port: builds replica pipelines from an
Assignment and serves workloads through the Router (twin of
repro.serving.engine.InferenceEngine for paged continuous serving).

Every replica and stage runs on the one device given (``device="cuda"`` by
default; tests pass ``device="cpu"``). A plan's TP groups collapse onto it,
as the reference engine collapses them onto fewer physical devices.
"""
from __future__ import annotations

import warnings
from typing import List, Optional, Sequence

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import Assignment
from repro_torch.models import model as M
from repro_torch.models.quant import quantize_params
from repro_torch.device import resolve_device
from repro_torch.serving.pipeline import (AsymmetricPipeline,
                                          context_mode_supported)
from repro_torch.serving.request import Request
from repro_torch.serving.router import Router, ServeStats
from repro_torch.serving.spec import SpecConfig


class InferenceEngine:
    """``params`` is the reference-layout parameter tree (seeded
    ``models.model.init_params`` or ``bridge.params_from_numpy``); None
    draws seeded random weights (seed 0) on the device. ``dtype`` overrides
    the config's parameter / KV dtype (a draft model's too).

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
    themselves. The reference's other serving
    features (disaggregation, host tier, cluster prefix, KVSAN, tracing,
    static batching) are not ported yet and raise NotImplementedError."""

    def __init__(self, cfg: ModelConfig, assignment: Assignment, *,
                 params=None, device="cuda", dtype=None, n_slots: int = 8,
                 max_len: int = 256, block_size: int = 16, stage_blocks=None,
                 prefix_caching: bool = False, prefill_chunk: int = 0,
                 step_costs: Optional[Sequence[float]] = None,
                 prefill_token_cost: float = 0.0,
                 policy: str = "continuous", cache_layout: str = "paged",
                 spec_decode: bool = False, spec_k: int = 4,
                 draft_model=None,
                 spec_ks: Optional[Sequence[int]] = None,
                 spec_draft_token_cost: float = 0.0,
                 kv_dtype: Optional[str] = None,
                 kv_dtypes: Optional[Sequence[Optional[str]]] = None,
                 kv_guard_layers: Sequence[int] = (),
                 quantize: bool = False, **unported):
        if unported:
            raise NotImplementedError(
                f"not ported yet: {sorted(unported)} (see ROADMAP.md)")
        self.cfg = cfg
        self.device = resolve_device(device)
        assignment.validate(cfg.num_layers)
        if params is None:
            params = M.init_params(cfg, 0, device=self.device, dtype=dtype)
        if quantize:
            params = quantize_params(params)
        self.replicas: List[AsymmetricPipeline] = [
            AsymmetricPipeline(cfg, params, pipe.layer_split,
                               device=self.device, dtype=dtype)
            for pipe in assignment.pipelines]
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
        self.router = Router(self.replicas, policy=policy,
                             cache_layout=cache_layout, n_slots=n_slots,
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
                             kv_guard_layers=kv_guard_layers)

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

    def serve(self, requests: Sequence[Request], *, deadline: float,
              clock=None) -> ServeStats:
        return self.router.serve(requests, deadline, clock=clock)
