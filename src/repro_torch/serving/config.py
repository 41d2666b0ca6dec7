"""ServingConfig: the one typed surface for every serving knob.

``launch/serve.py`` used to parse ~34 argparse flags into an ad-hoc
namespace and forward them as three separate kwarg piles (scheduler,
Router, InferenceEngine); benches and smokes each re-invented subsets of
that plumbing. ``ServingConfig`` collapses the surface into a single
dataclass that owns:

  * the argparse schema — ``add_args``/``from_args`` generate the CLI
    from field metadata, so a flag exists exactly once;
  * serialization — ``to_args`` round-trips back to an argv list
    (``from_args(parse(to_args(cfg))) == cfg``), ``to_json``/``from_json``
    persist configs into results files and relaunch them;
  * feature gating — ``normalized()`` applies the layout-compatibility
    rules (disaggregation/speculation/quantized-KV/host-tier need the
    paged layout) in ONE place, warning and downgrading exactly like the
    old inline checks;
  * derived planning inputs — ``task()``, ``schedule_kwargs()``,
    ``workload()``, ``max_len()``, ``guard_layers()``.

Engines consume it through ``InferenceEngine.from_config(cfg, plan,
serving)`` together with a ``core.plan.DeploymentPlan`` — the scheduler's
verdict (replica layouts, roles, spec depths, KV precisions, host-tier
split) — so the config says HOW to serve and the plan says WHERE.

The port's copy of repro.serving.config, flag for flag and with the same
defaults; ``InferenceEngine.from_config`` serves every flag.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import cluster as cl
from repro_torch.core import cost_model as cm

CLUSTERS = {
    "case_study": cl.case_study_cluster,
    "half_price": cl.hetero_half_price,
    "full_price": cl.hetero_full_price,
    "homogeneous": cl.homogeneous_a100,
    "tpu_mixed": cl.tpu_mixed_slices,
}


def _f(default, help="", choices=None):
    meta: Dict[str, Any] = {"help": help}
    if choices is not None:
        meta["choices"] = choices
    return dataclasses.field(default=default, metadata=meta)


@dataclasses.dataclass
class ServingConfig:
    """Every CLI-reachable serving knob, typed, in declaration order."""

    # ---- model / pool / workload shape ---------------------------------
    arch: str = _f("h2o-danube-1.8b", "model architecture from configs/")
    reduced: bool = _f(False, "serve the reduced variant (CPU-sized) of "
                              "the scheduled architecture")
    cluster: str = _f("case_study", "GPU pool to schedule on",
                      choices=tuple(CLUSTERS))
    rate: float = _f(2.0, "Poisson arrival rate (req/s)")
    duration: float = _f(5.0, "workload duration (s)")
    deadline: float = _f(30.0, "per-request SLO deadline (s)")
    out_len: int = _f(8, "decode tokens per request")
    prompt_len: int = _f(24, "prompt tokens per request")
    search_iters: int = _f(10, "genetic search iterations")
    seed: int = _f(0, "workload / search / params seed")
    # ---- engine policy and KV layout -----------------------------------
    policy: str = _f("continuous", "iteration-level slot batching vs the "
                                   "paper's static whole-batch engine",
                     choices=("continuous", "static"))
    cache_layout: str = _f("contiguous", "per-slot max_len cache rows vs "
                                         "block-paged KV with per-stage "
                                         "pools (docs/memory.md)",
                           choices=("contiguous", "paged"))
    block_size: int = _f(16, "KV page size in tokens (paged layout)")
    prefix_caching: bool = _f(False, "alias block-aligned shared prompt "
                                     "prefixes copy-on-write and prefill "
                                     "only cold suffixes (paged layout "
                                     "only)")
    prefill_chunk: int = _f(0, "split prefills longer than this many "
                               "tokens into chunks interleaved with "
                               "decode iterations (0 = one-shot; paged "
                               "layout only)")
    prefix_hit_rate: float = _f(0.0, "expected fraction of prompt tokens "
                                     "served from the prefix cache; the "
                                     "scheduler plans KV capacity against "
                                     "the deduplicated demand")
    shared_prefix: int = _f(0, "generate prompts with this many shared "
                               "system-prompt tokens (exercises the "
                               "prefix cache)")
    # ---- host tier / cluster-wide prefix directory ---------------------
    host_mem_gb: float = _f(0.0, "pool-wide host-memory budget for the "
                                 "page tier (GB), split across replicas "
                                 "by KV-capacity deficit (paged + "
                                 "--prefix-caching)")
    host_swap_gbps: float = _f(0.0, "host<->device swap (and peer-fetch) "
                                    "bandwidth in Gbit/s the scheduler "
                                    "prices tiered hits at (0 = ideal "
                                    "free swap)")
    host_swap_cost: float = _f(0.0, "serving-clock cost of swapping one "
                                    "block between tiers, as a fraction "
                                    "of one iteration (virtual-clock "
                                    "replays only)")
    cluster_prefix: bool = _f(False, "join every replica into a shared "
                                     "prefix directory; peer prefixes "
                                     "fetch over the KV link and the "
                                     "router scores admission by "
                                     "resident prefix")
    prefix_route_weight: float = _f(0.25, "router weight of one resident "
                                          "prefix block against queue "
                                          "depth (0 = pure least-loaded)")
    route_seed: Optional[int] = _f(None, "seed the router's dispatch "
                                         "tiebreaks instead of the "
                                         "deterministic lowest-replica-id "
                                         "order")
    prefix_working_set: int = _f(0, "hot shared-prefix working set in "
                                    "TOKENS: the scheduler derives the "
                                    "achievable per-replica hit rate "
                                    "from tiered residency instead of "
                                    "trusting --prefix-hit-rate verbatim")
    # ---- disaggregated prefill/decode ----------------------------------
    disaggregate: bool = _f(False, "split prefill and decode across "
                                   "replicas; the scheduler also searches "
                                   "the role split (paged layout, >= 2 "
                                   "replicas)")
    kv_link_gbps: float = _f(0.0, "flat bandwidth of the prefill->decode "
                                  "KV link in Gbit/s (0 = per-pair costs "
                                  "from the cluster's comm matrices)")
    # ---- speculative decoding ------------------------------------------
    spec_decode: bool = _f(False, "speculative decoding: propose up to "
                                  "--spec-k tokens per slot per iteration "
                                  "and commit the verified prefix in one "
                                  "multi-token target step (paged layout "
                                  "+ attention-only stacks)")
    draft_model: str = _f("", "draft architecture from configs/ for the "
                              "proposer (empty = weight-free n-gram / "
                              "prompt-lookup proposing)")
    spec_k: int = _f(4, "draft tokens proposed per target step; the "
                        "scheduler's acceptance-aware search may deepen "
                        "or shallow this per replica")
    spec_alpha: float = _f(0.7, "expected per-token draft acceptance rate "
                                "the scheduler plans decode cost per "
                                "COMMITTED token with")
    spec_draft_cost: float = _f(0.0, "modeled cost of one draft step "
                                     "(absolute seconds for the "
                                     "scheduler; per proposed token as an "
                                     "iteration fraction in virtual-clock "
                                     "replays)")
    # ---- KV precision / sanitizer --------------------------------------
    kv_dtype: str = _f("auto", "paged KV pool storage precision; 'auto' "
                               "keeps the model default, 'search' lets "
                               "the scheduler pick per replica",
                       choices=("auto", "search", "fp32", "bf16", "int8",
                                "fp8"))
    kv_guard_layers: int = _f(0, "pin this many layers at EACH END of the "
                                 "stack at model precision under a "
                                 "quantized --kv-dtype")
    kvsan: bool = _f(False, "serve under the KVSAN page-lifecycle "
                            "sanitizer; leaks surface as "
                            "ServeStats.kvsan_leaks (paged layout)")

    # ---- observability (repro_torch.obs) ---------------------------------
    trace_out: str = _f("", "write a Chrome-trace/Perfetto JSON of the "
                            "serve's lifecycle spans to this path "
                            "(empty = tracing off, zero overhead)")
    metrics_out: str = _f("", "write the serve's metrics registry "
                              "(counters/gauges/histograms) as JSONL to "
                              "this path")
    calibrate: bool = _f(False, "record predicted phase costs alongside "
                                "observed span durations and print the "
                                "predicted-vs-observed calibration table")

    # ---- argparse / serialization --------------------------------------

    @classmethod
    def add_args(cls, ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
        """Generate the CLI from the field schema: one flag per field,
        ``--kebab-case`` names, bools as store_true."""
        for f in dataclasses.fields(cls):
            flag = "--" + f.name.replace("_", "-")
            help_ = f.metadata.get("help", "")
            choices = f.metadata.get("choices")
            if f.type == "bool" or isinstance(f.default, bool):
                ap.add_argument(flag, action="store_true",
                                default=f.default, help=help_)
            elif f.name == "route_seed":
                ap.add_argument(flag, type=int, default=None, help=help_)
            else:
                ap.add_argument(flag, type=type(f.default),
                                default=f.default, choices=choices,
                                help=help_)
        return ap

    @classmethod
    def from_args(cls, args: argparse.Namespace) -> "ServingConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in vars(args).items() if k in names})

    @classmethod
    def parse(cls, argv: Optional[Sequence[str]] = None) -> "ServingConfig":
        ap = argparse.ArgumentParser()
        cls.add_args(ap)
        return cls.from_args(ap.parse_args(argv))

    def to_args(self) -> List[str]:
        """Back to an argv list; defaults are omitted, so
        ``from_args(parse(to_args(cfg))) == cfg``."""
        out: List[str] = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v == f.default:
                continue
            flag = "--" + f.name.replace("_", "-")
            if isinstance(v, bool):
                out.append(flag)
            else:
                out.extend([flag, str(v)])
        return out

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ServingConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in json.loads(s).items() if k in names})

    # ---- feature gating -------------------------------------------------

    def normalized(self) -> "ServingConfig":
        """Apply the layout-compatibility rules, warning on each downgrade
        (same behavior the launch driver used to inline). Idempotent:
        a consistent config comes back unchanged."""
        c = dataclasses.replace(self)
        if c.prefix_hit_rate and c.cache_layout != "paged":
            warnings.warn(
                "--prefix-hit-rate only affects capacity planning with "
                "--cache-layout paged (contiguous replicas are simulated "
                "unbounded); ignoring it", stacklevel=2)
            c.prefix_hit_rate = 0.0
        if c.disaggregate and c.cache_layout != "paged":
            warnings.warn(
                "--disaggregate needs --cache-layout paged (the KV "
                "handoff is a page transfer); serving colocated",
                stacklevel=2)
            c.disaggregate = False
        if c.spec_decode and c.cache_layout != "paged":
            warnings.warn(
                "--spec-decode needs --cache-layout paged (multi-token "
                "verification runs through the paged context path); "
                "serving without it", stacklevel=2)
            c.spec_decode = False
        if c.kv_dtype != "auto" and c.cache_layout != "paged":
            warnings.warn(
                "--kv-dtype needs --cache-layout paged (precision is a "
                "page-pool layout); serving at model precision",
                stacklevel=2)
            c.kv_dtype = "auto"
        if (c.host_mem_gb > 0 or c.cluster_prefix) \
                and not (c.cache_layout == "paged" and c.prefix_caching):
            warnings.warn(
                "--host-mem-gb/--cluster-prefix need --cache-layout "
                "paged with --prefix-caching (tiers and the directory "
                "hold prefix blocks); serving without them", stacklevel=2)
            c.host_mem_gb = 0.0
            c.cluster_prefix = False
        return c

    # ---- derived planning inputs ----------------------------------------

    def pool(self):
        return CLUSTERS[self.cluster]()

    def fixed_kv_dtype(self) -> Optional[str]:
        """The one pool-wide precision, or None when 'auto' (model
        default) / 'search' (per-replica scheduler choice)."""
        return None if self.kv_dtype in ("auto", "search") else self.kv_dtype

    def task(self) -> cm.Task:
        # the scheduler must plan for the prompts the engine will actually
        # serve: shared_prefix prepends that many system-prompt tokens
        return cm.Task(batch=1, s_in=self.prompt_len + self.shared_prefix,
                       s_out=self.out_len)

    def schedule_kwargs(self) -> Dict[str, Any]:
        """Kwargs for ``core.scheduler.schedule`` beyond (pool, arch,
        task)."""
        return dict(
            deadline=self.deadline, rate=self.rate,
            iters=self.search_iters, seed=self.seed,
            kv_block_size=(self.block_size
                           if self.cache_layout == "paged" else None),
            prefix_hit_rate=self.prefix_hit_rate,
            disaggregate=self.disaggregate,
            kv_link_gbps=self.kv_link_gbps,
            spec_decode=self.spec_decode,
            spec_alpha=self.spec_alpha,
            spec_draft_cost=self.spec_draft_cost,
            max_spec_k=max(self.spec_k, 1),
            kv_dtype=self.fixed_kv_dtype(),
            kv_dtype_search=(self.kv_dtype == "search"),
            host_tier_bytes=self.host_mem_gb * 1e9,
            host_swap_gbps=self.host_swap_gbps,
            prefix_working_set=self.prefix_working_set,
            cluster_prefix=self.cluster_prefix)

    def max_len(self) -> int:
        """Cache capacity per slot: prompt + jitter headroom + decode
        budget, rounded up to whole pages under the paged layout."""
        n = self.prompt_len + self.shared_prefix + 8 + self.out_len
        if self.cache_layout == "paged":
            n += (-n) % self.block_size
        return n

    def guard_layers(self, num_layers: int) -> List[int]:
        """Global layer ids pinned at model precision: the first/last
        ``kv_guard_layers`` of the SERVED stack."""
        if self.kv_guard_layers <= 0:
            return []
        n = min(self.kv_guard_layers, num_layers // 2)
        return list(range(n)) + list(range(num_layers - n, num_layers))

    def workload(self, vocab_size: int):
        """The synthetic request stream this config describes."""
        from repro_torch.serving.request import (shared_prefix_workload,
                                           synth_workload)
        if self.shared_prefix:
            return shared_prefix_workload(
                rate=self.rate, duration=self.duration, vocab=vocab_size,
                shared_len=self.shared_prefix, unique_len=self.prompt_len,
                unique_jitter=4, out_len=self.out_len, seed=self.seed)
        return synth_workload(rate=self.rate, duration=self.duration,
                              vocab=vocab_size, prompt_len=self.prompt_len,
                              prompt_jitter=4, out_len=self.out_len,
                              seed=self.seed)
