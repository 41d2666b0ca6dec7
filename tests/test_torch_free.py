"""Engines free their memory when dropped (ROADMAP F8), on the CPU.

The host tier's spill and LRU-drop hooks, the cluster directory's
unpublish hook and peer map, and the Router <-> OnlineRescheduler pair
used to close reference cycles through the batchers, so a dropped engine
kept its page pools and weights until a full garbage collection (on the
card: device memory). With garbage collection off, each engine kind below
serves, is dropped, and must leave no page pool and no weight alive; its
tokens, every ServeStats field (and the controller's events) still equal
the JAX engine's on the same bridged granite-8b (reduced, fp32) weights.
A plain paged engine is the control."""
import dataclasses
import gc
import types
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config
from repro.core.plan import Assignment, PipelinePlan, StagePlan
from repro.models import model as JM
from repro.serving import request as jreq
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving.loop import VirtualClock as JClock
from repro.serving.resched import OnlineRescheduler as JCtl
from repro_torch import bridge
from repro_torch.configs import get_config as port_config
from repro_torch.core import plan as pplan
from repro_torch.serving import loop as ploop
from repro_torch.serving import request as preq
from repro_torch.serving.engine import InferenceEngine as PEngine
from repro_torch.serving.resched import OnlineRescheduler as PCtl

JPLAN = types.SimpleNamespace(Assignment=Assignment, PipelinePlan=PipelinePlan,
                              StagePlan=StagePlan)


def _asg(mod, n_rep, L):
    return mod.Assignment([
        mod.PipelinePlan([mod.StagePlan([2 * r], 1),
                          mod.StagePlan([2 * r + 1], L - 1)],
                         cost=0.1, bottleneck=0.1)
        for r in range(n_rep)])


def _families(mod, vocab):
    """Three prompt families of 24 tokens, each seen twice (prefix hits,
    spills and promotions on small pools)."""
    reqs = []
    for i in range(6):
        rng = np.random.RandomState(100 + i % 3)
        prompt = rng.randint(0, vocab, size=24).astype(np.int32)
        reqs.append(mod.Request(rid=i, prompt=prompt, max_new_tokens=3,
                                arrival=0.3 * i))
    return reqs


def _synth(mod, vocab):
    return mod.synth_workload(rate=10.0, duration=1.0, vocab=vocab,
                              prompt_len=10, prompt_jitter=5, out_len=3,
                              seed=2)


BASE = dict(policy="continuous", cache_layout="paged", n_slots=2,
            max_len=48, block_size=8)
# kind -> (replicas, workload, engine kwargs, kills of a controller or None)
KINDS = {
    # the control: no hook, no cycle
    "paged": (1, _families, {}, None),
    # pools too small for the three families: evictions spill to the host
    # tier (PrefixIndex.spill) and LRU drops fire HostPagePool.on_evict,
    # through KVSAN's chained wrappers
    "host-tier": (1, _families, dict(stage_blocks=[10, 10],
                                     prefix_caching=True, host_blocks=2,
                                     host_swap_cost=0.05, kvsan=True),
                  None),
    # two replicas behind one directory: each batcher's peer map and
    # unpublish hook
    "cluster-prefix": (2, _families, dict(prefix_caching=True,
                                          cluster_prefix=True), None),
    # a rescheduler that kills replica 1 mid-prefill
    "killing-rescheduler": (2, _synth, dict(kvsan=True), [(0.2, 1)]),
}


@pytest.fixture(scope="module")
def tree():
    cfg = get_config("granite-8b").reduced()
    return cfg, jax.tree.map(np.asarray,
                             JM.init_params(cfg, jax.random.PRNGKey(0)))


def _ref_serve(cfg, tree, kind):
    n_rep, make, kw, kills = KINDS[kind]
    eng = JEngine(cfg, _asg(JPLAN, n_rep, cfg.num_layers),
                  params=jax.tree.map(jnp.asarray, tree), **BASE, **kw)
    ctl = None
    if kills is not None:
        ctl = JCtl(kills=kills)
        eng.router.attach_controller(ctl)
    reqs = make(jreq, cfg.vocab_size)
    stats = eng.serve(reqs, deadline=1e9, clock=JClock())
    return ([list(r.output) for r in reqs], stats,
            None if ctl is None else ctl.events)


def _port_serve(tree, kind):
    """Serve `kind` on a port engine built here from its own bridged
    weights; return its outputs, stats, controller events and weak
    references to its page pools and weight leaves. Nothing else keeps
    the engine."""
    n_rep, make, kw, kills = KINDS[kind]
    pcfg = port_config("granite-8b").reduced()
    eng = PEngine(pcfg, _asg(pplan, n_rep, pcfg.num_layers),
                  params=bridge.params_from_numpy(tree, device="cpu"),
                  device="cpu", **BASE, **kw)
    ctl = None
    if kills is not None:
        ctl = PCtl(kills=kills)
        eng.router.attach_controller(ctl)
    reqs = make(preq, pcfg.vocab_size)
    stats = eng.serve(reqs, deadline=1e9, clock=ploop.VirtualClock())
    refs = []
    for pipe in eng.replicas:
        for caches in pipe.paged_caches:
            refs += [weakref.ref(c["k"]) for c in caches]
        refs += [weakref.ref(st.layer_params[0]["mixer"]["wq"])
                 for st in pipe.stages]
    workers = [weakref.ref(w) for w in eng.router.workers]
    return ([list(r.output) for r in reqs], stats,
            None if ctl is None else list(ctl.events), refs + workers)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_dropped_engine_frees_pools_and_weights(tree, kind):
    cfg, t = tree
    want, jstats, jevents = _ref_serve(cfg, t, kind)
    gc.collect()
    gc.disable()
    try:
        got, pstats, pevents, refs = _port_serve(t, kind)
        alive = [r for r in refs if r() is not None]
    finally:
        gc.enable()
    assert refs and not alive, \
        f"{kind}: {len(alive)} of {len(refs)} pools, weights or workers " \
        "outlive the dropped engine without a garbage collection"
    assert got == want
    for f in dataclasses.fields(ploop.ServeStats):
        assert getattr(pstats, f.name) == getattr(jstats, f.name), f.name
    assert pevents == jevents
    if kind == "host-tier":
        assert pstats.host_demotions > 0 and pstats.host_evictions > 0
    if kind == "cluster-prefix":
        assert pstats.prefix_fetches > 0
    if kind == "killing-rescheduler":
        assert [e["kind"] for e in pevents] == ["kill"]
