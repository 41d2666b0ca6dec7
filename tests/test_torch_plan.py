"""The port's plan surface, ServingConfig, InferenceEngine.from_config and
serve launcher against the JAX package's, on the CPU: DeploymentPlan /
PlanDiff semantics and round trips (mirroring tests/test_plan.py, whose
Hypothesis case becomes a seeded parametrised one), the same argv parsed
by both ServingConfigs, the slice as a whole (schedule -> scale ->
from_config -> serve on a VirtualClock with bridged weights: identical
tokens and ServeStats), the Router's seeded tiebreaks, the flags the port
does not serve yet and the ones it serves since static batching and the
contiguous layout were ported, and ``launch.serve.main``'s report
lines."""
import argparse
import dataclasses
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config
from repro.core import genetic as jgen
from repro.core import plan as jplan
from repro.core.scheduler import schedule as jschedule
from repro.launch import serve as jserve
from repro.models import model as JM
from repro.serving import config as jconfig
from repro.serving import request as jreq
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving.loop import VirtualClock as JClock
from repro_torch import bridge
from repro_torch.configs import get_config as port_config
from repro_torch.core import genetic as pgen
from repro_torch.core import plan as pplan
from repro_torch.core.scheduler import schedule as pschedule
from repro_torch.launch import serve as pserve
from repro_torch.serving import config as pconfig
from repro_torch.serving import request as preq
from repro_torch.serving.engine import InferenceEngine as PEngine
from repro_torch.serving.loop import ServeStats as PStats
from repro_torch.serving.loop import VirtualClock as PClock

ROLES = ["both", "prefill", "decode"]


def _asg(mod, *groups, layers=4):
    return mod.Assignment([mod.PipelinePlan([mod.StagePlan(list(g), layers)],
                                            cost=0.1, bottleneck=0.1)
                           for g in groups])


def _plans(groups, roles=None):
    """The same plan in both packages."""
    return tuple(m.DeploymentPlan.from_search(_asg(m, *groups), roles=roles)
                 for m in (jplan, pplan))


def _port_asg(asg):
    return pplan.Assignment([pplan.PipelinePlan(
        [pplan.StagePlan(list(s.device_ids), s.num_layers)
         for s in p.stages], cost=p.cost, bottleneck=p.bottleneck)
        for p in asg.pipelines])


# ---------------------------------------------------------------------------
# DeploymentPlan / PlanDiff
# ---------------------------------------------------------------------------

def test_from_search_preserves_noneness():
    for mod in (jplan, pplan):
        plan = mod.DeploymentPlan.from_search(_asg(mod, [0, 1], [2, 3]))
        assert plan.num_replicas == 2
        assert plan.roles is None and plan.spec_ks is None
        assert plan.kv_dtypes is None and plan.host_blocks is None
    dims = dict(roles=["prefill", "decode"], spec_ks=[2, 0],
                kv_dtypes=["int8", None], host_blocks=[4, 0])
    for drop in (None,) + tuple(dims):
        kw = {k: v for k, v in dims.items() if k != drop}
        a, b = (m.DeploymentPlan.from_search(_asg(m, [0, 1], [2, 3]), **kw)
                for m in (jplan, pplan))
        assert b.dims == a.dims
        assert b.describe() == a.describe()
        for view in ("roles", "spec_ks", "kv_dtypes", "host_blocks"):
            assert getattr(b, view) == getattr(a, view), view
    assert pplan.PLAN_DIMS == jplan.PLAN_DIMS
    with pytest.raises(ValueError, match="spec_ks"):
        pplan.DeploymentPlan.from_search(_asg(pplan, [0], [1]), spec_ks=[1])


def test_replica_key_assignment_and_validate():
    r = pplan.ReplicaSpec(pipeline=_asg(pplan, [3, 1]).pipelines[0])
    assert r.key == frozenset({1, 3}) and r.device_ids == [3, 1]
    asg = _asg(pplan, [0, 1], [2], [3, 4, 5])
    got = pplan.DeploymentPlan.from_search(asg).assignment
    assert [p.device_ids for p in got.pipelines] \
        == [p.device_ids for p in asg.pipelines]
    pplan.DeploymentPlan.from_search(asg).validate(4)
    # the port raises ValueError where the reference asserts
    with pytest.raises(ValueError, match="does not sum"):
        pplan.DeploymentPlan.from_search(asg).validate(5)
    with pytest.raises(ValueError, match="assigned twice"):
        pplan.DeploymentPlan.from_search(_asg(pplan, [0, 1], [1])).validate(4)


def test_diff_empty_on_identical_and_detects_changes():
    for a, b in zip(_plans([[0, 1], [2, 3]]), _plans([[0, 1], [2, 3]])):
        assert a.diff(b).is_empty and a.diff(b).describe() == "no-op"
    ja, pa = _plans([[0, 1], [2, 3]], roles=["both", "both"])
    jb, pb = _plans([[0, 1], [4, 5]], roles=["prefill", "decode"])
    d = pa.diff(pb)
    assert {tuple(sorted(r.key)) for r in d.removed} == {(2, 3)}
    assert {tuple(sorted(r.key)) for r in d.added} == {(4, 5)}
    assert len(d.changed) == 1
    old, new = d.changed[0]
    assert old.key == new.key == frozenset({0, 1})
    assert old.role == "both" and new.role == "prefill"
    assert d.describe() == ja.diff(jb).describe()
    txt = _plans([[0, 1]], roles=["both"])[1].diff(
        _plans([[0, 1], [2]], roles=["prefill", "decode"])[1]).describe()
    assert "+[" in txt and "->" in txt


def _random_plans(rng):
    n_dev = rng.randint(4, 12)
    devs = list(range(n_dev))
    rng.shuffle(devs)

    def cut(ds):
        groups, i = [], 0
        while i < len(ds):
            k = rng.randint(1, 4)
            groups.append(ds[i:i + k])
            i += k
        return groups

    ga = cut(devs)[:rng.randint(1, 5)]
    gb = cut(devs)[:rng.randint(1, 5)]
    ra = [str(rng.choice(ROLES)) for _ in ga]
    rb = [str(rng.choice(ROLES)) for _ in gb]
    return _plans(ga, ra), _plans(gb, rb)


@pytest.mark.parametrize("seed", range(6))
def test_apply_round_trip_equals_reference(seed):
    # test_plan.py's deterministic case and, seeded, its property case
    rng = np.random.RandomState(seed)
    for _ in range(20):
        (ja, pa), (jb, pb) = _random_plans(rng)
        assert pa.apply(pa.diff(pb)).canonical() == pb.canonical()
        assert pb.apply(pb.diff(pa)).canonical() == pa.canonical()
        assert pa.diff(pb).describe() == ja.diff(jb).describe()
        assert pa.apply(pa.diff(pb)).describe() \
            == ja.apply(ja.diff(jb)).describe()


def _result(mod, gen, **dims):
    plan = mod.DeploymentPlan.from_search(_asg(mod, [0, 1], [2, 3]), **dims)
    return gen.SearchResult(plan=plan, attainment=1.0, history=[],
                            evaluations=0)


def test_search_result_plan_is_primary():
    res = _result(pplan, pgen, roles=["prefill", "decode"])
    assert res.plan.roles == ["prefill", "decode"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert res.assignment.num_replicas == 2


@pytest.mark.parametrize("name,value", [
    ("roles", ["prefill", "decode"]),
    ("spec_ks", [3, 0]),
    ("kv_dtypes", ["int8", None]),
    ("host_blocks", [4, 0]),
])
def test_search_result_deprecated_properties(name, value):
    for mod, gen in ((jplan, jgen), (pplan, pgen)):
        res = _result(mod, gen, **{name: value})
        with pytest.warns(DeprecationWarning, match=name):
            assert getattr(res, name) == value
        with pytest.warns(DeprecationWarning):
            assert getattr(_result(mod, gen), name) is None


# ---------------------------------------------------------------------------
# ServingConfig: the same argv through both packages
# ---------------------------------------------------------------------------

ARGVS = {
    "defaults": [],
    "paged-prefix": ["--arch", "granite-8b", "--reduced", "--cluster",
                     "half_price", "--cache-layout", "paged", "--block-size",
                     "8", "--prefix-caching", "--prefill-chunk", "16",
                     "--shared-prefix", "24", "--prompt-len", "6",
                     "--out-len", "4", "--rate", "4", "--duration", "2",
                     "--search-iters", "2", "--deadline", "60"],
    "spec-quant": ["--arch", "llama2-70b", "--cache-layout", "paged",
                   "--spec-decode", "--spec-k", "3", "--kv-dtype", "search",
                   "--kv-guard-layers", "2", "--route-seed", "11",
                   "--draft-model", "granite-8b", "--spec-alpha", "0.6"],
    "gated": ["--disaggregate", "--spec-decode", "--kv-dtype", "fp8",
              "--host-mem-gb", "1.0", "--cluster-prefix",
              "--prefix-hit-rate", "0.5"],
    "tiers": ["--cache-layout", "paged", "--prefix-caching",
              "--host-mem-gb", "2.0", "--host-swap-gbps", "64",
              "--prefix-working-set", "512", "--kvsan", "--policy",
              "static", "--trace-out", "t.json", "--calibrate"],
}


def _both(argv):
    return (jconfig.ServingConfig.parse(argv),
            pconfig.ServingConfig.parse(argv))


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_serving_config_equals_reference(name):
    j, p = _both(ARGVS[name])
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    assert p.to_args() == j.to_args()
    assert p.to_json() == j.to_json()
    assert pconfig.ServingConfig.parse(p.to_args()) == p
    assert pconfig.ServingConfig.from_json(p.to_json()) == p
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        jn = j.normalized()
    with warnings.catch_warnings(record=True) as wp:
        warnings.simplefilter("always")
        pn = p.normalized()
    assert [str(w.message) for w in wp] == [str(w.message) for w in wj]
    assert dataclasses.asdict(pn) == dataclasses.asdict(jn)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert pn.normalized() == pn           # idempotent
    for a, b in ((j, p), (jn, pn)):
        assert dataclasses.asdict(b.task()) == dataclasses.asdict(a.task())
        assert b.schedule_kwargs() == a.schedule_kwargs()
        assert b.max_len() == a.max_len()
        assert b.fixed_kv_dtype() == a.fixed_kv_dtype()
        for n in (1, 2, 8, 80):
            assert b.guard_layers(n) == a.guard_layers(n)
        ja, pa = a.pool(), b.pool()
        assert [d.type for d in pa.devices] == [d.type for d in ja.devices]
        for x, y in zip(a.workload(1000), b.workload(1000)):
            assert (y.rid, y.arrival, y.max_new_tokens) \
                == (x.rid, x.arrival, x.max_new_tokens)
            np.testing.assert_array_equal(y.prompt, x.prompt)
        assert len(b.workload(1000)) == len(a.workload(1000))


def test_serving_config_schema_equals_reference():
    ja, pa = argparse.ArgumentParser(), argparse.ArgumentParser()
    jconfig.ServingConfig.add_args(ja)
    pconfig.ServingConfig.add_args(pa)
    spec = [(a.dest, a.option_strings, a.default, a.choices, a.help,
             type(a).__name__) for a in pa._actions]
    assert spec == [(a.dest, a.option_strings, a.default, a.choices, a.help,
                     type(a).__name__) for a in ja._actions]
    flags = {a.dest for a in pa._actions if a.dest != "help"}
    assert flags == {f.name for f in dataclasses.fields(pconfig.ServingConfig)}
    assert list(pconfig.CLUSTERS) == list(jconfig.CLUSTERS)
    assert pconfig.ServingConfig().cache_layout == "contiguous"


# ---------------------------------------------------------------------------
# The slice as a whole: schedule -> scale -> from_config -> serve
# ---------------------------------------------------------------------------

def _schedule_both(sv_j, sv_p):
    res_j = jschedule(sv_j.pool(), sv_j.arch, sv_j.task(),
                      **sv_j.schedule_kwargs())
    res_p = pschedule(sv_p.pool(), sv_p.arch, sv_p.task(),
                      **sv_p.schedule_kwargs())
    assert res_p.plan.describe() == res_j.plan.describe()
    assert res_p.attainment == res_j.attainment
    return res_j, res_p


SPLITS = {
    "case-study": [([0, 1, 2, 3], 48), ([4, 5], 20), ([6, 7], 12)],
    "pp8": [([d], 10) for d in range(8)],
    "three": [([0, 1], 26), ([2, 3], 27), ([4, 5], 27)],
    "two": [([0, 1, 2, 3], 40), ([4, 5, 6, 7], 40)],
    "one": [(list(range(8)), 80)],
}


@pytest.mark.parametrize("name", sorted(SPLITS) + ["scheduled"])
def test_scale_assignment_equals_reference(name):
    if name == "scheduled":
        argv = ["--arch", "llama2-70b", "--cluster", "half_price",
                "--cache-layout", "paged", "--prompt-len", "512",
                "--out-len", "32", "--rate", "4", "--search-iters", "2"]
        res_j, res_p = _schedule_both(*_both(argv))
        asgs = res_j.assignment, res_p.assignment
    else:
        asgs = tuple(m.Assignment([m.PipelinePlan(
            [m.StagePlan(d, n) for d, n in SPLITS[name]], 1.5, 0.5)])
            for m in (jplan, pplan))
    for run in (1, 2, 3, 5, 8):
        want = jserve.scale_assignment(asgs[0], 80, run)
        got = pserve.scale_assignment(asgs[1], 80, run)
        assert got.describe() == want.describe()
        assert [p.device_ids for p in got.pipelines] \
            == [p.device_ids for p in want.pipelines]
        assert [(p.cost, p.bottleneck) for p in got.pipelines] \
            == [(p.cost, p.bottleneck) for p in want.pipelines]
        got.validate(run)


def _serve_slice(argv, tree):
    """Parse, schedule, scale and build in both packages, then serve the
    config's workload on a VirtualClock."""
    sv_j, sv_p = (s.normalized() for s in _both(argv))
    res_j, res_p = _schedule_both(sv_j, sv_p)
    cfg_full = get_config(sv_j.arch)
    cfg = cfg_full.reduced()
    asg_j = jserve.scale_assignment(res_j.assignment, cfg_full.num_layers,
                                    cfg.num_layers)
    asg_p = pserve.scale_assignment(res_p.assignment, cfg_full.num_layers,
                                    cfg.num_layers)
    assert asg_p.describe() == asg_j.describe()
    jeng = JEngine.from_config(cfg, res_j.plan, sv_j, assignment=asg_j,
                               params=jax.tree.map(jnp.asarray, tree))
    peng = PEngine.from_config(
        port_config(sv_p.arch).reduced(), res_p.plan, sv_p,
        assignment=asg_p, params=bridge.params_from_numpy(tree, device="cpu"),
        device="cpu")
    return (sv_j, jeng), (sv_p, peng)


@pytest.fixture(scope="module")
def granite():
    cfg = get_config("granite-8b").reduced()
    return jax.tree.map(np.asarray, JM.init_params(cfg,
                                                   jax.random.PRNGKey(0)))


def _assert_same_serve(jreqs, preqs, jstats, pstats):
    assert len(preqs) == len(jreqs) > 0
    for a, b in zip(jreqs, preqs):
        assert a.output is not None and len(a.output) == a.max_new_tokens
        assert list(b.output) == list(a.output), a.rid
        assert (b.start_time, b.finish_time) == (a.start_time, a.finish_time)
    for f in dataclasses.fields(PStats):
        assert getattr(pstats, f.name) == getattr(jstats, f.name), f.name


def test_scheduled_slice_serves_token_identical_to_reference(granite):
    # granite-8b reduced on half_price: four scheduled replicas, one stage
    # each, sharing a system prompt through the prefix cache
    (sv_j, jeng), (sv_p, peng) = _serve_slice(ARGVS["paged-prefix"], granite)
    assert len(peng.replicas) == len(jeng.replicas) > 1
    jreqs = sv_j.workload(jeng.cfg.vocab_size)
    preqs = sv_p.workload(peng.cfg.vocab_size)
    jstats = jeng.serve(jreqs, deadline=sv_j.deadline, clock=JClock())
    pstats = peng.serve(preqs, deadline=sv_p.deadline, clock=PClock())
    _assert_same_serve(jreqs, preqs, jstats, pstats)
    assert pstats.prefix_hits > 0


def _admissions(eng):
    """Record which replica each request is admitted to."""
    seen = []
    for i, w in enumerate(eng.router.workers):
        def admit(reqs, now, _real=w.admit, _i=i):
            seen.extend((r.rid, _i) for r in reqs)
            return _real(reqs, now)
        w.admit = admit
    return seen


def test_route_seed_routes_as_reference(granite):
    cfg = get_config("granite-8b").reduced()
    asg = _asg(jplan, [0], [1], layers=cfg.num_layers)
    routes = {}
    for seed in (None, 3):
        common = dict(n_slots=2, max_len=32, block_size=8,
                      cache_layout="paged", route_seed=seed)
        jeng = JEngine(cfg, asg, params=jax.tree.map(jnp.asarray, granite),
                       **common)
        peng = PEngine(port_config("granite-8b").reduced(), _port_asg(asg),
                       params=bridge.params_from_numpy(granite, device="cpu"),
                       device="cpu", **common)
        # arrivals mostly find both replicas idle: ties, which the seeded
        # draw breaks another way than the lowest replica id
        kw = dict(rate=0.25, duration=60.0, vocab=cfg.vocab_size,
                  prompt_len=6, prompt_jitter=3, out_len=3, seed=2)
        jreqs, preqs = jreq.synth_workload(**kw), preq.synth_workload(**kw)
        jseen, pseen = _admissions(jeng), _admissions(peng)
        jstats = jeng.serve(jreqs, deadline=60.0, clock=JClock())
        pstats = peng.serve(preqs, deadline=60.0, clock=PClock())
        assert pseen == jseen
        _assert_same_serve(jreqs, preqs, jstats, pstats)
        routes[seed] = pseen
    assert {i for _, i in routes[None]} == {0}
    assert {i for _, i in routes[3]} == {0, 1}


# ---------------------------------------------------------------------------
# Flags the port refused until the multi-replica features were ported
# ---------------------------------------------------------------------------

UNSERVED = {
    "--host-mem-gb": ["--prefix-caching", "--host-mem-gb", "1.0"],
    "--cluster-prefix": ["--prefix-caching", "--cluster-prefix"],
    "--kvsan": ["--kvsan"],
    "--trace-out": ["--trace-out", "trace.json"],
    "--metrics-out": ["--metrics-out", "metrics.jsonl"],
    "--calibrate": ["--calibrate"],
}


@pytest.mark.parametrize("flag", sorted(UNSERVED) + ["--disaggregate"])
def test_from_config_refuses_unserved_flags(flag):
    # none is refused any more: each builds the engine the reference's
    # from_config builds, the feature threaded through to the workers
    cfg = port_config("granite-8b").reduced()
    asg = _asg(pplan, [0], [1], layers=cfg.num_layers)
    plan = pplan.DeploymentPlan.from_search(
        asg, host_blocks=[4, 0] if flag == "--host-mem-gb" else None)
    if flag == "--disaggregate":
        argv = ["--cache-layout", "paged", "--disaggregate"]
        # colocated serving won the role search: served colocated
        eng = PEngine.from_config(cfg, pplan.DeploymentPlan.from_search(asg),
                                  pconfig.ServingConfig.parse(argv),
                                  device="cpu")
        assert eng.roles == ["both", "both"] and eng.router.dispatcher is None
        plan = pplan.DeploymentPlan.from_search(asg,
                                                roles=["prefill", "decode"])
    else:
        argv = ["--cache-layout", "paged"] + UNSERVED[flag]
    sv = pconfig.ServingConfig.parse(argv)
    eng = PEngine.from_config(cfg, plan, sv, device="cpu")
    w0, w1 = eng.router.workers
    if flag == "--disaggregate":
        assert eng.roles == ["prefill", "decode"]
        assert (w0.role, w1.role) == ("prefill", "decode")
        assert w0.dispatcher is eng.router.dispatcher
    elif flag == "--host-mem-gb":
        assert (w0.host_blocks, w1.host_blocks) == (4, 0)
    elif flag == "--cluster-prefix":
        assert eng.router.cluster_dir is not None
        assert w0.cluster_dir is w1.cluster_dir is eng.router.cluster_dir
    elif flag == "--kvsan":
        assert w0.kvsan and w1.kvsan and w0._san is not None
    else:                                  # the launcher's own flags
        assert sv.normalized().trace_out or sv.normalized().metrics_out \
            or sv.normalized().calibrate


# the flags that from_config refused until static batching and the
# contiguous layout were ported, each now served as the reference serves it
SERVED = {
    "--policy static": ["--policy", "static"],
    "--cache-layout contiguous": [],     # the reference's default layout
}


@pytest.mark.parametrize("flag", sorted(SERVED))
def test_from_config_serves_the_flags_it_refused(flag, granite):
    argv = ["--arch", "granite-8b", "--reduced", "--cluster", "half_price",
            "--prompt-len", "6", "--out-len", "4", "--rate", "4",
            "--duration", "2", "--search-iters", "2",
            "--deadline", "60"] + SERVED[flag]
    (sv_j, jeng), (sv_p, peng) = _serve_slice(argv, granite)
    want = "StaticBatcher" if "static" in flag else "PipelineBatcher"
    assert {type(w).__name__ for w in peng.router.workers} == {want}
    assert [type(w).__name__ for w in peng.router.workers] \
        == [type(w).__name__ for w in jeng.router.workers]
    jreqs = sv_j.workload(jeng.cfg.vocab_size)
    preqs = sv_p.workload(peng.cfg.vocab_size)
    jstats = jeng.serve(jreqs, deadline=sv_j.deadline, clock=JClock())
    pstats = peng.serve(preqs, deadline=sv_p.deadline, clock=PClock())
    _assert_same_serve(jreqs, preqs, jstats, pstats)


def test_from_config_seeds_weights_and_threads_the_plan(monkeypatch):
    from repro_torch.models import model as PM
    seeds = []
    real = PM.init_params

    def init_params(cfg, seed=0, **kw):
        seeds.append(seed)
        return real(cfg, seed, **kw)
    monkeypatch.setattr(PM, "init_params", init_params)
    cfg = port_config("granite-8b").reduced()
    asg = _asg(pplan, [0], [1], layers=cfg.num_layers)
    plan = pplan.DeploymentPlan.from_search(asg, spec_ks=[2, 0],
                                            kv_dtypes=["int8", None])
    sv = pconfig.ServingConfig.parse(
        ["--cache-layout", "paged", "--seed", "5", "--spec-decode",
         "--kv-dtype", "search", "--kv-guard-layers", "1"])
    eng = PEngine.from_config(cfg, plan, sv, device="cpu")
    assert seeds == [5]                   # init_params(cfg, serving.seed)
    w0, w1 = eng.router.workers
    assert (w0.spec.k, w1.spec) == (2, None)
    assert (w0.kv_dtype, w1.kv_dtype) == ("int8", None)
    assert w0.max_len == sv.max_len() and w0.block_size == sv.block_size


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

class _Built(Exception):
    pass


@pytest.mark.parametrize("argv", [
    ["--arch", "granite-8b", "--reduced", "--cluster", "case_study",
     "--cache-layout", "paged", "--rate", "4", "--duration", "1",
     "--out-len", "4", "--search-iters", "2"],
    ["--arch", "granite-8b", "--reduced", "--cluster", "half_price",
     "--cache-layout", "paged", "--rate", "4", "--duration", "1",
     "--out-len", "4", "--search-iters", "2", "--spec-decode",
     "--kv-dtype", "search"],
    # the reference's defaults: h2o-danube-1.8b (sliding window), sent to
    # static batching with a warning, on the contiguous layout
    ["--reduced"],
    # an architecture of the zoo (q/k/v bias, MHA) on the paged layout
    ["--arch", "codeqwen1.5-7b", "--reduced", "--cluster", "case_study",
     "--cache-layout", "paged", "--rate", "4", "--duration", "1",
     "--out-len", "4", "--search-iters", "2"],
], ids=["paged", "spec-kv-search", "defaults", "codeqwen"])
def test_main_prints_the_reference_lines(argv, capsys, monkeypatch):
    pserve.main(argv, device="cpu")
    # the port names each replica's stages' devices after the build
    got = [x for x in capsys.readouterr().out.splitlines()
           if not x.startswith(pserve.DEVICES_LINE)]

    def built(*a, **k):
        raise _Built
    # the reference's lines up to the engine build (its serve would
    # compile the JAX engine; the port's serve is checked above)
    monkeypatch.setattr(JEngine, "from_config", built)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with pytest.raises(_Built):
        jserve.main()
    want = capsys.readouterr().out.splitlines()
    assert got[:len(want)] == want
    assert any(line.startswith("  assignment: ") for line in want)
    assert any("estimated SLO attainment" in line for line in want)
    assert got[len(want)].startswith("serving ")
    assert got[-1].startswith("  n=") and "slo=" in got[-1]
