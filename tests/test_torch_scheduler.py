"""Parity of the port's scheduler (repro_torch.core) with the JAX package's
(repro.core), on the CPU: the catalog and the five pools, the cost model's
Table 1 terms over every reference configuration, the DP layout, the
K-means seeds and mutations, the SLO simulator, and the genetic search
itself, whose best plan, score, evaluation count and per-iteration best
scores must equal the reference's for the same seed. Mirrors the cases of
tests/test_scheduler.py at small ``iters``."""
import dataclasses
import itertools

import numpy as np
import pytest

from repro.configs import get_config, list_archs
from repro.core import cluster as jcl
from repro.core import cost_model as jcm
from repro.core import dp_layout as jdp
from repro.core import genetic as jgen
from repro.core import slo_sim as jsim
from repro.core.scheduler import schedule as jschedule
from repro_torch.configs import base as pbase
from repro_torch.core import cluster as pcl
from repro_torch.core import cost_model as pcm
from repro_torch.core import dp_layout as pdp
from repro_torch.core import genetic as pgen
from repro_torch.core import slo_sim as psim
from repro_torch.core.scheduler import schedule as pschedule
from repro_torch.serving.config import ServingConfig

POOLS = ("homogeneous_a100", "hetero_full_price", "hetero_half_price",
         "case_study_cluster", "tpu_mixed_slices")
TASK = (1, 128, 64)
REL = 1e-12


def _port_cfg(ref):
    """The reference's ModelConfig as the port's, field by field."""
    names = [f.name for f in dataclasses.fields(pbase.ModelConfig)]
    assert names == [f.name for f in dataclasses.fields(ref)]
    return pbase.ModelConfig(**{n: getattr(ref, n) for n in names})


def _profiles(arch, **kw):
    ref = get_config(arch)
    return (jcm.ModelProfile.from_config(ref, **kw),
            pcm.ModelProfile.from_config(_port_cfg(ref), **kw))


def _close(a, b):
    assert a == pytest.approx(b, rel=REL, abs=0.0) or a == b, (a, b)


@pytest.mark.parametrize("pool", POOLS)
def test_catalog_and_pools_equal(pool):
    assert {k: dataclasses.asdict(v) for k, v in pcl.GPU_CATALOG.items()} \
        == {k: dataclasses.asdict(v) for k, v in jcl.GPU_CATALOG.items()}
    a, b = getattr(jcl, pool)(), getattr(pcl, pool)()
    assert [dataclasses.asdict(d) for d in a.devices] \
        == [dataclasses.asdict(d) for d in b.devices]
    np.testing.assert_array_equal(a.lat, b.lat)
    np.testing.assert_array_equal(a.bw, b.bw)
    assert a.price_per_hour == b.price_per_hour
    assert a.machines() == b.machines()


@pytest.mark.parametrize("arch", list_archs())
def test_profile_and_table1_terms_equal(arch):
    jprof, pprof = _profiles(arch)
    assert dataclasses.asdict(jprof) == dataclasses.asdict(pprof)
    jpe, ppe = _profiles(arch, paper_exact=True)
    assert dataclasses.asdict(jpe) == dataclasses.asdict(ppe)
    jc, pc = jcl.tpu_mixed_slices(), pcl.tpu_mixed_slices()
    jt, pt = jcm.Task(*TASK), pcm.Task(*TASK)
    L = jprof.num_layers
    for devs, nxt, layers in (([0], [8], L), ([0, 1], [12, 13], L // 2),
                              ([4, 5, 6, 7], [8], max(1, L // 4))):
        for fn in ("comp_cost", "comm_tp_cost"):
            _close(getattr(pcm, fn)(pc, devs, layers, pprof, pt),
                   getattr(jcm, fn)(jc, devs, layers, jprof, jt))
        _close(pcm.comm_pp_cost(pc, devs, nxt, pt, pprof),
               jcm.comm_pp_cost(jc, devs, nxt, jt, jprof))
        for bs, kvd in ((0, None), (16, None), (16, "int8"), (8, "fp8")):
            assert pcm.mem_ok(pc, devs, layers, pprof, pt, bs, kvd) \
                == jcm.mem_ok(jc, devs, layers, jprof, jt, bs, kvd)
            assert pcm.concurrent_capacity(
                pc, devs, layers, pprof, pt, block_size=bs,
                prefix_hit_rate=0.3, kv_dtype=kvd) \
                == jcm.concurrent_capacity(
                    jc, devs, layers, jprof, jt, block_size=bs,
                    prefix_hit_rate=0.3, kv_dtype=kvd)
        stages, split = [devs, nxt], [layers, max(1, L - layers)]
        got = pcm.pipeline_phase_costs(pc, stages, split, pprof, pt)
        want = jcm.pipeline_phase_costs(jc, stages, split, jprof, jt)
        for k, v in want.as_dict().items():
            _close(got.as_dict()[k], v)
        for fn in ("pipeline_cost", "pipeline_bottleneck"):
            _close(getattr(pcm, fn)(pc, stages, split, pprof, pt),
                   getattr(jcm, fn)(jc, stages, split, jprof, jt))
    for step, draft, alpha in ((1.0, 0.5, 0.8), (10.0, 0.5, 0.8),
                               (1.0, 0.0, 0.8), (1.0, 0.5, 0.0),
                               (0.03, 1e-3, 0.7)):
        assert pcm.best_spec_k(step, draft, alpha, max_k=8) \
            == jcm.best_spec_k(step, draft, alpha, max_k=8)
        _close(pcm.spec_step_cost(step, draft, alpha, 3),
               jcm.spec_step_cost(step, draft, alpha, 3))


def test_dp_layout_equal_and_optimal_on_a_tiny_pool():
    jprof, pprof = _profiles("llama2-70b", paper_exact=True)
    jc, pc = jcl.case_study_cluster(), pcl.case_study_cluster()
    jt, pt = jcm.Task(*TASK), pcm.Task(*TASK)
    split = [40, 40]
    got = pdp.dp_assign(pc, list(range(8)), split, pprof, pt,
                        tp_candidates=(1, 2, 4))
    assert got == jdp.dp_assign(jc, list(range(8)), split, jprof, jt,
                                tp_candidates=(1, 2, 4))
    # Algorithm 1 == exhaustive enumeration (test_scheduler.py's case)
    got_cost = pcm.pipeline_cost(pc, got, split, pprof, pt)
    pools = {0: [0, 1, 2, 3], 1: [4, 5], 2: [6, 7]}
    best = float("inf")
    for m1, m2 in itertools.product(pools, repeat=2):
        for t1, t2 in itertools.product((1, 2, 4), repeat=2):
            if t1 > len(pools[m1]) or t2 > len(pools[m2]):
                continue
            s1 = pools[m1][:t1]
            s2 = [d for d in pools[m2] if d not in s1][:t2]
            if len(s2) < t2:
                continue
            best = min(best, pcm.pipeline_cost(pc, [s1, s2], split, pprof,
                                               pt))
    assert got_cost <= best + 1e-9
    for devs in (list(range(8)), [0, 1, 2, 3], [6, 7]):
        a = pdp.optimize_pipeline(pc, devs, pprof, pt)
        b = jdp.optimize_pipeline(jc, devs, jprof, jt)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.describe() == b.describe()
            assert a.device_ids == b.device_ids
            assert (a.cost, a.bottleneck) == (b.cost, b.bottleneck)
    # the greedy layout of a pool past the DP's state bound
    jh, ph = jcl.hetero_full_price(), pcl.hetero_full_price()
    jg, pg = _profiles("granite-8b")
    a = pdp.optimize_pipeline(ph, list(range(len(ph))), pg, pt)
    b = jdp.optimize_pipeline(jh, list(range(len(jh))), jg, jt)
    assert (a.describe(), a.device_ids, a.cost) \
        == (b.describe(), b.device_ids, b.cost)
    for L in (7, 80, 32):
        for S in (1, 2, 3, 5):
            assert pdp._even_split(L, S) == jdp._even_split(L, S)


@pytest.mark.parametrize("seed", range(4))
def test_kmeans_init_and_mutations_equal(seed):
    for pool in ("hetero_half_price", "hetero_full_price"):
        jr, pr = np.random.default_rng(seed), np.random.default_rng(seed)
        jseeds = jgen.kmeans_init(getattr(jcl, pool)(), jr)
        pseeds = pgen.kmeans_init(getattr(pcl, pool)(), pr)
        assert pseeds == jseeds
        n = len(getattr(pcl, pool)())
        for ind in pseeds:
            assert sorted(d for g in ind for d in g) == list(range(n))
        ji = pi = pseeds[0]
        for _ in range(5):
            ji, pi = jgen.mutate(ji, jr), pgen.mutate(pi, pr)
            assert pi == ji
            assert sorted(d for g in pi for d in g) == list(range(n))
            ji, pi = jgen.mutate_random(ji, jr), pgen.mutate_random(pi, pr)
            assert pi == ji


def test_slo_simulator_equal():
    for rate, seed in ((0.5, 0), (4.0, 3), (8.0, 7)):
        reps = [(1.0, 0.5, 0), (2.0, 1.0, 2), (0.7, 0.3, 1)]
        j = [jsim.ReplicaModel(*r) for r in reps]
        p = [psim.ReplicaModel(*r) for r in reps]
        for dl in (1.0, 2.5, 5.0):
            assert psim.simulate(p, rate, dl, duration=30, seed=seed) \
                == jsim.simulate(j, rate, dl, duration=30, seed=seed)
    phased = [(0.2, 0.2, 1.0, 0.5, 4), (3.0, 3.0, 1.0, 0.25, 64),
              (0.1, 0.1, 0.8, 0.8, 0)]
    jm = [jsim.PhasedReplicaModel(*m) for m in phased]
    pm = [psim.PhasedReplicaModel(*m) for m in phased]
    for roles in (["prefill", "decode", "decode"], ["both"] * 3,
                  ["decode", "prefill", "both"]):
        for kw in (dict(kv_bytes=1e6, link_bw=1e9), dict(link_lat=0.05),
                   dict(delay_fn=lambda i, j: 0.01 * (i + j + 1))):
            assert psim.simulate_disagg(pm, roles, 1.5, 4.0, duration=60.0,
                                        **kw) \
                == jsim.simulate_disagg(jm, roles, 1.5, 4.0, duration=60.0,
                                        **kw)
    # the role search, on test_disagg.py's heterogeneous pair
    got = pgen.best_role_split(pm[:2], rate=1.5, deadline=4.0,
                               duration=60.0, kv_bytes=1e6, link_bw=1e9)
    assert got == jgen.best_role_split(jm[:2], rate=1.5, deadline=4.0,
                                       duration=60.0, kv_bytes=1e6,
                                       link_bw=1e9)
    assert got[0] == ["prefill", "decode"]
    assert pgen.choose_spec_ks(pm, alpha=0.8, draft_step_cost=0.02, s_out=64) \
        == jgen.choose_spec_ks(jm, alpha=0.8, draft_step_cost=0.02,
                               s_out=64)
    reps = [(0.5, 0.25, 0)] * 2
    assert psim.peak_rate_for_attainment(
        [psim.ReplicaModel(*r) for r in reps], deadline=1.0, duration=30) \
        == jsim.peak_rate_for_attainment(
            [jsim.ReplicaModel(*r) for r in reps], deadline=1.0,
            duration=30)
    assert psim.min_deadline_for_attainment(
        [psim.ReplicaModel(*r) for r in reps], 2.0, duration=30) \
        == jsim.min_deadline_for_attainment(
            [jsim.ReplicaModel(*r) for r in reps], 2.0, duration=30)


def _both_schedules(cluster, iters, **extra):
    """One ServingConfig (the launcher's paged llama2-70b settings), both
    packages' schedules of the full 80-layer model on its pool."""
    sv = ServingConfig(**{**dict(
        arch="llama2-70b", cluster=cluster, cache_layout="paged",
        prompt_len=512, out_len=32, rate=2.0, duration=5.0, deadline=30.0,
        search_iters=iters), **extra})
    kw = sv.schedule_kwargs()
    task = sv.task()
    jpool = {"case_study": jcl.case_study_cluster,
             "half_price": jcl.hetero_half_price}[cluster]()
    want = jschedule(jpool, sv.arch, jcm.Task(**dataclasses.asdict(task)),
                     **kw)
    got = pschedule(sv.pool(), sv.arch, task, **kw)
    return got, want


def _assert_same_result(got, want):
    assert got.plan.describe() == want.plan.describe()
    assert got.assignment.describe() == want.assignment.describe()
    assert [p.device_ids for p in got.assignment.pipelines] \
        == [p.device_ids for p in want.assignment.pipelines]
    assert [(p.cost, p.bottleneck) for p in got.assignment.pipelines] \
        == [(p.cost, p.bottleneck) for p in want.assignment.pipelines]
    assert got.attainment == want.attainment
    assert got.evaluations == want.evaluations
    # per-iteration best scores; the wall times are left out
    assert [s for _, s in got.history] == [s for _, s in want.history]
    assert got.plan.dims == want.plan.dims
    for view in ("roles", "spec_ks", "kv_dtypes", "host_blocks"):
        assert getattr(got.plan, view) == getattr(want.plan, view), view


@pytest.mark.parametrize("cluster", ["case_study", "half_price"])
def test_schedule_equals_reference(cluster):
    got, want = _both_schedules(cluster, iters=4)
    _assert_same_result(got, want)
    got.plan.validate(80)
    assert len(got.history) == 5


ZOO = ("granite-20b", "codeqwen1.5-7b", "phi3.5-moe-42b-a6.6b",
       "granite-moe-3b-a800m", "xlstm-125m")


@pytest.mark.parametrize("arch", ZOO)
def test_schedule_equals_reference_on_the_zoo(arch):
    """The port's schedule looks the architecture up in the port's own
    registry (no config built from the reference's here) and returns the
    reference's plan, score and evaluation count."""
    from repro_torch.configs import get_config as port_config
    got, want = _both_schedules("case_study", iters=4, arch=arch)
    _assert_same_result(got, want)
    got.plan.validate(port_config(arch).num_layers)


@pytest.mark.parametrize("cluster,extra", [
    ("case_study", dict(spec_decode=True, spec_draft_cost=1e-4)),
    ("case_study", dict(kv_dtype="search", rate=40.0, deadline=10.0)),
    # two-replica individuals: every one is also scored role-split
    ("half_price", dict(disaggregate=True, kv_link_gbps=5.0)),
    ("case_study", dict(host_mem_gb=2.0, prefix_caching=True,
                        prefix_working_set=2048, host_swap_gbps=64.0,
                        cluster_prefix=True)),
], ids=["spec", "kv_dtype_search", "disaggregate", "host_tier"])
def test_schedule_search_dimensions_equal_reference(cluster, extra):
    got, want = _both_schedules(cluster, iters=3, **extra)
    _assert_same_result(got, want)
    dims = {"spec_decode": "spec", "kv_dtype": "kv_dtype",
            "host_mem_gb": "host_tier"}
    for flag, dim in dims.items():
        if flag in extra:
            assert dim in got.plan.dims
