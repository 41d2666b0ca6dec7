"""Warm re-solve on the paper pool in the port against the JAX package's,
on the CPU: tests/test_resched.py's two scheduler-level cases (and their
``slow`` marks). The reference's ``genetic.search`` plans the incumbent
(tests/test_torch_scheduler.py holds the port's search to it), which both
packages' ``core.resched.warm_resolve`` then re-solve with the same seeds:
the port must return the reference's re-solved plan, attainment,
evaluations and device remap, and hold the reference test's own
assertions."""
import dataclasses

import numpy as np
import pytest

from repro.configs import get_config
from repro.core import cluster as jcl
from repro.core import cost_model as jcm
from repro.core import genetic as jgen
from repro.core import resched as jrs
from repro.core import slo_sim as jslo
from repro_torch.configs import get_config as port_config
from repro_torch.core import cluster as pcl
from repro_torch.core import cost_model as pcm
from repro_torch.core import plan as pplan
from repro_torch.core import resched as prs
from repro_torch.core import slo_sim as pslo


class _Pkg:
    def __init__(self, **kw):
        self.__dict__.update(kw)


J = _Pkg(cl=jcl, cm=jcm, rs=jrs, slo=jslo, config=get_config)
P = _Pkg(cl=pcl, cm=pcm, rs=prs, slo=pslo, config=port_config)


def _llama(pkg):
    return pkg.cm.ModelProfile.from_config(pkg.config("llama2-70b"),
                                           paper_exact=True)


def _replica_models(pkg, pool, asg, prof, task):
    out = []
    for pipe in asg.pipelines:
        pc = pkg.cm.pipeline_phase_costs(
            pool, [s.device_ids for s in pipe.stages], pipe.layer_split,
            prof, task)
        out.append(pkg.slo.PhasedReplicaModel(
            prefill_latency=pc.prefill_latency,
            prefill_bottleneck=pc.prefill_bottleneck,
            decode_latency=pc.decode_latency,
            decode_bottleneck=pc.decode_bottleneck).colocated())
    return out


def _port_plan(plan):
    """The reference's DeploymentPlan as the port's."""
    def pipe(pp):
        return pplan.PipelinePlan([pplan.StagePlan(list(st.device_ids),
                                                   st.num_layers)
                                   for st in pp.stages],
                                  cost=pp.cost, bottleneck=pp.bottleneck)
    return pplan.DeploymentPlan(
        replicas=[pplan.ReplicaSpec(pipeline=pipe(r.pipeline),
                                    **{f.name: getattr(r, f.name)
                                       for f in dataclasses.fields(r)
                                       if f.name != "pipeline"})
                  for r in plan.replicas], dims=plan.dims)


def _summary(res):
    return (res.plan.describe(), res.attainment, res.evaluations,
            [p.describe() for p in res.assignment.pipelines])


def _resolve_both(search, resolve):
    """The reference's incumbent = search(); resolve(pkg, incumbent) ->
    (re-solved, extra) on both packages, the port's equal to the
    reference's. Returns (incumbent, the port's re-solved, its extra)."""
    res = search()
    want = resolve(J, res.plan)
    got = resolve(P, _port_plan(res.plan))
    assert _summary(got[0]) == _summary(want[0])
    assert got[1] == want[1]
    return res, got[0], got[1]


@pytest.mark.slow
def test_warm_resolve_excludes_dead_devices():
    dead = list(range(4))

    def search():
        return jgen.search(jcl.hetero_half_price(), _llama(J),
                           jcm.Task(batch=1, s_in=128, s_out=32),
                           deadline=10.0, rate=3.0, iters=6, seed=0)

    def resolve(pkg, incumbent):
        return pkg.rs.warm_resolve(
            pkg.cl.hetero_half_price(), _llama(pkg),
            pkg.cm.Task(batch=1, s_in=128, s_out=32), incumbent=incumbent,
            deadline=10.0, rate=3.0, dead_devices=dead, iters=4, seed=1)

    res, res2, remap = _resolve_both(search, resolve)
    pool = pcl.hetero_half_price()
    assert res2.attainment > 0.0
    assert set(remap) == {d.id for d in pool.devices} - set(dead)
    used = {d for p in res2.assignment.pipelines for d in p.device_ids}
    assert used <= set(range(len(pool.devices) - len(dead)))
    res2.plan.validate(_llama(P).num_layers)


@pytest.mark.slow
def test_spike_resolve_strictly_improves_attainment():
    """An incumbent solved for 1.5 req/s with SLO headroom, hit by a
    sustained spike: re-solving AT the observed rate strictly beats the
    incumbent's simulated attainment under that rate, in both packages,
    with the same numbers."""
    deadline, obs = 30.0, 6.0

    def search():
        return jgen.search(jcl.hetero_half_price(), _llama(J),
                           jcm.Task(batch=1, s_in=128, s_out=32),
                           deadline=deadline, rate=1.5, iters=15, seed=0)

    def resolve(pkg, incumbent):
        pool = pkg.cl.hetero_half_price()
        task = pkg.cm.Task(batch=1, s_in=128, s_out=32)
        res2, _ = pkg.rs.warm_resolve(pool, _llama(pkg), task,
                                      incumbent=incumbent,
                                      deadline=deadline, rate=obs, iters=8,
                                      seed=1)
        atts = [pkg.slo.simulate(
            _replica_models(pkg, pool, a, _llama(pkg), task), obs, deadline)
            for a in (incumbent.assignment, res2.assignment)]
        return res2, tuple(atts)

    res, res2, (att_inc, att_new) = _resolve_both(search, resolve)
    assert np.isfinite(att_new) and att_new > att_inc, (att_new, att_inc)
    assert res2.assignment.num_replicas >= res.assignment.num_replicas
