"""Online rescheduling in the port (repro_torch.core.resched,
repro_torch.serving.resched) against the JAX package's, on the CPU.
Mirrors tests/test_resched.py case for case: each unit case calls both
packages' functions on the same inputs and requires equal outputs (and the
reference test's own assertions on the port's); the two warm re-solves on
the paper pool keep the reference's ``slow`` marks and live in
tests/test_torch_resolve.py. Then the engine-level chaos cases of
tests/test_resched.py and scripts/smoke_serving.py's ``chaos`` suite on
the same bridged granite-8b (reduced, fp32) weights, paged, KVSAN on: a
kill of replica 1 mid-prefill, a kill mid-decode and a live role re-split
mid-decode give the JAX engine's token streams, every ServeStats field and
the controller's events, on model-precision pools and on int8 pools; and
tests/test_obs.py's model-error cases of the drift detector."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config
from repro.core import cluster as jcl
from repro.core import resched as jrs
from repro.core.plan import Assignment, DeploymentPlan, PipelinePlan, \
    StagePlan
from repro.core.slo_sim import PhasedReplicaModel as JPhased
from repro.models import model as JM
from repro.obs import calibration as jcal
from repro.serving import request as jreq
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving.loop import VirtualClock as JClock
from repro.serving.resched import OnlineRescheduler as JCtl
from repro_torch import bridge
from repro_torch.configs import get_config as port_config
from repro_torch.core import cluster as pcl
from repro_torch.core import plan as pplan
from repro_torch.core import resched as prs
from repro_torch.core.slo_sim import PhasedReplicaModel as PPhased
from repro_torch.obs import calibration as pcal
from repro_torch.serving import loop as ploop
from repro_torch.serving import request as preq
from repro_torch.serving.engine import InferenceEngine as PEngine
from repro_torch.serving.resched import OnlineRescheduler as PCtl
from repro_torch.serving.resched import evacuate_worker

PKGS = ((jrs, JPhased), (prs, PPhased))
JPLAN = types.SimpleNamespace(Assignment=Assignment, PipelinePlan=PipelinePlan,
                              StagePlan=StagePlan)


# ---------------------------------------------------------------------------
# DriftDetector
# ---------------------------------------------------------------------------

def _feed(det, n, dt, plen=0, t0=0.0):
    t = t0
    for _ in range(n):
        det.observe_admit(t, plen)
        t += dt
    return t - dt


def _sig(sig):
    return None if sig is None else dataclasses.asdict(sig)


def _both_detectors(drive, **kw):
    """drive(rs, det) on a fresh reference and port detector; returns
    (reference result, port result)."""
    out = [drive(rs, rs.DriftDetector(**kw)) for rs, _ in PKGS]
    return out[0], out[1]


def test_rate_spike_fires_and_reanchors():
    def drive(rs, det):
        t = _feed(det, 10, 0.1)              # ~10 req/s vs planned 1.0
        sig = det.poll(t)
        assert sig is not None and sig.kind == "rate_spike"
        assert sig.factor >= det.rate_threshold
        assert sig.observed_rate == pytest.approx(det.planned_rate)
        return _sig(sig), _sig(det.poll(t)), det.planned_rate
    want, got = _both_detectors(drive, rate=1.0)
    assert got == want and got[1] is None     # re-anchored: fires once


def test_rate_drop_fires():
    def drive(rs, det):
        sig = det.poll(_feed(det, 8, 1.0))   # ~1.1 req/s vs planned 10
        assert sig is not None and sig.kind == "rate_spike"
        assert sig.factor <= 1.0 / det.rate_threshold
        return _sig(sig)
    want, got = _both_detectors(drive, rate=10.0, window=20.0)
    assert got == want


def test_needs_min_events():
    def drive(rs, det):
        return _sig(det.poll(_feed(det, 7, 0.1)))
    want, got = _both_detectors(drive, rate=1.0, min_events=8)
    assert got == want is None


def test_mix_shift_fires_on_prompt_len_only():
    def drive(rs, det):
        t = _feed(det, 8, 1.0, plen=250)     # rate on-plan, prompts 2.5x
        sig = det.poll(t)
        assert sig is not None and sig.kind == "mix_shift"
        assert sig.factor == pytest.approx(2.5)
        assert sig.observed_prompt_len == pytest.approx(250.0)
        t = _feed(det, 8, 1.0, plen=250, t0=t + 1.0)
        return _sig(sig), _sig(det.poll(t))
    want, got = _both_detectors(drive, rate=1.0, prompt_len=100.0,
                                window=20.0)
    assert got == want and got[1] is None     # re-anchored at 250


def test_mix_detection_off_without_baseline():
    def drive(rs, det):
        return _sig(det.poll(_feed(det, 8, 1.0, plen=4096)))
    want, got = _both_detectors(drive, rate=1.0, window=20.0)
    assert got == want is None


def test_death_preempts_statistics():
    def drive(rs, det):
        t = _feed(det, 10, 0.1)              # a rate spike is also pending
        det.observe_death(frozenset({4, 5}))
        sig = det.poll(t)
        assert sig.kind == "replica_death" \
            and sig.dead == (frozenset({4, 5}),)
        sig2 = det.poll(t)                   # then the spike surfaces
        assert sig2 is not None and sig2.kind == "rate_spike"
        return _sig(sig), _sig(sig2), sig.describe(), sig2.describe()
    want, got = _both_detectors(drive, rate=1.0)
    assert got == want


def test_acceptance_drift():
    def drive(rs, det):
        t = _feed(det, 4, 1.0)               # on-plan rate, above the floor
        det.observe_spec(proposed=10, accepted=2)
        sig = det.poll(t)
        assert sig is not None and sig.kind == "acceptance_drift"
        assert sig.observed_alpha == pytest.approx(0.2)
        assert det.planned_alpha == pytest.approx(0.2)   # re-anchored
        det.observe_spec(proposed=10, accepted=2)
        return _sig(sig), _sig(det.poll(t))
    want, got = _both_detectors(drive, rate=1.0, spec_alpha=0.8,
                                min_events=4, window=20.0)
    assert got == want and got[1] is None


def test_window_trims_old_admits():
    def drive(rs, det):
        _feed(det, 20, 0.1)                  # burst at t ~ [0, 2)
        return det.window_rate(100.0), _sig(det.poll(100.0))
    want, got = _both_detectors(drive, rate=1.0, window=5.0)
    assert got == want == (0.0, None)        # long quiet: window empty


# tests/test_obs.py's model-error cases, on the port's detector
def test_drift_detector_model_error_fires_and_reanchors():
    def drive(rs, det):
        det.observe_model_error("decode", 1.0, 1.2)      # 20% — in band
        first = _sig(det.poll(0.0))
        det.observe_model_error("decode", 1.0, 3.0)      # blows the band
        sig = det.poll(1.0)
        assert sig is not None and sig.kind == "model_error"
        assert sig.phase == "decode" and sig.factor > 1.5
        assert "model_error" in sig.describe()
        return first, _sig(sig), sig.describe(), _sig(det.poll(2.0))
    want, got = _both_detectors(drive, rate=1.0, model_error_threshold=0.5,
                                model_error_min=1)
    assert got == want and got[0] is None and got[3] is None


def test_model_error_is_lowest_priority():
    def drive(rs, det):
        det.observe_model_error("prefill", 1.0, 9.0)
        det.observe_death(frozenset({0}))
        return det.poll(0.0).kind, det.poll(0.0).kind
    want, got = _both_detectors(drive, rate=1.0, model_error_threshold=0.1,
                                model_error_min=1)
    assert got == want == ("replica_death", "model_error")


@pytest.mark.parametrize("cal_mod", [jcal, pcal], ids=["ref_cal", "port_cal"])
def test_calibrator_feed_reaches_detector(cal_mod):
    # either package's calibrator drives the port's detector as it drives
    # the reference's
    def drive(rs, det):
        cal = cal_mod.CostCalibrator()
        cal.predict(0, "decode", 1.0)
        cal.observe(0, "decode", 2.0)
        cal.observe(0, "prefill", 1.0)               # no prediction: not fed
        return cal.feed(det), _sig(det.poll(0.0))
    want, got = _both_detectors(drive, rate=1.0, model_error_threshold=0.5,
                                model_error_min=1)
    assert got == want and got[0] == 1 and got[1]["kind"] == "model_error"


# ---------------------------------------------------------------------------
# Max-flow over the phase-rate graph
# ---------------------------------------------------------------------------

def test_max_flow_known_graph():
    # s=0, a=1, b=2, t=3:  s->a 3, s->b 2, a->t 2, b->t 3, a->b 1
    cap = np.zeros((4, 4))
    cap[0, 1], cap[0, 2] = 3, 2
    cap[1, 3], cap[2, 3] = 2, 3
    cap[1, 2] = 1
    got = prs.max_flow(cap, 0, 3)
    assert got == jrs.max_flow(cap, 0, 3) == pytest.approx(5.0)


def test_max_flow_disconnected_is_zero():
    assert prs.max_flow(np.zeros((3, 3)), 0, 2) \
        == jrs.max_flow(np.zeros((3, 3)), 0, 2) == 0.0


@pytest.mark.parametrize("args,want", [
    (([2.0], [3.0]), 2.0), (([2.0, 2.0], [1.0, 1.0]), 2.0),
    (([], [1.0]), 0.0), (([5.0], [5.0], np.array([[1.5]])), 1.5)])
def test_flow_serve_rate(args, want):
    got = prs.flow_serve_rate(*args)
    assert got == jrs.flow_serve_rate(*args) == pytest.approx(want)


def _phased(mod, pre, dec):
    return mod(prefill_latency=pre, prefill_bottleneck=pre,
               decode_latency=dec, decode_bottleneck=dec)


def _split_both(pairs, **kw):
    return [rs.flow_role_split([_phased(ph, *p) for p in pairs], **kw)
            for rs, ph in PKGS]


def test_role_split_complementary_pair():
    # A prefills 10x faster, B decodes 10x faster: the split pushes the
    # flow to 10 req/s where colocation manages ~1.8
    want, got = _split_both([(0.1, 1.0), (1.0, 0.1)])
    assert got == want
    assert got[0] == ["prefill", "decode"] and got[1] == pytest.approx(10.0)
    assert got[1] > prs.colocated_serve_rate(
        [_phased(PPhased, 0.1, 1.0), _phased(PPhased, 1.0, 0.1)])


def test_role_split_identical_pair_stays_colocated():
    want, got = _split_both([(1.0, 1.0), (1.0, 1.0)])
    a = _phased(PPhased, 1.0, 1.0)
    assert got == want and got[0] is None
    assert got[1] == pytest.approx(prs.colocated_serve_rate([a, a]))


def test_role_split_single_replica_colocated():
    want, got = _split_both([(0.1, 1.0)])
    assert got == want and got[0] is None and got[1] > 0.0


def test_role_split_prices_the_wire():
    # an infinitely slow handoff wire makes every split worthless
    want, got = _split_both([(0.1, 1.0), (1.0, 0.1)], kv_bytes=1e12,
                            link_bw=1.0)
    assert got == want and got[0] is None
    assert got[1] == pytest.approx(prs.colocated_serve_rate(
        [_phased(PPhased, 0.1, 1.0), _phased(PPhased, 1.0, 0.1)]))


def test_phase_rates_equal():
    pairs = [(0.1, 1.0), (0.3, 0.2), (2.0, 0.05)]
    assert prs.phase_rates([_phased(PPhased, *p) for p in pairs]) \
        == jrs.phase_rates([_phased(JPhased, *p) for p in pairs])


# ---------------------------------------------------------------------------
# repair_plan / drop_devices / warm_seed
# ---------------------------------------------------------------------------

def _plans(groups, roles=None):
    """The same plan in both packages: (reference, port)."""
    jasg = Assignment([PipelinePlan([StagePlan(list(g), 4)], cost=0.1,
                                    bottleneck=0.1) for g in groups])
    pasg = pplan.Assignment([pplan.PipelinePlan(
        [pplan.StagePlan(list(g), 4)], cost=0.1, bottleneck=0.1)
        for g in groups])
    return (DeploymentPlan.from_search(jasg, roles=roles),
            pplan.DeploymentPlan.from_search(pasg, roles=roles))


def _reps(plan):
    return [(tuple(sorted(r.key)), r.role, r.spec_k, r.kv_dtype,
             r.host_blocks) for r in plan.replicas], plan.dims


def test_repair_drops_dead_and_colocates():
    jp, pp = _plans([[0, 1], [2, 3], [4, 5]],
                    roles=["prefill", "decode", "decode"])
    out = prs.repair_plan(pp, [frozenset({2, 3})])
    assert _reps(out) == _reps(jrs.repair_plan(jp, [frozenset({2, 3})]))
    assert {tuple(sorted(r.key)) for r in out.replicas} == \
        {(0, 1), (4, 5)}
    # no models given: every survivor falls back to end-to-end serving
    assert [r.role for r in out.replicas] == ["both", "both"]
    assert out.dims == pp.dims


def test_repair_resplits_by_flow():
    jp, pp = _plans([[0], [1], [2]], roles=["prefill", "prefill", "decode"])
    got = prs.repair_plan(pp, [frozenset({2})],
                          models=[_phased(PPhased, 0.1, 1.0),
                                  _phased(PPhased, 1.0, 0.1)])
    want = jrs.repair_plan(jp, [frozenset({2})],
                           models=[_phased(JPhased, 0.1, 1.0),
                                   _phased(JPhased, 1.0, 0.1)])
    assert _reps(got) == _reps(want)
    assert [r.role for r in got.replicas] == ["prefill", "decode"]


def test_repair_without_roles_dim_keeps_specs():
    jp, pp = _plans([[0, 1], [2, 3]])        # dims == frozenset()
    out = prs.repair_plan(pp, [frozenset({0, 1})])
    assert _reps(out) == _reps(jrs.repair_plan(jp, [frozenset({0, 1})]))
    assert len(out.replicas) == 1 and out.replicas[0].role == "both"
    assert out.dims == frozenset()


def test_drop_devices_renumbers_contiguously():
    jpool, ppool = jcl.case_study_cluster(), pcl.case_study_cluster()
    n = len(ppool.devices)
    pool2, remap = prs.drop_devices(ppool, [0, 3])
    jpool2, jremap = jrs.drop_devices(jpool, [0, 3])
    assert remap == jremap
    assert [(d.id, d.type, d.machine, d.region)
            for d in pool2.devices] == \
        [(d.id, d.type, d.machine, d.region) for d in jpool2.devices]
    np.testing.assert_array_equal(pool2.lat, jpool2.lat)
    np.testing.assert_array_equal(pool2.bw, jpool2.bw)
    assert len(pool2.devices) == n - 2
    assert [d.id for d in pool2.devices] == list(range(n - 2))
    assert sorted(remap) == [d for d in range(n) if d not in (0, 3)]
    assert sorted(remap.values()) == list(range(n - 2))
    assert pool2.lat.shape == pool2.bw.shape == (n - 2, n - 2)
    # surviving pairwise bandwidth is preserved under the renumbering
    old, new = sorted(remap)[:2], [remap[k] for k in sorted(remap)[:2]]
    assert pool2.bw[new[0], new[1]] == ppool.bw[old[0], old[1]]


@pytest.mark.parametrize("remap,size,want", [
    # device 2 died; the pool grew to 5
    ({0: 0, 1: 1, 3: 2}, 5,
     (frozenset({0, 1}), frozenset({2}), frozenset({3, 4}))),
    # a replica died whole
    ({0: 0, 1: 1}, 2, (frozenset({0, 1}),))])
def test_warm_seed(remap, size, want):
    jp, pp = _plans([[0, 1], [2, 3]])
    got = prs.warm_seed(pp, remap, pool_size=size)
    assert got == jrs.warm_seed(jp, remap, pool_size=size) == want


# ---------------------------------------------------------------------------
# The controller's replica port and generic evacuation
# ---------------------------------------------------------------------------

class _Analytic:
    """A worker without ``evacuate``: drained through its queues."""

    def __init__(self, reqs):
        self._queue = list(reqs[:2])
        self._events = [(1.0, 0, reqs[2])]


def test_evacuate_worker_drains_queues_and_heaps():
    reqs = [preq.Request(rid=i, prompt=np.arange(3, dtype=np.int32),
                         max_new_tokens=2, arrival=0.0) for i in range(3)]
    w = _Analytic(reqs)
    assert [r.rid for r in evacuate_worker(w, 0.0)] == [0, 1, 2]
    assert not w._queue and not w._events


def test_controller_is_never_a_dispatch_candidate():
    ctl = PCtl(kills=[(2.0, 1), (0.5, 0)])
    assert ctl.capacity(0.0) == 0 and ctl.load(0.0) == float("inf")
    assert ctl.next_event(0.0) == 0.5 and ctl.next_event(1.0) == 2.0
    with pytest.raises(AssertionError):
        ctl.admit([], 0.0)
    with pytest.raises(RuntimeError):
        ctl.replace_workers([], 0.0)


# ---------------------------------------------------------------------------
# Engine-level chaos: a kill is token-invisible, a live move resumes
# ---------------------------------------------------------------------------

BLOCK = 8


def _asg(mod, L):
    # two replicas with different stage splits (the disagg topology):
    # chaos must survive layer regrouping between source and survivors
    return mod.Assignment([
        mod.PipelinePlan([mod.StagePlan([0], 1), mod.StagePlan([1], L - 1)],
                         cost=0.1, bottleneck=0.1),
        mod.PipelinePlan([mod.StagePlan([2], L - 1), mod.StagePlan([3], 1)],
                         cost=0.1, bottleneck=0.1)])


def _wl(mod, vocab, out_len):
    return mod.synth_workload(rate=10.0, duration=1.0, vocab=vocab,
                              prompt_len=10, prompt_jitter=5,
                              out_len=out_len, seed=2)


def _resplit_controller(rs, Ctl):
    fired = []

    def resolver(sig, c, now):
        if fired:
            return None
        fired.append(sig.kind)
        return {"roles": ["prefill", "decode"]}
    return Ctl(detector=rs.DriftDetector(rate=1.0, min_events=4, window=5.0),
               resolver=resolver)


# scenario -> (out_len, controller factory(resched module, controller class))
SCENARIOS = {
    # t=0.2: replica 1 dies while its first admissions still prefill — the
    # re-dispatch is a cold re-prefill on the survivor
    "kill_mid_prefill": (4, lambda rs, C: C(kills=[(0.2, 1)])),
    # t=2.0: replica 1 dies holding decoding slots with emitted tokens
    "kill_mid_decode": (4, lambda rs, C: C(kills=[(2.0, 1)])),
    # a rate spike re-splits the colocated pair live: replica 0's decoding
    # slots move to replica 1 with their pages and emitted tokens
    "live_resplit": (6, _resplit_controller),
}
POOLS = (None, "int8")


def _outputs(reqs):
    return [list(r.output) for r in reqs]


@pytest.fixture(scope="module")
def chaos():
    """Every scenario on every pool through both engines (the JAX engine
    once per scenario, the port also cold), on the same bridged weights:
    {(pool, scenario): {"ref": (outputs, stats, events, redispatches),
    "port": ..., "cold": port outputs without a controller}}."""
    cfg = get_config("granite-8b").reduced()
    tree = jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(0)))
    jparams = jax.tree.map(jnp.asarray, tree)
    pcfg = port_config("granite-8b").reduced()
    pparams = bridge.params_from_numpy(tree, device="cpu")
    L = cfg.num_layers
    kw = dict(policy="continuous", n_slots=4, max_len=48,
              cache_layout="paged", block_size=BLOCK, kvsan=True)

    def serve(pkg, pool, out_len, make_ctl):
        if pkg == "ref":
            eng = JEngine(cfg, _asg(JPLAN, L), params=jparams,
                          kv_dtype=pool, **kw)
            reqs, rs, Ctl, clock = _wl(jreq, cfg.vocab_size, out_len), \
                jrs, JCtl, JClock()
        else:
            eng = PEngine(pcfg, _asg(pplan, L), params=pparams,
                          device="cpu", kv_dtype=pool, **kw)
            reqs, rs, Ctl, clock = _wl(preq, pcfg.vocab_size, out_len), \
                prs, PCtl, ploop.VirtualClock()
        ctl = None
        if make_ctl is not None:
            ctl = make_ctl(rs, Ctl)
            eng.router.attach_controller(ctl)
        stats = eng.serve(reqs, deadline=1e9, clock=clock)
        return (_outputs(reqs), stats,
                None if ctl is None else ctl.events,
                None if ctl is None else ctl.redispatches)

    out = {}
    for pool in POOLS:
        colds = {n: serve("port", pool, n, None)
                 for n in {v[0] for v in SCENARIOS.values()}}
        for name, (out_len, make_ctl) in SCENARIOS.items():
            out[pool, name] = {"ref": serve("ref", pool, out_len, make_ctl),
                               "port": serve("port", pool, out_len,
                                             make_ctl),
                               "cold": colds[out_len]}
    return out


@pytest.mark.parametrize("pool", POOLS, ids=["model_pools", "int8_pools"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_chaos_equals_the_reference_engine(chaos, pool, name):
    r = chaos[pool, name]
    jout, jstats, jev, jred = r["ref"]
    pout, pstats, pev, pred = r["port"]
    cout, cstats = r["cold"][:2]
    # the reference's own contract, held by both engines: no request
    # dropped, no page leaked, the streams of a serve without a controller
    assert pout == jout == cout
    assert all(len(o) == SCENARIOS[name][0] for o in pout)
    for f in dataclasses.fields(ploop.ServeStats):
        assert getattr(pstats, f.name) == getattr(jstats, f.name), f.name
    assert pstats.dropped == 0 and pstats.kvsan_leaks == 0
    assert cstats.kvsan_leaks == 0
    assert pev == jev and pred == jred
    kinds = [e["kind"] for e in pev]
    if name.startswith("kill"):
        kill = next(e for e in pev if e["kind"] == "kill")
        assert pred == kill["orphans"]
        if name == "kill_mid_decode":
            assert kill["orphans"] > 0 and pred > 0
    else:
        roles = next(e for e in pev if e["kind"] == "roles")
        assert roles["moved"] > 0 and "signal" in kinds
        assert pstats.migrations > 0 and pstats.migrated_kv_bytes > 0


def test_int8_live_moves_ship_one_byte_pages_with_scales(chaos):
    # the live moves of the int8 re-split carry one-byte payloads plus
    # float32 scales: fewer bytes than the model-precision pools' moves
    fp = chaos[None, "live_resplit"]["port"][1]
    q8 = chaos["int8", "live_resplit"]["port"][1]
    assert q8.migrations == fp.migrations > 0
    assert 0 < q8.migrated_kv_bytes < fp.migrated_kv_bytes
