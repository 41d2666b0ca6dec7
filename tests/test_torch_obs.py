"""The port's observability (repro_torch.obs) against the JAX package's
(repro.obs), on the CPU (mirrors tests/test_obs.py; its drift-detector
cases run on both packages' detectors in tests/test_torch_resched.py):

  * the Tracer, the MetricsRegistry, ServeStats.merge / publish /
    from_metrics and the CostCalibrator give the reference's events, rows
    and reports for the same calls;
  * tracing is pure observation: mixed prefix / chunked / speculative /
    preempting traffic, with KVSAN on and off, and a disaggregated serve
    give the untraced serve's tokens, and the port's trace and metrics of
    a serve equal the reference's for the same serve on the same bridged
    granite-8b (reduced, fp32) weights on a VirtualClock: the same events,
    ts, dur and args, the same registry rows;
  * the report CLI passes the port's artifacts and fails malformed ones,
    printing the reference's lines, and ``calibration_table`` prints the
    reference's table;
  * ``launch.serve.main(argv, device="cpu")`` with every observability and
    multi-replica flag prints the reference launcher's lines.
"""
import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config
from repro.core import cost_model as jcm
from repro.core import plan as jplan
from repro.launch import serve as jserve
from repro.models import model as JM
from repro.obs import calibration as jcal
from repro.obs import metrics as jmet
from repro.obs import report as jrep
from repro.obs import trace as jtr
from repro.serving import continuous as jcont
from repro.serving import disagg as jdis
from repro.serving import loop as jloop
from repro.serving import request as jreq
from repro.serving import router as jrouter
from repro.serving.pipeline import AsymmetricPipeline as JPipe
from repro.serving.spec import SpecConfig as JSpec
from repro_torch import bridge
from repro_torch.configs import get_config as port_config
from repro_torch.core import cost_model as pcm
from repro_torch.core import plan as pplan
from repro_torch.core.resched import DriftDetector
from repro_torch.launch import serve as pserve
from repro_torch.obs import calibration as pcal
from repro_torch.obs import metrics as pmet
from repro_torch.obs import report as prep
from repro_torch.obs import trace as ptr
from repro_torch.serving import continuous as pcont
from repro_torch.serving import disagg as pdis
from repro_torch.serving import loop as ploop
from repro_torch.serving import request as preq
from repro_torch.serving import router as prouter
from repro_torch.serving.pipeline import AsymmetricPipeline as PPipe
from repro_torch.serving.spec import SpecConfig as PSpec


class _Pkg:
    """One package's modules, by role."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


J = _Pkg(tr=jtr, met=jmet, cal=jcal, rep=jrep, cm=jcm, cont=jcont,
         dis=jdis, loop=jloop, req=jreq, Spec=JSpec, plan=jplan,
         router=jrouter, serve=jserve)
P = _Pkg(tr=ptr, met=pmet, cal=pcal, rep=prep, cm=pcm, cont=pcont,
         dis=pdis, loop=ploop, req=preq, Spec=PSpec, plan=pplan,
         router=prouter, serve=pserve)


def _events(tracer):
    """The trace as the reference would export it: everything but the
    producer's module name."""
    obj = tracer.to_chrome()
    obj["otherData"].pop("producer")
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


# ---------------------------------------------------------------------------
# Tracer, registry, ServeStats and calibrator: the reference's results
# ---------------------------------------------------------------------------

def _tracer_unit(mod):
    clk = mod.loop.VirtualClock()
    tr = mod.tr.Tracer(clk)
    tr.complete("decode", 0.5, ts=1.0, pid=2, tid=1, tokens=3)
    tr.instant("preempt", ts=1.5, pid=2, rid=7)
    clk.sleep_until(2.0)
    with tr.span("iteration", pid=2):
        clk.tick(0.25)
    sp = tr.begin("serve")  # repro: noqa[span-pairing] (deliberate leak)
    open_errs = mod.tr.validate_chrome_trace(tr.to_chrome())
    tr.end(sp, requests=4)
    tr.mark(1, "first_token", 2.0)
    tr.mark(1, "first_token", 5.0)          # first occurrence wins
    return (_events(tr), open_errs, tr.request_marks,
            mod.tr.validate_chrome_trace(tr.to_chrome()),
            mod.tr.validate_chrome_trace(tr.to_chrome(),
                                         require_spans=["prefill"]))


def test_tracer_equals_reference():
    got, want = _tracer_unit(P), _tracer_unit(J)
    assert got == want
    events, open_errs, marks, ok, missing = got
    assert any("never ended" in e for e in open_errs)
    assert ok == [] and missing and marks == {1: {"first_token": 2.0}}
    assert json.loads(events)["traceEvents"][0]["ts"] == 1_000_000
    assert ptr.SPAN_NAMES == jtr.SPAN_NAMES
    for bad in ([], {"traceEvents": [{"ph": "X"}]},
                {"traceEvents": [{"name": "x", "ph": "Z", "ts": 0, "pid": 0,
                                  "tid": 0}]}):
        assert ptr.validate_chrome_trace(bad) \
            == jtr.validate_chrome_trace(bad) != []


def test_null_tracer_is_inert():
    assert ptr.NULL_TRACER.enabled is False
    ptr.NULL_TRACER.complete("decode", 1.0)
    ptr.NULL_TRACER.instant("preempt")
    sp = ptr.NULL_TRACER.begin("serve")
    ptr.NULL_TRACER.end(sp)
    ptr.NULL_TRACER.mark(1, "first_token", 0.5)
    assert ptr.NULL_TRACER.events == [] and ptr.NULL_TRACER.request_marks == {}


def _registry(mod, tmp_path):
    reg = mod.met.MetricsRegistry()
    reg.counter("served", replica=0).inc(3)
    reg.counter("served", replica=1).inc()
    reg.gauge("occupancy", stage=0).set(5)
    reg.gauge("occupancy", stage=0).set(2)
    h = reg.histogram("lat")
    for v in (0.01, 0.2, 3.0, 99.0):
        h.observe(v)
    edge = mod.met.Histogram(buckets=(1.0, 2.0))
    for v in (0.5, 1.0, 1.5, 99.0):
        edge.observe(v)
    p = tmp_path / f"{id(mod)}.jsonl"
    reg.to_jsonl(str(p))
    back = mod.met.MetricsRegistry.from_jsonl(str(p))
    return (reg.collect(), back.collect(), p.read_text(),
            reg.value("served", replica=0), reg.value("served", replica=9),
            reg.total("served"), h.mean, h.quantile(0.5), edge.counts,
            edge.quantile(1.0))


def test_registry_equals_reference(tmp_path):
    got, want = _registry(P, tmp_path), _registry(J, tmp_path)
    assert got == want
    assert got[0] == got[1]                   # the JSONL round trip
    assert got[8] == [2, 1, 1]


def _stats(mod, n, lats, att, thpt, **kw):
    s = mod.loop.ServeStats(latencies=list(lats), attainment=att,
                            throughput=thpt, n_requests=n)
    for k, v in kw.items():
        setattr(s, k, v)
    return s


def _merge_publish(mod):
    out = [dataclasses.asdict(mod.loop.ServeStats.merge([]))]
    a = _stats(mod, 8, [1.0], 1.0, 2.0, prefix_hits=3, iterations=10,
               migrations=2, host_promotions=4, kvsan_leaks=1)
    b = _stats(mod, 2, [5.0, 6.0], 0.0, 1.0, prefix_hits=1, iterations=4,
               prefix_fetched_bytes=512)
    z = _stats(mod, 0, [], 1.0, 0.0)
    for parts in ([a], [a, b], [z, z], [z, _stats(mod, 4, [1.0], 0.25, 1.0)]):
        out.append(dataclasses.asdict(mod.loop.ServeStats.merge(parts)))
    reg = mod.met.MetricsRegistry()
    s = _stats(mod, 5, [0.02, 0.3], 0.8, 2.5, preemptions=3, spec_steps=7,
               migrations=1, migrated_kv_bytes=4096, host_demotions=2)
    s.queue_delays = [0.004, 0.04]
    s.publish(reg, replica=1)
    out.append(reg.collect())
    out.append(dataclasses.asdict(mod.loop.ServeStats.from_metrics(
        reg, replica=1)))
    out.append(s.summary())
    return out


def test_serve_stats_merge_publish_from_metrics_equal_reference():
    got, want = _merge_publish(P), _merge_publish(J)
    assert got == want
    merged = got[2]
    assert merged["attainment"] == pytest.approx(0.8)
    assert merged["migrations"] == 2 and merged["prefix_fetched_bytes"] == 512
    back = got[-2]
    assert back["preemptions"] == 3 and back["migrated_kv_bytes"] == 4096
    assert len(back["latencies"]) == 2 and back["attainment"] == 0.8
    assert "mig=" in got[-1] and "host=" in got[-1]
    assert [f.name for f in dataclasses.fields(ploop.ServeStats)] \
        == [f.name for f in dataclasses.fields(jloop.ServeStats)]


def _calibration(mod):
    cal = mod.cal.CostCalibrator()
    cal.predict(0, "decode", 1.0)
    cal.observe(0, "decode", 1.5)
    cal.observe(0, "decode", 0.9)
    cal.observe(1, "prefill", 6.0, units=12)
    pc = mod.cm.PhaseCosts(prefill_latency=2.0, prefill_bottleneck=1.5,
                           decode_latency=0.25, decode_bottleneck=0.2)
    mod.cal.predictions_from_phase_costs(cal, 3, pc, s_in=8)
    cal.observe(3, "prefill", 1.0, units=4)
    cal.observe(3, "decode", 0.5)
    tr = mod.tr.Tracer(mod.loop.VirtualClock())
    tr.complete("prefill", 4.0, ts=0.0, pid=0, tokens=8)
    tr.complete("decode", 1.0, ts=1.0, pid=0, tokens=3)
    tr.complete("iteration", 9.0, ts=1.0, pid=0)
    a = mod.cal.CostCalibrator()
    a.observe_trace(tr)
    reg = mod.met.MetricsRegistry()
    mod.met.phase_histograms_from_trace(tr, reg)
    b = mod.cal.CostCalibrator()
    b.observe_metrics(reg)
    return (cal.report(), cal.summary(), mod.rep.calibration_table(cal),
            a.report(), b.report(), reg.collect(),
            mod.cal.PHASES, mod.cal.CostCalibrator().summary())


def test_calibrator_and_table_equal_reference():
    got, want = _calibration(P), _calibration(J)
    assert got == want
    report, summary, table = got[:3]
    assert table[0].startswith("calibration (predicted vs observed")
    assert table[-1].strip() == summary
    assert [(r["phase"], r["observed"]) for r in got[3]] \
        == [(r["phase"], r["observed"]) for r in got[4]]


def test_calibrator_feed_reaches_a_detector():
    # the port's calibrator drives the port's DriftDetector, which fires
    # its model-error signal
    cal = pcal.CostCalibrator()
    cal.predict(0, "decode", 1.0)
    cal.observe(0, "decode", 2.0)
    cal.observe(0, "prefill", 1.0)                   # no prediction: not fed
    det = DriftDetector(rate=1.0, model_error_threshold=0.5,
                        model_error_min=1)
    assert cal.feed(det) == 1
    assert det.poll(0.0).kind == "model_error"


# ---------------------------------------------------------------------------
# Traced serving: pure observation, and the reference's trace
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pipes():
    cfg = get_config("granite-8b").reduced()
    tree = jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(0)))
    jparams = jax.tree.map(jnp.asarray, tree)
    pcfg = port_config("granite-8b").reduced()
    pparams = bridge.params_from_numpy(tree, device="cpu")
    dev = jax.devices()[0]
    L = cfg.num_layers

    def pipe(mod, split=None):
        split = split if split is not None else [1, L - 1]
        if mod is J:
            return JPipe(cfg, jparams, split, [[dev]] * len(split))
        return PPipe(pcfg, pparams, split, device="cpu")
    return cfg, pipe


def _mixed_reqs(mod, cfg, seed):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab_size, size=17).astype(np.int32)
    reqs = []
    for i in range(7):
        if i % 2 == 0:
            tail = rng.integers(0, cfg.vocab_size,
                                size=int(rng.integers(3, 8))).astype(np.int32)
            prompt = np.concatenate([shared, tail])
        else:
            prompt = rng.integers(0, cfg.vocab_size,
                                  size=int(rng.integers(8, 16))
                                  ).astype(np.int32)
        reqs.append(mod.req.Request(rid=i, prompt=prompt,
                                    max_new_tokens=int(rng.integers(8, 13)),
                                    arrival=0.1 * i))
    return reqs


def _serve_mixed(mod, pipes, seed, *, tracer=None, kvsan=False):
    cfg, pipe = pipes
    b = mod.cont.PagedPipelineBatcher(
        pipe(mod), n_slots=3, max_len=48, block_size=8, stage_blocks=[9, 9],
        admit_headroom=0, prefix_caching=True, prefill_chunk=8,
        spec=mod.Spec(k=2), kvsan=kvsan, prefill_token_cost=0.125)
    if tracer is not None:
        b.tracer = tracer
    reqs = _mixed_reqs(mod, cfg, seed)
    stats = b.serve(reqs, deadline=1e9)
    return b, reqs, stats


@pytest.fixture(scope="module")
def mixed_reference(pipes):
    """The reference's traced mixed serve (seed 3)."""
    tr = jtr.Tracer()
    _, reqs, stats = _serve_mixed(J, pipes, 3, tracer=tr)
    return tr, reqs, stats


@pytest.mark.parametrize("kvsan", [False, True])
def test_traced_serving_token_identical(pipes, mixed_reference, kvsan):
    _, reqs_off, stats_off = _serve_mixed(P, pipes, 3, kvsan=kvsan)
    tr = ptr.Tracer()
    _, reqs_on, stats_on = _serve_mixed(P, pipes, 3, tracer=tr, kvsan=kvsan)
    assert stats_off.prefix_hits > 0 and stats_off.spec_steps > 0
    assert stats_off.preemptions > 0
    for ro, rt in zip(reqs_off, reqs_on):
        assert list(ro.output) == list(rt.output), ro.rid
        assert rt.first_token_time == ro.first_token_time, ro.rid
        assert rt.prefill_finish_time is not None, ro.rid
        assert rt.prefill_finish_time <= rt.first_token_time, ro.rid
    for f in dataclasses.fields(ploop.ServeStats):
        assert getattr(stats_on, f.name) == getattr(stats_off, f.name)
    names = {e["name"] for e in tr.events}
    for want in ("serve", "queue_wait", "iteration", "prefill",
                 "spec_propose", "spec_verify", "preempt"):
        assert want in names, (want, sorted(names))
    assert names <= set(ptr.SPAN_NAMES) | {"serve", "spec_draft"}
    assert ptr.validate_chrome_trace(tr.to_chrome()) == []
    # the reference's trace of the same serve, byte for byte but the
    # producer's name
    jtr_, jreqs, jstats = mixed_reference
    assert _events(tr) == _events(jtr_)
    for a, b in zip(jreqs, reqs_on):
        assert list(a.output) == list(b.output)
        assert (a.first_token_time, a.prefill_finish_time) \
            == (b.first_token_time, b.prefill_finish_time)
    assert stats_on.kvsan_leaks == 0


def test_trace_bytes_identical_across_seeded_runs(pipes):
    tr1, tr2 = ptr.Tracer(), ptr.Tracer()
    _serve_mixed(P, pipes, 11, tracer=tr1)
    _serve_mixed(P, pipes, 11, tracer=tr2)
    assert tr1.dumps() == tr2.dumps() and len(tr1.events) > 20


def test_untraced_serving_emits_nothing(pipes):
    b, _, _ = _serve_mixed(P, pipes, 3)
    assert b.tracer is ptr.NULL_TRACER and ptr.NULL_TRACER.events == []


def _chunked_ttft(mod, pipes):
    cfg, pipe = pipes
    rng = np.random.default_rng(5)
    req = mod.req.Request(rid=0, prompt=rng.integers(
        0, cfg.vocab_size, size=20).astype(np.int32), max_new_tokens=4,
        arrival=0.0)
    tr = mod.tr.Tracer()
    b = mod.cont.PagedPipelineBatcher(pipe(mod), n_slots=2, max_len=48,
                                      block_size=8, prefill_chunk=8)
    b.tracer = tr
    b.serve([req], deadline=1e9)
    return req, tr


def test_chunked_prefill_ttft_equals_first_decode_span(pipes):
    (req, tr), (jr, jt) = _chunked_ttft(P, pipes), _chunked_ttft(J, pipes)
    decode_ts = [e["ts"] for e in tr.events if e["name"] == "decode"]
    assert len([e for e in tr.events if e["name"] == "prefill"]) >= 3
    assert req.first_token_time == min(decode_ts)
    assert req.prefill_finish_time <= req.first_token_time
    assert list(req.output) == list(jr.output)
    assert _events(tr) == _events(jt)


def _disagg_traced(mod, pipes, tracer):
    cfg, pipe = pipes
    rng = np.random.RandomState(3)
    rs = [mod.req.Request(rid=i, prompt=rng.randint(
        0, cfg.vocab_size, size=8 + i).astype(np.int32), max_new_tokens=5,
        arrival=0.4 * i) for i in range(4)]
    p = mod.cont.PagedPipelineBatcher(pipe(mod), n_slots=4, max_len=48,
                                      block_size=8, role="prefill",
                                      replica_id=0)
    d = mod.cont.PagedPipelineBatcher(pipe(mod), n_slots=4, max_len=48,
                                      block_size=8, role="decode",
                                      replica_id=1)
    disp = mod.dis.wire_disaggregation([p, d], ["prefill", "decode"],
                                       mod.dis.KVLink(gbps=1e-3))
    if tracer is not None:
        p.tracer = d.tracer = disp.tracer = tracer
    stats = mod.loop.run_serve_loop([p, d], rs, deadline=1e9,
                                    clock=mod.loop.VirtualClock(),
                                    tracer=tracer)
    return rs, stats


def test_disagg_migration_spans_equal_reference(pipes):
    rs_off, _ = _disagg_traced(P, pipes, None)
    tr = ptr.Tracer()
    rs_on, stats = _disagg_traced(P, pipes, tr)
    jt = jtr.Tracer()
    _disagg_traced(J, pipes, jt)
    assert stats.migrations == 4
    for ro, rt in zip(rs_off, rs_on):
        assert list(ro.output) == list(rt.output), ro.rid
    migs = [e for e in tr.events if e["name"] == "kv_migration"]
    assert len(migs) == stats.migrations
    assert all(e["args"]["dst"] == 1 and e["pid"] == 0 for e in migs)
    assert _events(tr) == _events(jt)


def _loop_metrics(mod, pipes):
    cfg, pipe = pipes
    b = mod.cont.PagedPipelineBatcher(pipe(mod), n_slots=3, max_len=48,
                                      block_size=8, prefix_caching=True,
                                      host_blocks=8, stage_blocks=[9, 9])
    reqs = _mixed_reqs(mod, cfg, 3)
    reg = mod.met.MetricsRegistry()
    stats = mod.loop.run_serve_loop([b], reqs, deadline=1e9,
                                    clock=mod.loop.VirtualClock(),
                                    metrics=reg)
    return reg, stats, len(reqs)


def test_loop_metrics_publication_equals_reference(pipes):
    (reg, stats, n), (jreg, jstats, _) = (_loop_metrics(P, pipes),
                                          _loop_metrics(J, pipes))
    assert reg.collect() == jreg.collect()
    assert reg.value("serve_prefix_hits", replica="0") \
        == stats.prefix_hits > 0
    assert reg.total("serve_n_requests") == n
    assert reg.gauge("kv_pool_peak_blocks", replica="0",
                     stage="1").value > 0
    back = ploop.ServeStats.from_metrics(reg)
    assert back.prefix_hits == stats.prefix_hits
    assert back.attainment == pytest.approx(stats.attainment)


# ---------------------------------------------------------------------------
# The report CLI
# ---------------------------------------------------------------------------

def test_report_cli_valid_and_invalid(tmp_path, capsys, pipes,
                                      mixed_reference):
    tr = ptr.Tracer()
    _serve_mixed(P, pipes, 3, tracer=tr)
    reg = pmet.MetricsRegistry()
    pmet.phase_histograms_from_trace(tr, reg)
    trace_p, metrics_p = tmp_path / "trace.json", tmp_path / "metrics.jsonl"
    tr.write(str(trace_p))
    reg.to_jsonl(str(metrics_p))
    argv = [str(metrics_p), "--trace", str(trace_p), "--require-spans",
            "prefill,spec_verify"]
    assert prep.main(argv) == 0
    out = capsys.readouterr().out
    assert "trace OK" in out and "calibration" in out
    # the reference's CLI prints the same report of the port's artifacts
    assert jrep.main(argv) == 0
    assert capsys.readouterr().out == out
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"ph": "X"}]}))
    assert prep.main(["--trace", str(bad)]) == 1
    assert "TRACE INVALID" in capsys.readouterr().out
    assert prep.main(["--trace", str(trace_p), "--require-spans",
                      "kv_migration"]) == 1
    capsys.readouterr()
    with pytest.raises(SystemExit):
        prep.main([])


# ---------------------------------------------------------------------------
# The launcher with every flag
# ---------------------------------------------------------------------------

LAUNCH = ["--arch", "granite-8b", "--reduced", "--cluster", "half_price",
          "--cache-layout", "paged", "--block-size", "8", "--prefix-caching",
          "--prefill-chunk", "16", "--shared-prefix", "24", "--prompt-len",
          "6", "--out-len", "4", "--rate", "4", "--duration", "1",
          "--search-iters", "2", "--deadline", "60", "--disaggregate",
          "--host-mem-gb", "1.0", "--cluster-prefix", "--kvsan",
          "--calibrate"]


def _with_roles(mod, schedule):
    """No pool of the catalog makes the scheduler split roles at a size
    the CPU serves quickly, so the plan takes the Router's default split
    on top of the search's own result (the same in both packages)."""
    def run(*a, **k):
        res = schedule(*a, **k)
        asg = res.plan.assignment
        plan = mod.plan.DeploymentPlan.from_search(
            asg, roles=mod.router.default_roles(asg.num_replicas),
            host_blocks=res.plan.host_blocks)
        return dataclasses.replace(res, plan=plan)
    return run


def test_launcher_serves_every_flag_as_the_reference(tmp_path, capsys,
                                                     monkeypatch):
    lines = {}
    for mod in (J, P):
        # the serve's clock: virtual in both, so the lines are comparable
        monkeypatch.setattr(mod.router, "WallClock", mod.loop.VirtualClock)
        monkeypatch.setattr(mod.serve, "schedule",
                            _with_roles(mod, mod.serve.schedule))
        tag = "j" if mod is J else "p"
        argv = LAUNCH + ["--trace-out", str(tmp_path / f"{tag}.json"),
                         "--metrics-out", str(tmp_path / f"{tag}.jsonl")]
        if mod is J:
            monkeypatch.setattr(sys, "argv", ["serve"] + argv)
            jserve.main()
        else:
            pserve.main(argv, device="cpu")
        lines[mod] = capsys.readouterr().out.replace(
            str(tmp_path / tag), "OUT").splitlines()
    got, want = lines[P], lines[J]
    # the port adds one line under the calibration table: what its
    # "observed" column is
    assert got.count(pserve.CALIBRATION_NOTE) == 1
    assert [x for x in got if x != pserve.CALIBRATION_NOTE] == want
    assert any(x.startswith("  roles: ['prefill'") for x in got)
    assert any(x.startswith("  host-tier blocks per replica: ") for x in got)
    assert any(x.startswith("  trace: OUT.json (") for x in got)
    assert any(x.strip().startswith("calibration (predicted vs observed")
               for x in got)
    summary = next(x for x in got if x.startswith("  n="))
    assert "mig=" in summary and "KVSAN" not in summary
    with open(tmp_path / "p.json") as f:
        ptrace = json.load(f)
    with open(tmp_path / "j.json") as f:
        jtrace = json.load(f)
    assert ptrace["traceEvents"] == jtrace["traceEvents"]
    assert ptr.validate_chrome_trace(
        ptrace, require_spans=["serve", "queue_wait", "prefill", "decode",
                               "kv_migration"]) == []
    assert pmet.MetricsRegistry.from_jsonl(str(tmp_path / "p.jsonl")
                                           ).collect() \
        == jmet.MetricsRegistry.from_jsonl(str(tmp_path / "j.jsonl")
                                           ).collect()
    assert prep.main([str(tmp_path / "p.jsonl"), "--trace",
                      str(tmp_path / "p.json"), "--require-spans",
                      "prefill,decode"]) == 0
