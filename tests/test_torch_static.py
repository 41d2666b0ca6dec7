"""Static batching, the contiguous layout and the sliding-window ring cache
of the port against the JAX package's, on the CPU, with weights bridged
from repro.models.model.init_params (reduced configs, fp32).

- the layers: ``attn_prefill`` / ``attn_decode`` on a ring that wraps
  (h2o-danube-1.8b reduced with an 8-token window, as tests/test_models.py
  does) and on a full cache with left padding (kv_start), with scalar and
  per-row positions; the whole model's prefill / decode_step on the ring;
- ``AsymmetricPipeline.generate`` over a [1, 1] split on left-padded
  prompts (tests/test_serving.py:53);
- the engine's fallback to static batching for a sliding-window model,
  ``PipelineBatcher`` on the contiguous layout and ``ContinuousBatcher``
  (tests/test_continuous.py:33) on a VirtualClock: identical tokens and
  every ServeStats counter, ``rejected`` included;
- the port's ``schedule`` of h2o-danube-1.8b;
- the reference's ring decode ignoring kv_start (ROADMAP.md F5), both
  sides recorded;
- the head dims of the kernels: #1 and #8 take 80 (h2o-danube-1.8b's), the
  paged kernels refuse it by name, and the plain versions agree with the
  reference's at d 80.

Logits and caches agree within atol = rtol = 1e-4 (float32 sums run in
another order in the two frameworks)."""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import cluster as jcl
from repro.core import cost_model as jcm
from repro.core.scheduler import schedule as jschedule
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro.models import model as JM
from repro.serving import request as jreq
from repro.serving.continuous import ContinuousBatcher as JBatcher
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving.loop import VirtualClock as JClock
from repro.serving.pipeline import AsymmetricPipeline as JPipeline
from repro_torch import bridge
from repro_torch.configs import get_config as port_config
from repro_torch.core import plan as port_plan
from repro_torch.core.scheduler import schedule as pschedule
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref as pref
from repro_torch.models import layers as PL
from repro_torch.models import model as PM
from repro_torch.serving import request as preq
from repro_torch.serving.continuous import ContinuousBatcher as PBatcher
from repro_torch.serving.engine import InferenceEngine as PEngine
from repro_torch.serving.loop import ServeStats as PStats
from repro_torch.serving.loop import VirtualClock as PClock
from repro_torch.serving.pipeline import AsymmetricPipeline as PPipeline
from repro_torch.serving.config import ServingConfig
from repro.core.plan import Assignment, PipelinePlan, StagePlan

TOL = dict(atol=1e-4, rtol=1e-4)
DANUBE = "h2o-danube-1.8b"


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _configs(arch, **over):
    return (dataclasses.replace(get_config(arch).reduced(), **over),
            dataclasses.replace(port_config(arch).reduced(), **over))


_TREES = {}


def _tree(arch):
    """The reference's reduced weights, made once per module and arch."""
    if arch not in _TREES:
        cfg = get_config(arch).reduced()
        _TREES[arch] = jax.tree.map(
            np.asarray, JM.init_params(cfg, jax.random.PRNGKey(0)))
    return _TREES[arch]


def test_port_config_matches_reference():
    assert port_config(DANUBE).__dict__ == get_config(DANUBE).__dict__
    assert port_config(DANUBE).reduced().__dict__ \
        == get_config(DANUBE).reduced().__dict__
    assert port_config(DANUBE).head_dim_ == 80
    assert port_config(DANUBE).total_params == get_config(DANUBE).total_params


# ---------------------------------------------------------------------------
# Layers and the whole model on contiguous caches
# ---------------------------------------------------------------------------

def _zeros_cache(b, S, cfg):
    return np.zeros((b, S, cfg.num_kv_heads, cfg.head_dim_), np.float32)


@pytest.mark.parametrize("layout", ["ring", "full"])
@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per-row"])
def test_attn_prefill_and_decode_match(layout, per_row):
    window = 8 if layout == "ring" else 0
    cfg, pcfg = _configs(DANUBE, swa_window=window)
    lp = jax.tree.map(lambda a: a[1], _tree(DANUBE)["blocks"]["sub0"])
    jp = jax.tree.map(jnp.asarray, lp["mixer"])
    pp = bridge.params_from_numpy(lp["mixer"], device="cpu")
    rng = np.random.default_rng(3)
    b, s = 2, 12
    S = window or s + 12           # the ring holds the window, else it all
    ks = np.array([3, 0], np.int32)
    x = (0.5 * rng.standard_normal((b, s, cfg.d_model))).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (b, s)).astype(np.int32)
    jc = {n: jnp.asarray(_zeros_cache(b, S, cfg)) for n in ("k", "v")}
    want, jc = JL.attn_prefill(jp, jnp.asarray(x), cfg,
                               positions=jnp.asarray(pos),
                               kv_start=jnp.asarray(ks), cache=jc)
    got, k, v = PL.attn_prefill(pp, _t(x), pcfg, positions=_t(pos).long(),
                                kv_start=_t(ks))
    pc = {n: _t(_zeros_cache(b, S, cfg)) for n in ("k", "v")}
    PL.write_cache(pc, k, v, window=pcfg.swa_window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(pc[n].numpy(), np.asarray(jc[n]), **TOL)
    # decode past the window: the ring wraps and evicts the oldest keys
    for step in range(6):
        xd = (0.5 * rng.standard_normal((b, 1, cfg.d_model))).astype(
            np.float32)
        p = (np.array([s + step, s + 2 * step], np.int32) if per_row
             else s + step)
        want, jc = JL.attn_decode(jp, jnp.asarray(xd), cfg,
                                  pos=jnp.asarray(p), kv_start=jnp.asarray(ks),
                                  cache=jc)
        got = PL.attn_decode(pp, _t(xd), pcfg, pos=_t(p), cache=pc,
                             kv_start=_t(ks))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=f"decode {step}", **TOL)
        for n in ("k", "v"):
            np.testing.assert_allclose(pc[n].numpy(), np.asarray(jc[n]),
                                       **TOL)


def test_model_prefill_and_decode_steps_match_on_the_ring():
    cfg, pcfg = _configs(DANUBE, swa_window=8)
    tree = _tree(DANUBE)
    params = bridge.params_from_numpy(tree, device="cpu")
    rng = np.random.default_rng(4)
    b, s, n = 2, 12, 5
    toks = rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)
    toks[0, :3] = 0
    ks = np.array([3, 0], np.int32)
    jc = JM.init_cache(cfg, b, s + n)
    pc = PM.init_cache(pcfg, b, s + n, device="cpu")
    assert jax.tree.map(lambda a: a.shape, jc) \
        == jax.tree.map(lambda t: tuple(t.shape), pc)
    assert pc["sub0"]["k"].shape[2] == 8             # the window's ring
    want, jc = JM.prefill(cfg, jax.tree.map(jnp.asarray, tree),
                          {"tokens": jnp.asarray(toks)}, jc,
                          kv_start=jnp.asarray(ks))
    got, pc = PM.prefill(pcfg, params, {"tokens": toks}, pc, kv_start=ks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for step in range(n):
        nxt = np.asarray(want).argmax(-1).astype(np.int32)
        want, jc = JM.decode_step(cfg, jax.tree.map(jnp.asarray, tree),
                                  jnp.asarray(nxt), jc, s + step,
                                  kv_start=jnp.asarray(ks))
        got, pc = PM.decode_step(pcfg, params, nxt, pc, s + step,
                                 kv_start=ks)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=f"decode {step}", **TOL)
    np.testing.assert_allclose(pc["sub0"]["k"].numpy(),
                               np.asarray(jc["sub0"]["k"]), **TOL)


# ---------------------------------------------------------------------------
# The static pipeline path
# ---------------------------------------------------------------------------

def _pipelines(arch, **over):
    cfg, pcfg = _configs(arch, **over)
    tree = _tree(arch)
    dev = jax.devices()[0]
    return (JPipeline(cfg, jax.tree.map(jnp.asarray, tree), [1, 1],
                      [[dev], [dev]]),
            PPipeline(pcfg, bridge.params_from_numpy(tree, device="cpu"),
                      [1, 1], device="cpu"))


def _left_padded(rng, vocab, lens):
    s = max(lens)
    toks = np.zeros((len(lens), s), np.int32)
    for i, n in enumerate(lens):
        toks[i, s - n:] = rng.integers(1, vocab, n)
    return toks, np.array([s - n for n in lens], np.int32)


@pytest.mark.parametrize("arch", [DANUBE, "granite-8b"])
def test_pipeline_generate_matches_reference(arch):
    # h2o-danube: a 64-slot ring that wraps (28 + 50 > 64); granite: a full
    # cache whose left padding decode masks with kv_start
    jp, pp = _pipelines(arch)
    rng = np.random.default_rng(5)
    toks, ks = _left_padded(rng, jp.cfg.vocab_size, [24, 28, 19])
    max_new = 50 if arch == DANUBE else 12
    np.testing.assert_allclose(
        pp.prefill(toks, kv_start=ks, max_new=max_new),
        jp.prefill(toks, kv_start=jnp.asarray(ks), max_new=max_new), **TOL)
    want = jp.generate(toks, max_new=max_new, kv_start=ks)
    got = pp.generate(toks, max_new=max_new, kv_start=ks)
    assert got.shape == want.shape == (3, max_new)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_ring_decode_attends_left_padding_as_the_reference_does():
    """ROADMAP.md F5: on the ring, the reference's attn_decode passes
    kv_len only, so a left-padded row attends to its pad keys in decode.
    Its prefill logits equal its isolated prefill's; its first decode
    logits do not. The port does the same, to the reference's logits and
    tokens."""
    jp, pp = _pipelines(DANUBE)
    rng = np.random.default_rng(6)
    toks, ks = _left_padded(rng, jp.cfg.vocab_size, [24, 28])
    alone = toks[:1, 4:]                        # row 0 without its pad
    first = {}
    for name, p in (("ref", jp), ("port", pp)):
        batch = p.prefill(toks, kv_start=ks, max_new=8)
        solo = p.prefill(alone, max_new=8)
        np.testing.assert_allclose(batch[0], solo[0], **TOL)
        nxt = batch.argmax(-1).astype(np.int32)
        p.prefill(toks, kv_start=ks, max_new=8)
        batch_dec = p.decode_step(nxt)
        p.prefill(alone, max_new=8)
        solo_dec = p.decode_step(nxt[:1])
        # the pad keys carry weight: far beyond float32 rounding
        assert np.abs(batch_dec[0] - solo_dec[0]).max() > 1e-2, name
        first[name] = batch_dec
    np.testing.assert_allclose(first["port"], first["ref"], **TOL)
    np.testing.assert_array_equal(
        pp.generate(toks, max_new=8, kv_start=ks),
        jp.generate(toks, max_new=8, kv_start=ks))


# ---------------------------------------------------------------------------
# Engines on a VirtualClock
# ---------------------------------------------------------------------------

def _asgs():
    j = Assignment([PipelinePlan([StagePlan([0], 1), StagePlan([1], 1)])])
    p = port_plan.Assignment([port_plan.PipelinePlan(
        [port_plan.StagePlan([0], 1), port_plan.StagePlan([1], 1)])])
    return j, p


def _workload(mod, vocab, oversized):
    reqs = mod.synth_workload(rate=12.0, duration=1.0, vocab=vocab,
                              prompt_len=10, prompt_jitter=4, out_len=5,
                              seed=4)
    # one request that no cache row of this engine can hold: rejected
    reqs.append(mod.Request(rid=len(reqs),
                            prompt=np.arange(1, 31, dtype=np.int32),
                            max_new_tokens=oversized, arrival=0.05))
    return reqs


def _assert_same_serve(jreqs, preqs, jstats, pstats):
    assert len(preqs) == len(jreqs) > 1
    for a, b in zip(jreqs, preqs):
        assert a.output is not None
        assert list(b.output) == list(a.output), a.rid
        assert (b.start_time, b.finish_time) == (a.start_time, a.finish_time)
    for f in dataclasses.fields(PStats):
        assert getattr(pstats, f.name) == getattr(jstats, f.name), f.name
    assert pstats.rejected == 1


def test_engine_static_fallback_matches_reference():
    # a sliding-window model cannot take slot mode: both engines warn and
    # serve it with the whole-batch engine, an 8-token ring wrapping
    cfg, pcfg = _configs(DANUBE, swa_window=8)
    tree = _tree(DANUBE)
    jasg, pasg = _asgs()
    common = dict(n_slots=4, max_len=40, max_batch=3)
    with pytest.warns(UserWarning, match="policy='static'"):
        jeng = JEngine(cfg, jasg, params=jax.tree.map(jnp.asarray, tree),
                       **common)
    with pytest.warns(UserWarning, match="policy='static'"):
        peng = PEngine(pcfg, pasg, device="cpu",
                       params=bridge.params_from_numpy(tree, device="cpu"),
                       **common)
    assert [type(w).__name__ for w in peng.router.workers] \
        == [type(w).__name__ for w in jeng.router.workers] \
        == ["StaticBatcher"]
    jreqs = _workload(jreq, cfg.vocab_size, oversized=20)
    preqs = _workload(preq, cfg.vocab_size, oversized=20)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # the rejection's warning
        jstats = jeng.serve(jreqs, deadline=120.0, clock=JClock())
        pstats = peng.serve(preqs, deadline=120.0, clock=PClock())
    _assert_same_serve(jreqs, preqs, jstats, pstats)
    # the static engine's own generate: one left-padded batch
    prompts = [r.prompt for r in preqs[:3]]
    for a, b in zip(jeng.generate(prompts, max_new=6),
                    peng.generate(prompts, max_new=6)):
        np.testing.assert_array_equal(b, a)


def _isolated(pcfg, params, prompt, n):
    """Greedy generation of one prompt alone on a full contiguous cache."""
    cache = PM.init_cache(pcfg, 1, len(prompt) + n, device="cpu")
    lg, cache = PM.prefill(pcfg, params, {"tokens": prompt[None]}, cache)
    out = []
    for step in range(n):
        out.append(int(lg[0].argmax()))
        lg, cache = PM.decode_step(pcfg, params, [out[-1]], cache,
                                   len(prompt) + step)
    return out


def test_pipeline_batcher_contiguous_matches_reference_and_isolated():
    cfg, pcfg = _configs("granite-8b")
    tree = _tree("granite-8b")
    params = bridge.params_from_numpy(tree, device="cpu")
    jasg, pasg = _asgs()
    common = dict(policy="continuous", cache_layout="contiguous", n_slots=2,
                  max_len=32)
    jeng = JEngine(cfg, jasg, params=jax.tree.map(jnp.asarray, tree),
                   **common)
    peng = PEngine(pcfg, pasg, params=params, device="cpu", **common)
    assert type(peng.router.workers[0]).__name__ == "PipelineBatcher"
    jreqs = _workload(jreq, cfg.vocab_size, oversized=2)
    preqs = _workload(preq, cfg.vocab_size, oversized=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jstats = jeng.serve(jreqs, deadline=120.0, clock=JClock())
        pstats = peng.serve(preqs, deadline=120.0, clock=PClock())
    _assert_same_serve(jreqs, preqs, jstats, pstats)
    for r in preqs[:-1]:
        assert list(r.output) == _isolated(pcfg, params, r.prompt,
                                           r.max_new_tokens), r.rid


def test_continuous_batcher_matches_reference_and_isolated():
    cfg, pcfg = _configs("granite-8b")
    tree = _tree("granite-8b")
    params = bridge.params_from_numpy(tree, device="cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=6 + 3 * i).astype(
        np.int32) for i in range(3)]
    jreqs = [jreq.Request(rid=i, prompt=p, max_new_tokens=5)
             for i, p in enumerate(prompts)]
    preqs = [preq.Request(rid=i, prompt=p, max_new_tokens=5)
             for i, p in enumerate(prompts)]
    jstats = JBatcher(cfg, jax.tree.map(jnp.asarray, tree), n_slots=2,
                      max_len=48).serve(jreqs, deadline=1e9)
    pstats = PBatcher(pcfg, params, n_slots=2, max_len=48).serve(
        preqs, deadline=1e9)
    assert pstats.iterations == jstats.iterations
    assert pstats.latencies == jstats.latencies
    for a, b in zip(jreqs, preqs):
        assert list(b.output) == list(a.output) \
            == _isolated(pcfg, params, b.prompt, 5), a.rid
    with pytest.raises(NotImplementedError, match="static"):
        PBatcher(_configs(DANUBE)[1], params)


# ---------------------------------------------------------------------------
# The scheduler on the launcher's default architecture
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cluster", ["case_study", "half_price"])
def test_schedule_of_h2o_danube_equals_reference(cluster):
    sv = ServingConfig(arch=DANUBE, cluster=cluster, search_iters=3)
    kw = sv.schedule_kwargs()
    jpool = {"case_study": jcl.case_study_cluster,
             "half_price": jcl.hetero_half_price}[cluster]()
    want = jschedule(jpool, DANUBE,
                     jcm.Task(**dataclasses.asdict(sv.task())), **kw)
    got = pschedule(sv.pool(), DANUBE, sv.task(), **kw)
    assert got.plan.describe() == want.plan.describe()
    assert [p.device_ids for p in got.assignment.pipelines] \
        == [p.device_ids for p in want.assignment.pipelines]
    assert got.attainment == want.attainment
    assert got.evaluations == want.evaluations
    assert [s for _, s in got.history] == [s for _, s in want.history]
    got.plan.validate(24)


# ---------------------------------------------------------------------------
# Head dims: #1 and #8 take 80, the paged kernels refuse it by name
# ---------------------------------------------------------------------------

PAGED = {
    "paged_decode_attention": lambda q, k, ks, t: pa.paged_decode_attention_cuda(
        q, k, k, t),
    "paged_context_attention": lambda q, k, ks, t:
        pa.paged_context_attention_cuda(q, k, k, t, q_start=[0], kv_len=[1]),
    "paged_verify_attention": lambda q, k, ks, t:
        pa.paged_verify_attention_cuda(q, k, k, t, kv_start=[0], kv_len=[1]),
    "paged_decode_attention_quant": lambda q, k, ks, t:
        pa.paged_decode_attention_quant_cuda(q, k.to(torch.int8),
                                             k.to(torch.int8), ks, ks, t),
    "paged_context_attention_quant": lambda q, k, ks, t:
        pa.paged_context_attention_quant_cuda(
            q, k.to(torch.int8), k.to(torch.int8), ks, ks, t, q_start=[0],
            kv_len=[1]),
    "paged_verify_attention_quant": lambda q, k, ks, t:
        pa.paged_verify_attention_quant_cuda(
            q, k.to(torch.int8), k.to(torch.int8), ks, ks, t, kv_start=[0],
            kv_len=[1]),
}


@pytest.mark.parametrize("name", sorted(PAGED))
def test_paged_kernels_refuse_head_dim_80_by_name(name):
    q = torch.zeros(1, 1, 4, 80)
    k = torch.zeros(2, 8, 1, 80)
    ks = torch.zeros(2, 8, 1)
    tbl = torch.zeros(1, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match=rf"{name}\b.*80"):
        PAGED[name](q, k, ks, tbl)


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention"])
def test_contiguous_kernels_take_head_dim_80(name):
    # the head dim passes the input check; a CPU tensor then fails the
    # device check, so nothing is computed here
    q, k = torch.zeros(1, 1, 4, 80), torch.zeros(1, 8, 1, 80)
    fn = {"flash_attention": fa.flash_attention_cuda,
          "decode_attention": da.decode_attention_cuda}[name]
    with pytest.raises(ValueError, match="CUDA"):
        fn(q, k, k)


def test_plain_versions_match_reference_at_head_dim_80():
    # g 4, as h2o-danube-1.8b: a window shorter than the keys, left padding
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 37, 8, 80)).astype(np.float32)
    k = rng.standard_normal((2, 37, 2, 80)).astype(np.float32)
    v = rng.standard_normal((2, 37, 2, 80)).astype(np.float32)
    ks = np.array([5, 0], np.int32)
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True, window=16,
                              kv_start=jnp.asarray(ks))
    got = pref.attention_ref(_t(q), _t(k), _t(v), causal=True, window=16,
                             kv_start=_t(ks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    lens = np.array([37, 20], np.int32)
    want = jref.decode_attention_ref(jnp.asarray(q[:, :1]), jnp.asarray(k),
                                     jnp.asarray(v), kv_len=jnp.asarray(lens),
                                     kv_start=jnp.asarray(ks))
    got = pref.decode_attention_ref(_t(q[:, :1]), _t(k), _t(v),
                                    kv_len=_t(lens), kv_start=_t(ks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
