"""Unquantized page pools of another width than the model's, in the port
against the JAX package on the CPU: a bf16 pool under an fp32 model and an
fp32 pool under a bf16 model (``kv_dtype="bf16"`` / ``"fp32"``).

The paged kernels' plain versions (what ops runs on CPU tensors, and what
the CUDA kernels are held against on the card) widen both sides to fp32,
as the reference's Pallas kernels do (repro/kernels/paged_attention.py:
47-49): decode, context and verify against those kernels in interpret mode
(fp32 q: atol 2e-5; bf16 q: one bf16 ulp of the largest output). Then the
pool layout, and the engines on the same bridged granite-8b (reduced)
weights and the same kv_dtype, mirroring tests/test_paged.py's
test_paged_serving_int8_pool_matches_fp32_tokens[bf16]: greedy tokens and
every ServeStats field (kv_bytes_resident and kv_bytes_saved included)
equal the JAX engine's (under the bf16 model, tokens up to a near tie of
the reference's logits), through a cold joint prefill, a prefix-cache hit
with chunked prefill (#3), n-gram speculation (#4) and a host page tier
under KVSAN (pages spill and promote at the pool's width). Last, the serve
launcher with ``--kv-dtype bf16`` on the fp32 reduced model."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.plan import Assignment, PipelinePlan, StagePlan
from repro.kernels.paged_attention import (paged_context_attention_pallas,
                                           paged_decode_attention_pallas,
                                           paged_verify_attention_pallas)
from repro.models import model as JM
from repro.serving import request as jreq
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving.loop import VirtualClock as JClock
from repro_torch import bridge
from repro_torch.configs import get_config as port_config
from repro_torch.core import plan as pplan
from repro_torch.kernels import ops
from repro_torch.launch import serve as pserve
from repro_torch.models import model as PM
from repro_torch.serving import loop as ploop
from repro_torch.serving import request as preq
from repro_torch.serving.engine import InferenceEngine as PEngine

ATOL = 2e-5
# (q dtype, pool dtype): an fp32 model on a bf16 pool, a bf16 model on an
# fp32 pool
WIDTHS = {"fp32-q-bf16-pool": ("float32", "bfloat16"),
          "bf16-q-fp32-pool": ("bfloat16", "float32")}


def _rn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _both(x, dtype):
    """fp32 numpy x as (torch, jax) arrays of `dtype`, rounded alike."""
    return (torch.from_numpy(x).to(getattr(torch, dtype)),
            jnp.asarray(x).astype(getattr(jnp, dtype)))


KERNELS = {
    "decode": (paged_decode_attention_pallas, ops.paged_decode_attention),
    "context": (paged_context_attention_pallas,
                ops.paged_context_attention),
    "verify": (paged_verify_attention_pallas, ops.paged_verify_attention),
}


def _inputs(kernel, bs):
    """b 2, hq 8 on hkv 2 (g 4), d 32, 12-block pools of block size bs,
    tables reaching 64 keys."""
    rng = np.random.default_rng(3)
    b, hq, hkv, d, nblk = 2, 8, 2, 32, 12
    pools = _rn(rng, nblk, bs, hkv, d), _rn(rng, nblk, bs, hkv, d)
    nb = 64 // bs
    tbl = np.stack([rng.permutation(np.arange(1, nblk))[:nb]
                    for _ in range(b)]).astype(np.int32)
    i32 = lambda *x: np.array(x, np.int32)              # noqa: E731
    q, kw = {"decode": (_rn(rng, b, 1, hq, d), dict(kv_len=i32(41, 64))),
             "context": (_rn(rng, b, 8, hq, d),
                         dict(q_start=i32(17, 40), kv_len=i32(25, 45))),
             "verify": (_rn(rng, b, 4, hq, d),
                        dict(kv_start=i32(21, 33), kv_len=i32(25, 35)))
             }[kernel]
    return q, pools, tbl, kw


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("widths", sorted(WIDTHS))
def test_mixed_width_plain_versions_match_pallas(widths, kernel):
    qdt, pdt = WIDTHS[widths]
    q, (k, v), tbl, kw = _inputs(kernel, 8)
    (tq, jq), (tk, jk), (tv, jv) = _both(q, qdt), _both(k, pdt), \
        _both(v, pdt)
    pallas, port_entry = KERNELS[kernel]
    want = pallas(jq, jk, jv, jnp.asarray(tbl), interpret=True,
                  **{n: jnp.asarray(x) for n, x in kw.items()})
    got = port_entry(tq, tk, tv, torch.from_numpy(tbl),
                     **{n: torch.from_numpy(x) for n, x in kw.items()})
    assert got.dtype == tq.dtype
    want = np.asarray(want.astype(jnp.float32))
    err = float(np.abs(got.float().numpy() - want).max())
    tol = ATOL if qdt == "float32" else 2.0 ** -7 * np.abs(want).max()
    assert err <= tol, f"max abs err {err} > {tol}"


@pytest.mark.parametrize("widths", sorted(WIDTHS))
def test_pool_of_the_other_width_matches_reference_layout(widths):
    # the pool as the reference builds it (tests/test_paged.py:501 builds
    # the bf16 one under the fp32 model), and an engine built on it
    qdt, pdt = WIDTHS[widths]
    kv = {"bfloat16": "bf16", "float32": "fp32"}[pdt]
    cfg = dataclasses.replace(get_config("granite-8b").reduced(), dtype=qdt)
    want = JM.init_layer_paged_cache(cfg, 1, 6, 8, 2, kv_dtype=kv)
    pcfg = dataclasses.replace(port_config("granite-8b").reduced(),
                               dtype=qdt)
    got = PM.init_layer_paged_cache(pcfg, 1, 6, 8, dtype=getattr(torch, qdt),
                                    device="cpu", kv_dtype=kv)
    assert sorted(got) == sorted(want) == ["k", "v"]
    for n, t in got.items():
        assert tuple(t.shape) == want[n].shape
        assert str(t.dtype).split(".")[-1] == want[n].dtype.name == pdt
    pasg = pplan.Assignment([pplan.PipelinePlan(
        [pplan.StagePlan([0], 1), pplan.StagePlan([1], 1)])])
    eng = PEngine(pcfg, pasg, params=PM.init_params(pcfg, device="cpu"),
                  device="cpu", cache_layout="paged", kv_dtype=kv)
    assert eng.router.workers[0].kv_dtype == kv


# --- serving: the engines, token and counter identical ---------------------

def _synth(mod, vocab):
    return mod.synth_workload(rate=40.0, duration=0.25, vocab=vocab,
                              prompt_len=8, prompt_jitter=5, out_len=4,
                              seed=1)


def _shared(mod, vocab):
    return mod.shared_prefix_workload(rate=4.0, duration=1.0, vocab=vocab,
                                      shared_len=24, unique_len=6,
                                      out_len=4, seed=3)


def _families(mod, vocab):
    """Three prompt families of 24 tokens, each seen twice."""
    reqs = []
    for i in range(6):
        rng = np.random.RandomState(100 + i % 3)
        prompt = rng.randint(0, vocab, size=24).astype(np.int32)
        reqs.append(mod.Request(rid=i, prompt=prompt, max_new_tokens=4,
                                arrival=0.3 * i))
    return reqs


SERVES = {
    # an fp32 model on bf16 pools: the cold joint prefill and decode (#2)
    "bf16-pool": ("float32", _synth, dict(kv_dtype="bf16")),
    # ... through prefix-cache hits and chunked prefill (#3)
    "bf16-pool-prefix": ("float32", _shared,
                         dict(kv_dtype="bf16", prefix_caching=True,
                              prefill_chunk=16)),
    # ... under n-gram speculation (#4)
    "bf16-pool-ngram": ("float32", _synth,
                        dict(kv_dtype="bf16", spec_decode=True, spec_k=3)),
    # ... with a host page tier under KVSAN: evicted prefix pages spill and
    # promote at the pool's width
    "bf16-pool-host-tier": ("float32", _families,
                            dict(kv_dtype="bf16", prefix_caching=True,
                                 stage_blocks=[10, 10], host_blocks=64,
                                 host_swap_cost=0.05, kvsan=True)),
    # a bf16 model on fp32 pools
    "fp32-pool-bf16-model": ("bfloat16", _synth, dict(kv_dtype="fp32")),
}


@pytest.fixture(scope="module")
def weights():
    """The reference's granite-8b (reduced) weights per model dtype: the
    JAX tree, and its float leaves widened to fp32 numpy for the bridge
    (exact for bf16)."""
    out = {}
    for dt in ("float32", "bfloat16"):
        cfg = dataclasses.replace(get_config("granite-8b").reduced(),
                                  dtype=dt)
        jp = JM.init_params(cfg, jax.random.PRNGKey(0))
        tree = jax.tree.map(
            lambda a: np.asarray(a.astype(jnp.float32)
                                 if a.dtype == jnp.bfloat16 else a), jp)
        out[dt] = cfg, jp, tree
    return out


def _serve_both(weights, dt, make, kw):
    """The same workload through the JAX engine and the port's on the
    bridged weights of model dtype `dt`: (JAX requests, JAX stats, port
    requests, port stats, port engine)."""
    cfg, jp, tree = weights[dt]
    common = dict(n_slots=4, max_len=48, block_size=8)
    common.update(kw)
    asg = Assignment([PipelinePlan([StagePlan([0], 1), StagePlan([1], 1)])])
    jreqs = make(jreq, cfg.vocab_size)
    jstats = JEngine(cfg, asg, params=jp, policy="continuous",
                     cache_layout="paged", **common).serve(
                         jreqs, deadline=120.0, clock=JClock())

    pcfg = dataclasses.replace(port_config("granite-8b").reduced(), dtype=dt)
    pasg = pplan.Assignment([pplan.PipelinePlan(
        [pplan.StagePlan([0], 1), pplan.StagePlan([1], 1)])])
    preqs = make(preq, pcfg.vocab_size)
    eng = PEngine(pcfg, pasg, params=bridge.params_from_numpy(
        tree, device="cpu", dtype=getattr(torch, dt)), device="cpu",
        cache_layout="paged", **common)
    pstats = eng.serve(preqs, deadline=120.0, clock=ploop.VirtualClock())
    assert len(preqs) == len(jreqs) > 0
    for r in jreqs + preqs:
        assert r.output is not None and len(r.output) == r.max_new_tokens
    return jreqs, jstats, preqs, pstats, eng


def _hold_near_ties(cfg, jp, jreqs, preqs):
    """A bf16 model's logits in the port differ from the reference's by
    up to one bf16 ulp (the frameworks round in another order), so for
    some weights (the reference's change with the hash seed, ROADMAP F1) a
    greedy choice between two near-equal logits flips, whatever the pool.
    Each request's tokens equal the reference's up to its first
    difference, and there both choices lie within NEAR_TIE_ULPS bf16 ulps
    of the top of the reference's logits for the same prefix."""
    for a, b in zip(jreqs, preqs):
        want, got = list(a.output), list(b.output)
        if want == got:
            continue
        t = next(i for i, (x, y) in enumerate(zip(want, got)) if x != y)
        toks = np.concatenate([np.asarray(a.prompt, np.int32),
                               np.asarray(want[:t], np.int32)])[None]
        logits, _ = JM.train_forward(cfg, jp, {"tokens": jnp.asarray(toks)})
        lg = np.asarray(logits[0, -1].astype(jnp.float32))
        top = float(lg.max())
        tie = NEAR_TIE_ULPS * 2.0 ** (np.floor(np.log2(abs(top))) - 7)
        gap = top - min(lg[want[t]], lg[got[t]])
        assert gap <= tie, (a.rid, t, want[t], got[t], gap, tie)


# a bf16 model's near tie: the reference's top logit and a choice this
# many bf16 ulps (of the top's binade) below it
NEAR_TIE_ULPS = 2


@pytest.mark.parametrize("name", sorted(SERVES))
def test_mixed_width_serving_token_identical_to_reference(weights, name):
    dt, make, kw = SERVES[name]
    jreqs, jstats, preqs, pstats, eng = _serve_both(weights, dt, make, kw)
    if dt == "float32":
        assert [list(r.output) for r in preqs] == \
            [list(r.output) for r in jreqs]
    else:
        _hold_near_ties(weights[dt][0], weights[dt][1], jreqs, preqs)
    for f in dataclasses.fields(ploop.ServeStats):
        assert getattr(pstats, f.name) == getattr(jstats, f.name), f.name
    pool = {"bf16": torch.bfloat16, "fp32": torch.float32}[kw["kv_dtype"]]
    assert {c["k"].dtype for st in eng.replicas[0].paged_caches
            for c in st} == {pool}
    assert pstats.kv_bytes_resident > 0
    assert (pstats.kv_bytes_saved > 0) == (pool == torch.bfloat16)
    if name == "bf16-pool-prefix":
        assert pstats.prefix_hits > 0
    if name == "bf16-pool-ngram":
        assert pstats.spec_steps > 0
    if name == "bf16-pool-host-tier":
        assert pstats.host_demotions > 0 and pstats.host_promotions > 0


def test_launcher_serves_a_bf16_pool_under_an_fp32_model(capsys):
    pserve.main(["--arch", "granite-8b", "--reduced", "--cluster",
                 "case_study", "--cache-layout", "paged", "--rate", "4",
                 "--duration", "1", "--out-len", "4", "--search-iters", "2",
                 "--kv-dtype", "bf16"], device="cpu")
    last = capsys.readouterr().out.splitlines()[-1]
    assert last.startswith("  n=") and "kv=" in last
