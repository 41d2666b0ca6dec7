"""The dense and MoE configurations of the zoo in the port against the JAX
package: granite-20b (MQA, a gelu MLP without a gate), codeqwen1.5-7b
(MHA with q/k/v bias, RoPE base 1e6), phi3.5-moe-42b-a6.6b (16 experts
top-2 on every layer) and granite-moe-3b-a800m (40 experts top-8, g 3).

The port's registry must equal the reference's configs field by field.
The blocks (the biased projections on every attention path, the tanh-GELU
MLP and expert FFN, whole-model prefill and decode) take weights bridged
from ``repro.models.model.init_params``; the reference initialises the
q/k/v biases to zeros, so the tests give both sides the same nonzero
seeded biases. The engines serve each ``.reduced()`` config, and two
variants that keep the full configs' GQA groups (granite-20b at 48 query
heads on one kv head, granite-moe at 6 on 2), on the paged layout through
a [1, 1] pipeline, with greedy tokens and every ServeStats counter equal
to the JAX engine's; also prefix caching with chunked prefill, int8
pages, n-gram speculation and int8 weights (the same quantized weights on
both sides, never quantized against float). fp32 throughout; tolerances
atol = rtol = 1e-4, as in test_torch_models.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.plan import Assignment, PipelinePlan, StagePlan
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.models import quant as JQ
from repro.serving import request as jreq
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving.loop import VirtualClock as JClock
from repro_torch import bridge
from repro_torch.configs import get_config as port_config
from repro_torch.configs import list_archs
from repro_torch.core import plan as port_plan
from repro_torch.models import layers as PL
from repro_torch.models import model as PM
from repro_torch.models import moe as PMoE
from repro_torch.serving import request as preq
from repro_torch.serving.engine import InferenceEngine as PEngine
from repro_torch.serving.loop import VirtualClock as PClock

TOL = dict(atol=1e-4, rtol=1e-4)
NEW = ("granite-20b", "codeqwen1.5-7b", "phi3.5-moe-42b-a6.6b",
       "granite-moe-3b-a800m", "xlstm-125m")
COUNTERS = ("latencies", "iterations", "prefill_tokens", "prefix_lookups",
            "prefix_hits", "prefix_hit_tokens", "cow_copies", "preemptions",
            "spec_steps", "spec_proposed", "spec_accepted", "spec_tokens",
            "kv_bytes_resident", "kv_bytes_saved")
# the served models: each .reduced() config, and two variants that keep
# the full configs' GQA groups (g 48 and g 3)
MODELS = {
    "granite-20b": ("granite-20b", {}),
    "granite-20b-g48": ("granite-20b",
                        dict(num_heads=48, num_kv_heads=1, head_dim=16)),
    "codeqwen1.5-7b": ("codeqwen1.5-7b", {}),
    "phi3.5-moe-42b-a6.6b": ("phi3.5-moe-42b-a6.6b", {}),
    "granite-moe-3b-a800m": ("granite-moe-3b-a800m", {}),
    "granite-moe-g3": ("granite-moe-3b-a800m",
                       dict(num_heads=6, num_kv_heads=2)),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _with_bias(cfg, tree, seed=7):
    """Nonzero seeded q/k/v biases in place of the reference's zeros."""
    if not cfg.attn_bias:
        return tree
    rng = np.random.default_rng(seed)
    for sub in tree["blocks"].values():
        mixer = sub["mixer"]
        for n in ("bq", "bk", "bv"):
            mixer[n] = (0.5 * rng.standard_normal(mixer[n].shape)
                        ).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def models():
    out = {}
    for key, (arch, kw) in MODELS.items():
        cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
        pcfg = dataclasses.replace(port_config(arch).reduced(), **kw)
        tree = jax.tree.map(np.asarray,
                            JM.init_params(cfg, jax.random.PRNGKey(0)))
        out[key] = cfg, pcfg, _with_bias(cfg, tree)
    return out


def _layer(tree, i=0):
    return jax.tree.map(lambda a: a[i], tree["blocks"]["sub0"])


# --- the registry ------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW)
def test_registry_equals_reference_config(arch):
    want = get_config(arch)
    got = port_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.name == want.name and got.source == want.source
    assert dataclasses.asdict(got.reduced()) == \
        dataclasses.asdict(want.reduced())
    assert got.total_params == want.total_params
    assert arch in list_archs()


def test_list_archs_is_the_ported_registry():
    from repro.configs import list_archs as ref_archs
    # every architecture of the reference is ported, whisper-base and
    # paligemma-3b (tests/test_torch_encdec.py) the last; an unknown name
    # raises in both registries
    assert list_archs() == ref_archs()
    for get in (port_config, get_config):
        with pytest.raises(KeyError):
            get("gpt-unknown")


# --- the biased projections on every attention path --------------------------

def _pools(rng, n_blocks, bs, hkv, hd):
    return {n: (0.5 * rng.standard_normal((n_blocks, bs, hkv, hd))
                ).astype(np.float32) for n in ("k", "v")}


def _paths(cfg, rng):
    """(name, reference call, port call) of each attention path on the same
    inputs; each returns the layer's output."""
    d, hkv, hd = cfg.d_model, cfg.num_kv_heads, cfg.head_dim_
    x = (0.5 * rng.standard_normal((2, 9, d))).astype(np.float32)
    x1 = x[:, :1]
    pos9 = np.broadcast_to(np.arange(9), (2, 9)).astype(np.int32)
    cache = {n: (0.5 * rng.standard_normal((2, 16, hkv, hd))
                 ).astype(np.float32) for n in ("k", "v")}
    pools = _pools(rng, 9, 4, hkv, hd)
    tables = np.array([[1, 3, 5, 7], [2, 4, 6, 8]], np.int32)
    pos = np.array([5, 11], np.int32)
    starts = np.array([[4 + j for j in range(9)], [1 + j for j in range(9)]],
                      np.int32)
    q_len = np.array([9, 6], np.int32)

    def jc(c):
        return {n: jnp.asarray(a) for n, a in c.items()}

    def pc(c):
        return {n: _t(a) for n, a in c.items()}

    yield ("prefill",
           lambda p: JL.attn_prefill(p, jnp.asarray(x), cfg,
                                     positions=jnp.asarray(pos9))[0],
           lambda p: PL.attn_prefill(p, _t(x), cfg,
                                     positions=_t(pos9).long())[0])
    yield ("decode",
           lambda p: JL.attn_decode(p, jnp.asarray(x1), cfg,
                                    pos=jnp.asarray(pos), cache=jc(cache))[0],
           lambda p: PL.attn_decode(p, _t(x1), cfg, pos=_t(pos),
                                    cache=pc(cache)))
    yield ("decode_paged",
           lambda p: JL.attn_decode_paged(p, jnp.asarray(x1), cfg,
                                          pos=jnp.asarray(pos),
                                          block_tables=jnp.asarray(tables),
                                          cache=jc(pools))[0],
           lambda p: PL.attn_decode_paged(p, _t(x1), cfg, pos=_t(pos).long(),
                                          block_tables=_t(tables),
                                          cache=pc(pools)))
    for name, jfn, pfn in (("context_paged", JL.attn_context_paged,
                            PL.attn_context_paged),
                           ("verify_paged", JL.attn_verify_paged,
                            PL.attn_verify_paged)):
        yield (name,
               lambda p, jfn=jfn: jfn(p, jnp.asarray(x), cfg,
                                      positions=jnp.asarray(starts),
                                      q_len=jnp.asarray(q_len),
                                      block_tables=jnp.asarray(tables),
                                      cache=jc(pools))[0],
               lambda p, pfn=pfn: pfn(p, _t(x), cfg,
                                      positions=_t(starts).long(),
                                      q_len=_t(q_len).long(),
                                      block_tables=_t(tables),
                                      cache=pc(pools)))


@pytest.mark.parametrize("path", ["prefill", "decode", "decode_paged",
                                  "context_paged", "verify_paged"])
def test_biased_qkv_on_every_attention_path(models, path):
    cfg, pcfg, tree = models["codeqwen1.5-7b"]
    lp = _layer(tree)["mixer"]
    assert all(np.abs(lp[n]).max() > 0 for n in ("bq", "bk", "bv"))
    _, jcall, pcall = next(p for p in _paths(cfg, np.random.default_rng(5))
                           if p[0] == path)
    want = np.asarray(jcall(_j(lp)))
    got = pcall(bridge.params_from_numpy(lp, device="cpu")).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # the path really adds the bias: without it the output moves
    unbiased = {n: np.zeros_like(a) if n in ("bq", "bk", "bv") else a
                for n, a in lp.items()}
    _, _, pcall = next(p for p in _paths(cfg, np.random.default_rng(5))
                       if p[0] == path)
    off = pcall(bridge.params_from_numpy(unbiased, device="cpu")).numpy()
    assert np.abs(off - got).max() > 1e-2


# --- the gelu MLP and expert FFN ---------------------------------------------

def test_gelu_mlp_is_the_tanh_approximation(models):
    cfg, pcfg, tree = models["granite-20b"]
    mlp = _layer(tree)["mlp"]
    assert set(mlp) == {"w_up", "w_down"}            # no gate
    x = np.random.default_rng(1).standard_normal(
        (2, 7, cfg.d_model)).astype(np.float32)
    want = np.asarray(JL.mlp(_j(mlp), jnp.asarray(x), cfg))
    got = PL.mlp(bridge.params_from_numpy(mlp, device="cpu"), _t(x), pcfg)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    h = torch.linspace(-4, 4, 101)
    np.testing.assert_allclose(PL.gelu(h).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(h.numpy()))),
                               atol=1e-6)
    exact = torch.nn.functional.gelu(h)
    assert (exact - PL.gelu(h)).abs().max() > 1e-4


@pytest.mark.parametrize("activation", ["silu", "gelu"])
@pytest.mark.parametrize("key", ["phi3.5-moe-42b-a6.6b",
                                 "granite-moe-3b-a800m"])
def test_moe_expert_ffn_matches_reference(key, activation):
    arch = MODELS[key][0]
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              activation=activation)
    pcfg = dataclasses.replace(port_config(arch).reduced(),
                               activation=activation)
    tree = jax.tree.map(np.asarray, JM.init_params(cfg,
                                                   jax.random.PRNGKey(1)))
    moe = _layer(tree)["moe"]
    assert ("w_gate" in moe) == (activation == "silu")
    for s in (1, 40):               # decode rows, and a prefill that drops
        x = np.random.default_rng(s).standard_normal(
            (3, s, cfg.d_model)).astype(np.float32)
        want = JMoE._moe_grouped(_j(moe), jnp.asarray(x), cfg,
                                 return_aux=False)
        got = PMoE.moe_mlp(bridge.params_from_numpy(moe, device="cpu"),
                           _t(x), pcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --- whole-model prefill and decode ------------------------------------------

@pytest.mark.parametrize("key", sorted(MODELS))
def test_prefill_and_decode_logits_match_reference(models, key):
    cfg, pcfg, tree = models[key]
    b, s = 3, 11
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (b, s),
                                             dtype=np.int32)
    lens = np.array([11, 6, 2], np.int32)
    jl, jc = JM.prefill(cfg, _j(tree), {"tokens": jnp.asarray(toks)},
                        JM.init_cache(cfg, b, s + 2), lens=jnp.asarray(lens))
    params = bridge.params_from_numpy(tree, device="cpu")
    pc = PM.init_cache(pcfg, b, s + 2, device="cpu")
    pl, pc = PM.prefill(pcfg, params, {"tokens": toks}, pc, lens=lens)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    jl2, _ = JM.decode_step(cfg, _j(tree), jnp.asarray(nxt), jc,
                            jnp.asarray(lens))
    pl2, _ = PM.decode_step(pcfg, params, nxt, pc, lens)
    np.testing.assert_allclose(pl2.numpy(), np.asarray(jl2), **TOL)


def test_seeded_init_has_the_reference_layout(models):
    for key in sorted(MODELS):
        cfg, pcfg, tree = models[key]
        got = PM.init_params(pcfg, 0, device="cpu")
        want = jax.tree.map(lambda a: a.shape, tree)
        assert jax.tree.map(lambda t: tuple(t.shape), got) == want, key
    # the port draws the biases the reference leaves at zero
    _, pcfg, _ = models["codeqwen1.5-7b"]
    bq = PM.init_params(pcfg, 0, device="cpu")["blocks"]["sub0"]["mixer"][
        "bq"]
    assert bq.abs().max() > 0


# --- the engines -------------------------------------------------------------

def _synth(mod, vocab):
    return mod.synth_workload(rate=40.0, duration=0.2, vocab=vocab,
                              prompt_len=20, prompt_jitter=8, out_len=5,
                              seed=1)


def _shared(mod, vocab):
    return mod.shared_prefix_workload(rate=40.0, duration=0.2, vocab=vocab,
                                      shared_len=24, unique_len=6,
                                      unique_jitter=3, out_len=5, seed=2)


def _quantized(tree, cfg):
    return jax.tree.map(np.asarray, JQ.quantize_params(_j(tree), cfg))


# (model, workload, engine flags, weights): every served model plainly, and
# the paged features the reference serves on them
SERVES = {
    "granite-20b": ("granite-20b", _synth, {}, None),
    "granite-20b-g48": ("granite-20b-g48", _synth, {}, None),
    "granite-20b-g48-ngram": ("granite-20b-g48", _synth,
                              dict(spec_decode=True, spec_k=4), None),
    "granite-20b-ngram": ("granite-20b", _synth,
                          dict(spec_decode=True, spec_k=4), None),
    "codeqwen1.5-7b": ("codeqwen1.5-7b", _synth, {}, None),
    "codeqwen1.5-7b-prefix": ("codeqwen1.5-7b", _shared,
                              dict(prefix_caching=True, prefill_chunk=16),
                              None),
    "phi3.5-moe-42b-a6.6b": ("phi3.5-moe-42b-a6.6b", _synth, {}, None),
    "phi3.5-moe-42b-a6.6b-w8": ("phi3.5-moe-42b-a6.6b", _synth, {},
                                _quantized),
    "granite-moe-3b-a800m": ("granite-moe-3b-a800m", _synth, {}, None),
    "granite-moe-g3": ("granite-moe-g3", _synth, {}, None),
    "granite-moe-g3-int8-prefix": ("granite-moe-g3", _shared,
                                   dict(kv_dtype="int8",
                                        prefix_caching=True), None),
}


def _weights(models, name):
    key, make, kw, prep = SERVES[name]
    cfg, pcfg, tree = models[key]
    return cfg, pcfg, (prep(tree, cfg) if prep else tree), make, kw


def _jax_serve(cfg, tree, make, kw):
    asg = Assignment([PipelinePlan([StagePlan([0], 1), StagePlan([1], 1)])])
    reqs = make(jreq, cfg.vocab_size)
    stats = JEngine(cfg, asg, params=_j(tree), policy="continuous",
                    cache_layout="paged", n_slots=4, max_len=64,
                    block_size=8, **kw).serve(reqs, deadline=120.0,
                                              clock=JClock())
    return [list(r.output) for r in reqs], stats


def _port_serve(pcfg, tree, make, kw):
    asg = port_plan.Assignment([port_plan.PipelinePlan(
        [port_plan.StagePlan([0], 1), port_plan.StagePlan([1], 1)])])
    reqs = make(preq, pcfg.vocab_size)
    stats = PEngine(pcfg, asg,
                    params=bridge.params_from_numpy(tree, device="cpu"),
                    device="cpu", cache_layout="paged", n_slots=4,
                    max_len=64, block_size=8, **kw).serve(
        reqs, deadline=120.0, clock=PClock())
    return [list(r.output) for r in reqs], stats


@pytest.fixture(scope="module")
def reference_serves(models):
    out = {}
    for name in SERVES:
        cfg, _, tree, make, kw = _weights(models, name)
        out[name] = _jax_serve(cfg, tree, make, kw)
    return out


@pytest.mark.parametrize("name", sorted(SERVES))
def test_port_serves_token_identical_to_reference(models, reference_serves,
                                                  name):
    _, pcfg, tree, make, kw = _weights(models, name)
    (gt, gs), (wt, ws) = _port_serve(pcfg, tree, make, kw), \
        reference_serves[name]
    assert len(gt) == len(wt) > 0
    for i, (a, b) in enumerate(zip(gt, wt)):
        assert a == b, f"request {i}: {a} vs {b}"
    for c in COUNTERS:
        assert getattr(gs, c) == getattr(ws, c), c
    if "ngram" in name:
        assert gs.spec_steps > 0
    if "prefix" in name:
        assert gs.prefix_hits > 0
    if "int8" in name:
        assert gs.kv_bytes_saved > 0
