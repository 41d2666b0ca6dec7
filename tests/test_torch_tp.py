"""Asymmetric tensor x pipeline parallelism of the port against the JAX
package, on the CPU with distinct ``cpu:i`` devices standing for cards (a
tensor on ``cpu:1`` is a CPU tensor; what counts is that the stage takes
two devices as two shards, each with its own weights, heads and pools):

  * ``models.shardings``' split of every leaf of the eleven architectures
    (full and reduced) at TP 1, 2, 4, 8 and 16 against
    ``repro.models.shardings.param_specs`` / ``cache_specs``, on abstract
    shapes (``jax.eval_shape``; the meta device);
  * the reference test's two layouts (``tests/test_serving.py:80-120``:
    [[d0, d1], [d2, d3]] and [[d0..d3], [d0]]) for granite-8b and
    phi3.5-moe reduced: prefill / decode logits within the reference's
    gates (2e-4 / 2e-3) of its single-device ``M.prefill`` /
    ``M.decode_step``, and within 1e-5 of max|logit| of the port's TP 1;
    phi3.5-moe with six experts, whose TP-4 stage splits every expert's
    d_ff; the executor's placed shapes against the tested rules;
    kv heads that do not divide the TP degree (granite-8b at TP 4,
    granite-20b's MQA, a llama-shaped 16 / 2 at TP 8), q/k/v biases,
    bit-repeatable runs;
  * the engine with ``devices=[cpu:0..cpu:3]`` on a TP-2 + TP-1 plan
    serving scripts/smoke_serving.py's serving and prefix workloads on
    paged pools and the serving one on contiguous slots (and on int8
    pages): tokens and every ServeStats field equal
    to the reference engine's;
  * disaggregation between a TP-2 replica and a TP-1 one, both ways:
    tokens equal to the colocated serve's and the reference's;
  * jamba reduced over two shards (the executor and the engine on two
    devices, no warning) and on two TP-1 stages on cpu:0 / cpu:1, all with
    the reference's tokens; danube's ring at TP 2, whisper-base,
    paligemma-3b and xlstm-125m placed by stage; int8 weights, whisper and
    paligemma over two shards with one device's tokens; a bias after a
    row-parallel product added once; MoE's "global" dispatch on expert
    shards (phi3.5-moe on both layouts) against the reference's logits and
    engine. tests/test_torch_tp_families.py holds the other families and
    int8 weights to the reference.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, list_archs
from repro.core.plan import Assignment, PipelinePlan, StagePlan
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.models import shardings as JS
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving.loop import VirtualClock as JClock
from repro.serving.pipeline import AsymmetricPipeline as JPipe
from repro.serving.request import shared_prefix_workload as j_shared
from repro.serving.request import synth_workload as j_synth
from repro_torch import bridge
from repro_torch.configs import get_config as port_config
from repro_torch.core import plan as pplan
from repro_torch.models import model as PM
from repro_torch.models import moe as PMoE
from repro_torch.models import shardings as PS
from repro_torch.serving.engine import InferenceEngine as PEngine
from repro_torch.serving.loop import ServeStats
from repro_torch.serving.loop import VirtualClock as PClock
from repro_torch.serving.pipeline import AsymmetricPipeline
from repro_torch.serving.request import shared_prefix_workload as p_shared
from repro_torch.serving.request import synth_workload as p_synth

from _torch_threads import one_torch_thread  # noqa: F401

CPUS = [torch.device("cpu", i) for i in range(4)]
TPS = (1, 2, 4, 8, 16)


# ---------------------------------------------------------------------------
# The split rules against the reference's, leaf by leaf
# ---------------------------------------------------------------------------

def _model_dim(spec):
    dims = [i for i, a in enumerate(tuple(spec)) if a == "model"]
    return dims[0] if dims else None


def _flat(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, path + (k,)))
        else:
            out[path + (k,)] = v
    return out


def _jflat(specs):
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]
    return {tuple(k.key for k in path): _model_dim(s) for path, s in leaves}


@pytest.mark.parametrize("arch", list_archs())
def test_split_rules_equal_the_reference(arch):
    for reduced in (False, True):
        jcfg, pcfg = get_config(arch), port_config(arch)
        if reduced:
            jcfg, pcfg = jcfg.reduced(), pcfg.reduced()
        jparams = jax.eval_shape(
            lambda: JM.init_params(jcfg, jax.random.PRNGKey(0)))
        pparams = PM.init_params(pcfg, 0, device="meta")
        jcache = jax.eval_shape(lambda: JM.init_cache(jcfg, 2, 16))
        pcache = PM.init_cache(pcfg, 2, 16, device="meta")
        for tp in TPS:
            want = _jflat(JS.param_specs(jcfg, jparams, tp=tp))
            got = _flat(PS.param_splits(pcfg, pparams, tp))
            assert got == want, (arch, reduced, tp)
            assert any(d is not None for d in got.values()) == (tp > 1)
            want = _jflat(JS.cache_specs(jcfg, jcache, tp=tp))
            assert _flat(PS.cache_splits(pcache, tp)) == want, (arch, tp)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_pool_leaves_split_on_the_kv_head_axis(kv_dtype):
    """Paged pools and their scale pools split on the same (kv-head)
    axis, which the executor's shards hold (each its own heads)."""
    cfg = port_config("llama2-70b")
    c = PM.init_layer_paged_cache(cfg, 0, 4, 16, dtype=torch.bfloat16,
                                  device="meta", kv_dtype=kv_dtype)
    for tp in (2, 8):
        split = PS.cache_splits(c, tp)
        assert split["k"] == split["v"] == 2
        if kv_dtype:
            assert split["k_scale"] == split["v_scale"] == 2
    assert PS.cache_splits(c, 16)["k"] is None       # 8 kv heads at TP 16


@pytest.mark.parametrize("arch,tp", [("llama2-70b", 2), ("llama2-70b", 8),
                                     ("llama2-70b", 16), ("granite-20b", 4),
                                     ("granite-8b", 16),
                                     ("granite-8b-reduced", 4)])
def test_each_shard_keeps_the_kv_heads_its_q_heads_read(arch, tp):
    """By global head index: q head h reads kv head h // g; a shard's
    local q head j must read its local kv head j // g_local."""
    cfg = (port_config(arch.replace("-reduced", "")).reduced()
           if arch.endswith("-reduced") else port_config(arch))
    g = cfg.num_heads // cfg.num_kv_heads
    heads = PS.shard_heads(cfg, tp)
    assert [q for q, _ in heads] == [
        (r * cfg.num_heads // tp, (r + 1) * cfg.num_heads // tp)
        for r in range(tp)]
    for (q0, q1), (k0, k1) in heads:
        g_loc = (q1 - q0) // (k1 - k0)
        for j in range(q1 - q0):
            assert (q0 + j) // g == k0 + j // g_loc
        if cfg.num_kv_heads % tp == 0:       # the rules' split
            assert k1 - k0 == cfg.num_kv_heads // tp
    # the group counts the kernels see: llama TP 16 g 4, granite-20b TP 4
    # g 12
    if (arch, tp) == ("llama2-70b", 16):
        assert {(q1 - q0) // (k1 - k0) for (q0, q1), (k0, k1) in heads} \
            == {4}
    if (arch, tp) == ("granite-20b", 4):
        assert heads[0] == ((0, 12), (0, 1))


def test_a_head_never_straddles_shards():
    cfg = port_config("granite-8b").reduced()           # 4 q heads
    with pytest.raises(NotImplementedError, match="query heads"):
        PS.shard_heads(cfg, 8)
    odd = dataclasses.replace(cfg, num_heads=12, num_kv_heads=3,
                              head_dim=16)
    with pytest.raises(NotImplementedError, match="unevenly"):
        PS.shard_heads(odd, 2)


# ---------------------------------------------------------------------------
# Logits: the reference test's layouts
# ---------------------------------------------------------------------------

# reduced configs by name: (architecture, overrides); phi3.5-moe-e6's six
# experts do not divide TP 4, so its TP-4 stage splits every expert's d_ff
MODELS = {"granite-8b": ("granite-8b", {}),
          "phi3.5-moe-42b-a6.6b": ("phi3.5-moe-42b-a6.6b", {}),
          "phi3.5-moe-e6": ("phi3.5-moe-42b-a6.6b", dict(num_experts=6))}


@pytest.fixture(scope="module")
def models():
    """Reduced configs with the port's seeded weights and the reference's
    copies of them (the same tree layout; the reference's own init takes
    seconds here): {name: (jcfg, jparams, pcfg, pparams)}."""
    out = {}
    for name, (arch, kw) in MODELS.items():
        jcfg, pcfg = _variant(arch, **kw)
        pparams = PM.init_params(pcfg, 0, device="cpu")
        out[name] = (jcfg, jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                                        pparams), pcfg, pparams)
    return out


def _toks(cfg):
    return np.random.RandomState(0).randint(0, cfg.vocab_size,
                                            (2, 12)).astype(np.int32)


_REF = {}


def _ref_logits(models, arch):
    """The reference's single-device prefill and decode logits (and the
    decoded tokens), once per architecture."""
    if arch not in _REF:
        jcfg, jparams = models[arch][:2]
        toks = _toks(jcfg)
        lg, cache = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                               JM.init_cache(jcfg, 2, 16))
        nxt = np.asarray(jnp.argmax(lg, -1)).astype(np.int32)
        lg2, _ = JM.decode_step(jcfg, jparams, jnp.asarray(nxt), cache, 12)
        _REF[arch] = (toks, nxt, np.asarray(lg), np.asarray(lg2))
    return _REF[arch]


def _port_logits(cfg, params, stage_layers, stage_devices, toks, nxt):
    pipe = AsymmetricPipeline(cfg, params, stage_layers, stage_devices)
    lg = pipe.prefill(toks, max_new=4)
    return lg, pipe.decode_step(nxt)


LAYOUTS = {"tp2+tp2": [[CPUS[0], CPUS[1]], [CPUS[2], CPUS[3]]],
           "tp4+tp1": [CPUS[:4], [CPUS[0]]]}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", list(MODELS))
def test_tp_logits_match_single_device(models, arch, layout):
    pcfg, pparams = models[arch][2:]
    toks, nxt, lg_ref, lg2_ref = _ref_logits(models, arch)
    L = pcfg.num_layers
    one = _port_logits(pcfg, pparams, [1, L - 1], [[CPUS[0]]] * 2, toks, nxt)
    got = _port_logits(pcfg, pparams, [1, L - 1], LAYOUTS[layout], toks, nxt)
    assert np.abs(got[0] - lg_ref).max() < 2e-4
    assert np.abs(got[1] - lg2_ref).max() < 2e-3
    for a, b in zip(got, one):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    if arch == "phi3.5-moe-e6":
        # which split ran: experts at TP 2, every expert's d_ff at TP 4
        pipe = AsymmetricPipeline(pcfg, pparams, [1, L - 1],
                                  LAYOUTS[layout])
        sh = pipe.stages[0].layer_params[0]["moe"]
        tp = len(LAYOUTS[layout][0])
        assert [s.experts is not None for s in sh] == [tp == 2] * tp
        assert sh[0].params["w_up"].shape[-1] == (
            pcfg.d_ff if tp == 2 else pcfg.d_ff // tp)


@pytest.mark.parametrize("arch,tp", [("granite-8b", 2), ("granite-8b", 4),
                                     ("phi3.5-moe-42b-a6.6b", 4),
                                     ("phi3.5-moe-e6", 4),
                                     ("granite-20b", 4)])
def test_executor_shards_follow_the_tested_rules(models, arch, tp):
    """The shapes the executor places, leaf by leaf and pool by pool, are
    the ones ``param_splits`` / ``cache_splits`` give (the rules held to
    the reference above): a split leaf's 1/tp on each shard, a leaf they
    replicate whole, except the kv leaves and pools of kv heads that do
    not divide tp, which hold the shard's ``shard_heads`` kv range."""
    if arch in models:
        pcfg, pparams = models[arch][2:]
    else:
        pcfg = _variant(arch)[1]
        pparams = PM.init_params(pcfg, 0, device="cpu")
    devs = [torch.device("cpu", i) for i in range(tp)]
    pipe = AsymmetricPipeline(pcfg, pparams, [pcfg.num_layers], [devs])
    pipe.init_paged_caches(2, 16, block_size=4, stage_blocks=[6])
    splits = _flat(PS.param_splits(pcfg, pparams, tp))
    hd = pcfg.head_dim_
    heads = PS.shard_heads(pcfg, tp)
    st = pipe.stages[0]
    for i, lp in enumerate(st.layer_params):
        j = PM.layer_sub_index(pcfg, i)[1]
        whole = PM.slice_layer_params(pcfg, pparams, i)
        for sub, leaves in whole.items():
            placed = lp[sub]
            for n, t in leaves.items():
                d = splits[("blocks", f"sub{j}", sub, n)]
                if not isinstance(placed, PM.Shards):
                    assert d is None and placed[n].shape == t.shape, (sub, n)
                    continue
                for s, ((q0, q1), (k0, k1)) in zip(placed, heads):
                    want = list(t.shape)
                    if d is not None:
                        want[d - 1] //= tp
                    elif n in PS.KV_LEAVES:
                        want[PS.HEAD_AXIS[n]] = (k1 - k0) * hd
                    assert list(s.params[n].shape) == want, (sub, n, d)
                    assert s.params[n].is_contiguous()
        pool = PM.init_layer_paged_cache(pcfg, i, 6, 4, device="cpu",
                                         dtype=torch.float32)
        csplit = PS.cache_splits(pool, tp)
        for c, ((q0, q1), (k0, k1)) in zip(pipe.paged_caches[0][i], heads):
            for n in ("k", "v"):
                want = list(pool[n].shape)
                d = csplit[n]
                want[2] = (want[2] // tp if d is not None else k1 - k0)
                assert d in (None, 2) and list(c[n].shape) == want, n


def _variant(arch, **kw):
    return (dataclasses.replace(get_config(arch).reduced(), **kw),
            dataclasses.replace(port_config(arch).reduced(), **kw))


@pytest.mark.parametrize("name,tp", [("granite-20b-mqa", 4),
                                     ("llama-16q-2kv", 8),
                                     ("codeqwen-bias", 2)])
def test_uneven_kv_heads_and_biases_match(name, tp):
    """kv heads that do not divide the TP degree (granite-20b's one kv
    head on four shards: g 4 each; 16 q / 2 kv heads on eight shards:
    g 2 each, kv head r // 4) and column-parallel q/k/v biases, against
    the reference's single-device prefill; a second run gives the same
    bits (the shards' outputs sum in a fixed order)."""
    if name == "granite-20b-mqa":
        jcfg, pcfg = _variant("granite-20b")
    elif name == "llama-16q-2kv":
        jcfg, pcfg = _variant("llama2-70b", num_heads=16, num_kv_heads=2)
    else:
        jcfg, pcfg = _variant("codeqwen1.5-7b")
    # the port's seeded weights, through the bridge
    tree = jax.tree.map(lambda t: t.numpy(),
                        PM.init_params(pcfg, 1, device="cpu"))
    if pcfg.attn_bias:          # the biases start at zero
        rng = np.random.RandomState(0)
        for leaf in tree["blocks"]["sub0"]["mixer"]:
            if leaf.startswith("b"):
                a = tree["blocks"]["sub0"]["mixer"][leaf]
                tree["blocks"]["sub0"]["mixer"][leaf] = (
                    0.5 * rng.standard_normal(a.shape)).astype(a.dtype)
    pparams = bridge.params_from_numpy(tree, device="cpu")
    toks = _toks(jcfg)
    lg_ref, _ = JM.prefill(jcfg, jax.tree.map(jnp.asarray, tree),
                           {"tokens": jnp.asarray(toks)},
                           JM.init_cache(jcfg, 2, 16))
    L = pcfg.num_layers
    devs = [torch.device("cpu", i) for i in range(tp)]
    pipe = AsymmetricPipeline(pcfg, pparams, [L], [devs])
    lg = pipe.prefill(toks, max_new=4)
    assert np.abs(lg - np.asarray(lg_ref)).max() < 2e-4
    assert np.array_equal(pipe.prefill(toks, max_new=4), lg)
    # each shard holds its own heads: the kv heads its q heads read
    sh = pipe.stages[0].layer_params[0]["mixer"]
    assert len(sh) == tp
    hd = pcfg.head_dim_
    for s, ((q0, q1), (k0, k1)) in zip(sh, PS.shard_heads(pcfg, tp)):
        assert s.params["wq"].shape[1] == (q1 - q0) * hd
        assert s.params["wk"].shape[1] == (k1 - k0) * hd == \
            s.cfg.num_kv_heads * hd
        assert s.kv_heads == (k0, k1)


def test_a_row_parallel_bias_is_added_once():
    """A bias after a row-parallel product (``bo`` after wo, ``b_down``
    after w_down: no registered architecture has one) is replicated by
    the rules and added once, to the shards' sum, on the first device: two
    shards give one device's logits, which the bias moves."""
    cfg = port_config("granite-8b").reduced()
    params = PM.init_params(cfg, 0, device="cpu")
    toks = _toks(cfg)
    L = cfg.num_layers
    plain = AsymmetricPipeline(cfg, params, [L], device="cpu").prefill(
        toks, max_new=4)
    rng = np.random.RandomState(3)
    sub = params["blocks"]["sub0"]
    for leaf, (w, bias) in (("mixer", ("wo", "bo")),
                            ("mlp", ("w_down", "b_down"))):
        sub[leaf][bias] = torch.from_numpy(rng.standard_normal(
            (L, cfg.d_model)).astype(np.float32))
    one = AsymmetricPipeline(cfg, params, [L], device="cpu").prefill(
        toks, max_new=4)
    pipe = AsymmetricPipeline(cfg, params, [L], [CPUS[:2]])
    two = pipe.prefill(toks, max_new=4)
    assert np.abs(one - plain).max() > 1e-2           # the biases count
    assert np.abs(two - one).max() <= 1e-5 * np.abs(one).max()
    lp = pipe.stages[0].layer_params[0]
    for leaf, bias in (("mixer", "bo"), ("mlp", "b_down")):
        assert set(lp[leaf].whole) == {bias}
        assert all(bias not in s.params for s in lp[leaf])


# ---------------------------------------------------------------------------
# The engine on four CPU devices
# ---------------------------------------------------------------------------

def _asg(mod, stages):
    A, Pp, S = mod
    return A([Pp([S(list(ids), n) for ids, n in replica], cost=0.1,
                 bottleneck=0.1) for replica in stages])


JMOD = (Assignment, PipelinePlan, StagePlan)
PMOD = (pplan.Assignment, pplan.PipelinePlan, pplan.StagePlan)


def _same(jreqs, preqs, jstats, pstats):
    assert len(jreqs) == len(preqs) > 0
    for a, b in zip(jreqs, preqs):
        assert a.output is not None and len(a.output) == a.max_new_tokens
        assert list(b.output) == list(a.output), a.rid
    for f in dataclasses.fields(ServeStats):
        assert getattr(pstats, f.name) == getattr(jstats, f.name), f.name


def _serving(gen, V):                    # scripts/smoke_serving.py:144
    return gen[0](rate=40.0, duration=0.25, vocab=V, prompt_len=8,
                  prompt_jitter=5, out_len=4, seed=1)


def _prefix(gen, V):                     # scripts/smoke_serving.py:169
    return gen[1](rate=4.0, duration=2.0, vocab=V, shared_len=24,
                  unique_len=6, out_len=4, seed=3)


PAGED = dict(policy="continuous", n_slots=4, max_len=48,
             cache_layout="paged", block_size=8)
WORKLOADS = {
    "serving": (PAGED, _serving),
    "prefix": (dict(PAGED, prefix_caching=True, prefill_chunk=16), _prefix),
    "serving-contiguous": (dict(PAGED, cache_layout="contiguous"), _serving),
}
ASYM = [[([0, 1], 1), ([2], "rest")]]          # one TP-2 and one TP-1 stage


def _stages(plan, L):
    """"rest": the layers the replica's other stages leave."""
    out = []
    for rep in plan:
        fixed = sum(n for _, n in rep if n != "rest")
        out.append([(ids, L - fixed if n == "rest" else n) for ids, n in rep])
    return out


_SERVES = {}


def _ref_serve(models, workload):
    """The reference engine's serve of a smoke workload on the TP-2 +
    TP-1 plan (one JAX device: its TP groups collapse), once."""
    if workload not in _SERVES:
        jcfg, jparams = models["granite-8b"][:2]
        kw, make = WORKLOADS[workload]
        reqs = make((j_synth, j_shared), jcfg.vocab_size)
        eng = JEngine(jcfg, _asg(JMOD, _stages(ASYM, jcfg.num_layers)),
                      params=jparams, **kw)
        _SERVES[workload] = (reqs, eng.serve(reqs, deadline=1e9,
                                             clock=JClock()))
    return _SERVES[workload]


def _port_serve(models, plan, workload, devices=CPUS, **kw):
    pcfg, pparams = models["granite-8b"][2:]
    base, make = WORKLOADS[workload]
    reqs = make((p_synth, p_shared), pcfg.vocab_size)
    eng = PEngine(pcfg, _asg(PMOD, _stages(plan, pcfg.num_layers)),
                  params=pparams, devices=devices, **base, **kw)
    return reqs, eng.serve(reqs, deadline=1e9, clock=PClock()), eng


@pytest.mark.parametrize("workload", list(WORKLOADS))
def test_engine_on_four_devices_equals_the_reference(models, workload):
    jreqs, jstats = _ref_serve(models, workload)
    preqs, pstats, pe = _port_serve(models, ASYM, workload)
    _same(jreqs, preqs, jstats, pstats)
    assert pe.replicas[0].describe_devices() == [["cpu:0", "cpu:1"],
                                                ["cpu:2"]]
    if workload == "prefix":
        assert pstats.prefix_hits > 0
    rep = pe.replicas[0]
    caches = (rep.slot_caches if workload.endswith("contiguous")
              else rep.paged_caches)[0][0]            # TP-2 stage, layer 0
    assert isinstance(caches, PM.Shards) and len(caches) == 2
    for c in caches:       # one of granite-8b reduced's two kv heads each
        assert c["k"].shape[-2] == 1


# the reference test's layouts as engine plans over cpu:0..3 (id 4 is
# cpu:0 again): [[d0, d1], [d2, d3]] and [[d0..d3], [d0]], one layer on
# the first stage
GLOBAL_PLANS = {"tp2+tp2": [[([0, 1], 1), ([2, 3], "rest")]],
                "tp4+tp1": [[([0, 1, 2, 3], 1), ([4], "rest")]]}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_global_dispatch_on_expert_shards_matches_the_reference(
        models, layout, monkeypatch):
    """MOE_DISPATCH "global" in both packages (the reference takes
    _moe_global on any stage and lets GSPMD split it): phi3.5-moe reduced
    with its four experts split two or one a shard, each shard ranking
    over all of them. Prefill and decode logits within the reference's
    gates of its one-device ``M.prefill`` / ``M.decode_step``, and the
    engine on the layout's plan (paged) the reference engine's tokens and
    ServeStats."""
    monkeypatch.setattr(JMoE, "MOE_DISPATCH", "global")
    monkeypatch.setattr(PMoE, "MOE_DISPATCH", "global")
    arch = "phi3.5-moe-42b-a6.6b"
    jcfg, jparams, pcfg, pparams = models[arch]
    if "global" not in _REF:
        toks = _toks(jcfg)
        lg, cache = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                               JM.init_cache(jcfg, 2, 16))
        nxt = np.asarray(jnp.argmax(lg, -1)).astype(np.int32)
        lg2, _ = JM.decode_step(jcfg, jparams, jnp.asarray(nxt), cache, 12)
        reqs = _serving((j_synth, j_shared), jcfg.vocab_size)
        plan = _stages(GLOBAL_PLANS[layout], jcfg.num_layers)
        stats = JEngine(jcfg, _asg(JMOD, plan), params=jparams,
                        **PAGED).serve(reqs, deadline=1e9, clock=JClock())
        _REF["global"] = (toks, nxt, np.asarray(lg), np.asarray(lg2), reqs,
                          stats)
    toks, nxt, lg_ref, lg2_ref, jreqs, jstats = _REF["global"]
    L = pcfg.num_layers
    pipe = AsymmetricPipeline(pcfg, pparams, [1, L - 1], LAYOUTS[layout])
    sh = pipe.stages[0].layer_params[0]["moe"]
    tp = len(LAYOUTS[layout][0])
    n = pcfg.num_experts // tp
    assert [s.experts for s in sh] == [(r * n, n) for r in range(tp)]
    assert np.abs(pipe.prefill(toks, max_new=4) - lg_ref).max() < 2e-4
    assert np.abs(pipe.decode_step(nxt) - lg2_ref).max() < 2e-3
    preqs = _serving((p_synth, p_shared), pcfg.vocab_size)
    eng = PEngine(pcfg, _asg(PMOD, _stages(GLOBAL_PLANS[layout], L)),
                  params=pparams, devices=CPUS, **PAGED)
    pstats = eng.serve(preqs, deadline=1e9, clock=PClock())
    assert eng.replicas[0].describe_devices() == [
        [str(d) for d in s] for s in LAYOUTS[layout]]
    _same(jreqs, preqs, jstats, pstats)


def test_quantized_pools_split_with_their_scales(models):
    """int8 pages on the TP-2 + TP-1 plan: each shard's payload and scale
    pools hold its kv head; tokens and every ServeStats field equal the
    port's serve on one device (whose int8 pages the other CPU tests hold
    to the reference's)."""
    one = _port_serve(models, ASYM, "serving", devices=CPUS[:1],
                      kv_dtype="int8")
    preqs, pstats, pe = _port_serve(models, ASYM, "serving",
                                    kv_dtype="int8")
    _same(one[0], preqs, one[1], pstats)
    for c in pe.replicas[0].paged_caches[0][0]:
        assert c["k"].dtype == torch.int8 and c["k"].shape[2] == 1
        assert c["k_scale"].shape == c["k"].shape[:3]


@pytest.mark.parametrize("roles", [["prefill", "decode"],
                                   ["decode", "prefill"]],
                         ids=["tp2-to-tp1", "tp1-to-tp2"])
def test_disaggregation_across_tp_degrees(models, roles):
    """Replica 0 a TP-2 + TP-1 pipeline, replica 1 one TP-1 stage: pages
    leave one replica with every kv head gathered from its shards and land
    split by the other's rule. Tokens equal the colocated serve's and the
    reference's (its colocated serve of the same workload); every
    ServeStats field equals the same disaggregated serve on one device."""
    plan = ASYM + [[([3], "rest")]]
    if "colocated" not in _SERVES:
        _SERVES["colocated"] = _port_serve(models, plan, "serving")[0]
    creqs = _SERVES["colocated"]
    one = _port_serve(models, plan, "serving", devices=CPUS[:1],
                      roles=roles)
    preqs, pstats, _ = _port_serve(models, plan, "serving", roles=roles)
    _same(one[0], preqs, one[1], pstats)
    assert pstats.migrations == len(preqs) > 0
    jreqs, _ = _ref_serve(models, "serving")
    for a, b, c in zip(jreqs, preqs, creqs):
        assert list(b.output) == list(c.output) == list(a.output), a.rid


def test_engine_devices_and_key():
    """devices defaults to the visible ones of device's type (the one
    CPU); a plan's ids map onto devices[d % len(devices)] and duplicates
    collapse; key seeds the weights."""
    cfg = port_config("granite-8b").reduced()
    L = cfg.num_layers
    asg = _asg(PMOD, [[([0, 1, 2], 1), ([5], L - 1)]])
    eng = PEngine(cfg, asg, device="cpu")
    assert eng.replicas[0].describe_devices() == [["cpu"], ["cpu"]]
    eng = PEngine(cfg, asg, devices=["cpu:0", "cpu:1"], key=3)
    assert eng.replicas[0].describe_devices() == [["cpu:0", "cpu:1"],
                                                ["cpu:1"]]
    want = PM.init_params(cfg, 3, device="cpu")["embed"]
    assert torch.equal(eng.replicas[0].stages[0].head_params["embed"], want)


# ---------------------------------------------------------------------------
# What the slice leaves out, and pipeline placement of every family
# ---------------------------------------------------------------------------

def test_jamba_runs_over_two_shards_and_by_stage():
    """The executor runs jamba's stage over two shards, and the engine on
    two devices runs a plan's TP-2 jamba stage as two shards on them, with
    no warning; both, and two TP-1 stages on cpu:0 / cpu:1, generate the
    reference's tokens."""
    jcfg = get_config("jamba-v0.1-52b").reduced()
    pcfg = port_config("jamba-v0.1-52b").reduced()
    L = pcfg.num_layers
    # the port's seeded weights, shared with the reference (the same tree
    # layout; the reference's own init takes seconds to trace here)
    pparams = PM.init_params(pcfg, 0, device="cpu")
    tree = jax.tree.map(lambda t: t.numpy(), pparams)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        eng = PEngine(pcfg, _asg(PMOD, [[([0, 1], L)]]), params=pparams,
                      devices=CPUS[:2])
    assert eng.replicas[0].describe_devices() == [["cpu:0", "cpu:1"]]
    assert isinstance(eng.replicas[0].stages[0].layer_params[0]["mixer"],
                      PM.Shards)
    toks = np.random.RandomState(0).randint(
        0, pcfg.vocab_size, (3, 9)).astype(np.int32)
    want = np.asarray(JPipe(jcfg, jax.tree.map(jnp.asarray, tree), [L],
                            [jax.devices()[:1]]).generate(toks, max_new=4))
    for split, sd in (([L], [CPUS[:2]]), ([1, L - 1], [CPUS[:1],
                                                      CPUS[1:2]])):
        pipe = AsymmetricPipeline(pcfg, pparams, split, sd)
        assert pipe.describe_devices() == [[str(d) for d in s] for s in sd]
        assert np.array_equal(pipe.generate(toks, max_new=4), want)
    assert np.array_equal(np.stack(eng.generate(list(toks), max_new=4)),
                          want)


@pytest.mark.parametrize("arch,tp", [("h2o-danube-1.8b", 2),
                                     ("whisper-base", 1),
                                     ("paligemma-3b", 1),
                                     ("xlstm-125m", 1)])
def test_every_family_places_its_stages_on_devices(arch, tp):
    """Static batching over [1, L - 1] stages on separate devices (cpu:0,
    then cpu:1 / cpu:2..; danube's sliding-window ring over two shards a
    stage, whisper's encoder output and paligemma's image prefix moving
    with the activations) gives the one-device pipeline's tokens, which
    the other CPU tests hold to the reference's."""
    cfg = port_config(arch).reduced()
    L = cfg.num_layers
    params = PM.init_params(cfg, 0, device="cpu")
    rng = np.random.RandomState(0)
    s = 80 if cfg.swa_window else 6      # past danube's 64-key window
    toks = rng.randint(1, cfg.vocab_size, (3, s)).astype(np.int32)
    kv_start = np.array([0, 2, 5], np.int32)
    extras = {}
    if cfg.is_encoder_decoder:
        extras["enc_frames"] = rng.standard_normal(
            (3, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    if cfg.num_image_tokens:
        extras["image_embeds"] = rng.standard_normal(
            (3, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    want = AsymmetricPipeline(cfg, params, [L], device="cpu").generate(
        toks, max_new=4, kv_start=kv_start, batch_extras=extras)
    pipe = AsymmetricPipeline(cfg, params, [1, L - 1],
                              [CPUS[:tp], CPUS[tp:2 * tp]])
    got = pipe.generate(toks, max_new=4, kv_start=kv_start,
                        batch_extras=extras)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("what", ["quantize", "whisper", "paligemma"])
def test_int8_and_encdec_run_over_two_shards(what):
    """int8 weights, whisper-base and paligemma-3b over two shards a
    stage: the same tokens as one device (tests/test_torch_tp_families.py
    holds their logits to the reference's), each shard holding its half of
    the heads."""
    arch = {"quantize": "granite-8b", "whisper": "whisper-base",
            "paligemma": "paligemma-3b"}[what]
    cfg = port_config(arch).reduced()
    params = PM.init_params(cfg, 0, device="cpu")
    if what == "quantize":
        from repro_torch.models.quant import quantize_params
        params = quantize_params(params)
    rng = np.random.RandomState(0)
    toks = rng.randint(1, cfg.vocab_size, (3, 6)).astype(np.int32)
    extras = {}
    if cfg.is_encoder_decoder:
        extras["enc_frames"] = rng.standard_normal(
            (3, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    if cfg.num_image_tokens:
        extras["image_embeds"] = rng.standard_normal(
            (3, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    L = cfg.num_layers
    want = AsymmetricPipeline(cfg, params, [L], device="cpu").generate(
        toks, max_new=4, batch_extras=extras)
    pipe = AsymmetricPipeline(cfg, params, [L], [CPUS[:2]])
    assert np.array_equal(pipe.generate(toks, max_new=4,
                                        batch_extras=extras), want)
    sh = pipe.stages[0].layer_params[0]["mixer"]
    assert [s.cfg.num_heads for s in sh] == [cfg.num_heads // 2] * 2
