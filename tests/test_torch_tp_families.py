"""Tensor parallelism of every family and of int8 weights in the port
against the JAX package, on the CPU with distinct ``cpu:i`` devices
standing for cards:

  * the reference test's two layouts (``tests/test_serving.py:80-120``:
    [[d0, d1], [d2, d3]] and [[d0..d3], [d0]] over [1, L - 1] stages) for
    jamba-v0.1-52b (Mamba, MoE and attention), xlstm-125m (mLSTM and
    sLSTM), whisper-base (cross-attention, the encoder) and paligemma-3b
    (the image prefix, one kv head) reduced, with seeded noise on every
    norm leaf: prefill and decode logits within the reference's gates
    (2e-4 / 2e-3) of its single-device ``M.prefill`` / ``M.decode_step``,
    within 1e-5 of max|logit| of the port's TP 1, and ``generate``'s
    tokens equal to the reference's greedy ones;
  * the engine with ``devices=[cpu:0..cpu:3]`` on plans with TP-2 stages
    serving jamba and xlstm-125m: tokens and every ServeStats field equal
    to the reference engine's (paged) and to the port's one-device serve
    (contiguous slots), with no warning;
  * int8 weights (``quantize=True``: granite-8b, phi3.5-moe's expert
    split, a six-expert variant's d_ff split, jamba) at TP 2 and 4:
    logits against the reference's quantized single device, the engine's
    smoke workload with the reference engine's tokens, and each shard's
    slice of every ``q`` and ``s`` (``shardings.quant_split``); ROADMAP.md
    F9, the reference's rules replicating them;
  * the Mamba / mLSTM up-projection's two halves: a shard's xi and z are
    the whole layer's at its din slice.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.plan import Assignment, PipelinePlan, StagePlan
from repro.models import model as JM
from repro.models import quant as JQ
from repro.models import shardings as JS
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving.loop import VirtualClock as JClock
from repro.serving.request import synth_workload as j_synth
from repro_torch import bridge
from repro_torch.configs import get_config as port_config
from repro_torch.core import plan as pplan
from repro_torch.models import mamba as PMamba
from repro_torch.models import model as PM
from repro_torch.models import shardings as PS
from repro_torch.models.quant import quantize_params
from repro_torch.serving.engine import InferenceEngine as PEngine
from repro_torch.serving.loop import ServeStats
from repro_torch.serving.loop import VirtualClock as PClock
from repro_torch.serving.pipeline import AsymmetricPipeline
from repro_torch.serving.request import synth_workload as p_synth

from _torch_threads import one_torch_thread  # noqa: F401

CPUS = [torch.device("cpu", i) for i in range(4)]
LAYOUTS = {"tp2+tp2": [[CPUS[0], CPUS[1]], [CPUS[2], CPUS[3]]],
           "tp4+tp1": [CPUS[:4], [CPUS[0]]]}
PREFILL_ATOL, DECODE_ATOL = 2e-4, 2e-3     # tests/test_serving.py:24-50
FAMILIES = ("jamba-v0.1-52b", "xlstm-125m", "whisper-base", "paligemma-3b")
NEW = 3


def _variant(arch, **kw):
    return (dataclasses.replace(get_config(arch).reduced(), **kw),
            dataclasses.replace(port_config(arch).reduced(), **kw))


def _perturb(tree, rng, name=""):
    """Seeded noise on every norm leaf (scale w, bias b): the reference's
    LayerNorm biases are zero and its scales one."""
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, name if name.startswith(("ln", "final"))
                            else k) for k, v in tree.items()}
    if name.startswith(("ln", "final")):
        return (tree + 0.1 * rng.standard_normal(tree.shape)).astype(
            tree.dtype)
    return tree


def _batch(cfg, b=2, s=12, seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)
    extras = {}
    if cfg.is_encoder_decoder:
        extras["enc_frames"] = rng.standard_normal(
            (b, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    if cfg.num_image_tokens:
        extras["image_embeds"] = rng.standard_normal(
            (b, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    return toks, extras


def _reference(jcfg, jparams, toks, extras, new=NEW):
    """The reference's single-device prefill logits, first decode logits
    and `new` (at least 2) greedy tokens."""
    b, s = toks.shape
    total = s + jcfg.num_image_tokens
    batch = {"tokens": jnp.asarray(toks),
             **{k: jnp.asarray(v) for k, v in extras.items()}}
    lg, cache = JM.prefill(jcfg, jparams, batch,
                           JM.init_cache(jcfg, b, total + new))
    lg = np.asarray(lg)
    out, lgs = [], [lg]
    for step in range(new):
        nxt = lgs[-1].argmax(-1).astype(np.int32)
        out.append(nxt)
        if step + 1 < new:
            l2, cache = JM.decode_step(jcfg, jparams, jnp.asarray(nxt), cache,
                                       total + step)
            lgs.append(np.asarray(l2))
    return lg, lgs[1], np.stack(out, axis=1)


@pytest.fixture(scope="module")
def families():
    """{arch: (jcfg, pcfg, port params, toks, extras, reference prefill
    logits, decode logits, greedy tokens)}: the port's seeded weights with
    perturbed norms, shared with the reference through numpy."""
    out = {}
    for arch in FAMILIES:
        jcfg, pcfg = _variant(arch)
        tree = _perturb(bridge.params_to_numpy(
            PM.init_params(pcfg, 0, device="cpu")), np.random.RandomState(7))
        toks, extras = _batch(pcfg)
        out[arch] = (jcfg, pcfg, bridge.params_from_numpy(tree, device="cpu"),
                     toks, extras,
                     *_reference(jcfg, jax.tree.map(jnp.asarray, tree), toks,
                                 extras))
    return out


def _port(pcfg, params, stage_devices, toks, extras):
    L = pcfg.num_layers
    pipe = AsymmetricPipeline(pcfg, params, [1, L - 1], stage_devices)
    lg = pipe.prefill(toks, max_new=NEW, batch_extras=extras)
    lg2 = pipe.decode_step(lg.argmax(-1).astype(np.int32))
    gen = pipe.generate(toks, max_new=NEW, batch_extras=extras)
    return pipe, lg, lg2, gen


_ONE = {}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_tp_logits_match_single_device(families, arch, layout):
    jcfg, pcfg, params, toks, extras, lg_ref, lg2_ref, gen_ref = \
        families[arch]
    if arch not in _ONE:
        _ONE[arch] = _port(pcfg, params, [[CPUS[0]]] * 2, toks, extras)[1:]
    one = _ONE[arch]
    pipe, *got = _port(pcfg, params, LAYOUTS[layout], toks, extras)
    assert np.abs(got[0] - lg_ref).max() < PREFILL_ATOL
    assert np.abs(got[1] - lg2_ref).max() < DECODE_ATOL
    for a, b in zip(got[:2], one[:2]):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    np.testing.assert_array_equal(got[2], gen_ref)
    np.testing.assert_array_equal(one[2], gen_ref)
    # what ran as shards: the first stage's mixer, its cross-attention and
    # FFN over tp devices, an sLSTM layer whole on the first
    st = pipe.stages[0]
    tp = len(LAYOUTS[layout][0])
    lp = st.layer_params[0]
    assert isinstance(lp["mixer"], PM.Shards) and len(lp["mixer"]) == tp
    for name in ("xattn", "mlp", "moe"):
        if name in lp:
            assert isinstance(lp[name], PM.Shards), name
    for kind, lp in zip(pipe.stages[1].kinds, pipe.stages[1].layer_params):
        assert isinstance(lp["mixer"], PM.Shards) == (
            kind != "slstm" and len(LAYOUTS[layout][1]) > 1), kind


def test_shard_state_and_caches_live_per_shard(families):
    """jamba's Mamba state splits its din over the shards (conv (n, w-1,
    din / tp), h (n, din / tp, ds)) on their devices; xlstm's mLSTM state
    stays whole beside its cell on the first; whisper's cross K/V hold
    each shard's kv heads."""
    for arch, tp in (("jamba-v0.1-52b", 4), ("xlstm-125m", 2),
                     ("whisper-base", 2)):
        pcfg, params = families[arch][1:3]
        pipe = AsymmetricPipeline(pcfg, params, [pcfg.num_layers],
                                  [CPUS[:tp]])
        caches = pipe.stages[0].make_caches(3, 24)
        for kind, c in zip(pipe.stages[0].kinds, caches):
            if kind == "mamba":
                din = PMamba.d_inner(pcfg)
                assert [x["conv"].shape[-1] for x in c] == [din // tp] * tp
                assert [x["h"].shape[1:] for x in c] == [
                    (din // tp, pcfg.ssm_d_state)] * tp
            elif kind == "mlstm":
                assert not isinstance(c, PM.Shards)
                assert c["C"].shape[1] == pcfg.num_heads
            elif pcfg.is_encoder_decoder:
                assert [x["cross_k"].shape[2] for x in c] == \
                    [pcfg.num_kv_heads // tp] * tp


@pytest.mark.parametrize("kind", ["mamba", "mlstm"])
def test_up_projection_halves_cut_per_shard(families, kind):
    """in_proj / w_up is [xi | z]: shard r's columns are [r n, (r + 1) n)
    of each half (n = din / tp), so its xi and z are the whole layer's at
    its din slice; a contiguous column cut would give shard 0 all of xi."""
    arch = "jamba-v0.1-52b" if kind == "mamba" else "xlstm-125m"
    pcfg, params = families[arch][1:3]
    i = [pcfg.layer_kind(j) for j in range(pcfg.num_layers)].index(kind)
    lp = PM.slice_layer_params(pcfg, params, i)
    name = "in_proj" if kind == "mamba" else "w_up"
    x = torch.from_numpy(np.random.RandomState(1).standard_normal(
        (2, 5, pcfg.d_model)).astype(np.float32))
    xi, z = (x @ lp["mixer"][name]).chunk(2, dim=-1)
    din = xi.shape[-1]
    for tp in (2, 4):
        sh = PM.shard_layer_params(pcfg, lp, i, CPUS[:tp],
                                   lambda t, d: t)["mixer"]
        n = din // tp
        for r, s in enumerate(sh):
            w = s.params[name]
            assert torch.equal(w, torch.cat(
                [lp["mixer"][name][:, r * n:(r + 1) * n],
                 lp["mixer"][name][:, din + r * n:din + (r + 1) * n]], 1))
            xr, zr = (x @ w).chunk(2, dim=-1)
            torch.testing.assert_close(xr, xi[..., r * n:(r + 1) * n],
                                       rtol=0, atol=1e-6)
            torch.testing.assert_close(zr, z[..., r * n:(r + 1) * n],
                                       rtol=0, atol=1e-6)
            if kind == "mamba":
                assert s.d_inner == n


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

def _asg(mod, stages):
    A, Pp, S = mod
    return A([Pp([S(list(ids), n) for ids, n in stages], cost=0.1,
                 bottleneck=0.1)])


JMOD = (Assignment, PipelinePlan, StagePlan)
PMOD = (pplan.Assignment, pplan.PipelinePlan, pplan.StagePlan)
ENGINE = dict(policy="continuous", n_slots=4, max_len=48, block_size=8)
# (the TP stages' layers: jamba's Mamba and its attention + MoE layer;
# xlstm's mLSTM layers and its sLSTM layer whole on a TP stage's first
# shard)
PLANS = {"jamba-v0.1-52b": [([0, 1], 2), ([2], 2)],
         "xlstm-125m": [([0, 1], 1), ([2, 3], 3)]}
DEVICES = {"jamba-v0.1-52b": [["cpu:0", "cpu:1"], ["cpu:2"]],
           "xlstm-125m": [["cpu:0", "cpu:1"], ["cpu:2", "cpu:3"]]}


def _reqs(synth, V):                     # scripts/smoke_serving.py:144
    return synth(rate=40.0, duration=0.25, vocab=V, prompt_len=8,
                 prompt_jitter=5, out_len=4, seed=1)


def _same(jreqs, preqs, jstats, pstats):
    assert len(jreqs) == len(preqs) > 0
    for a, b in zip(jreqs, preqs):
        assert a.output is not None and len(a.output) == a.max_new_tokens
        assert list(b.output) == list(a.output), a.rid
    for f in dataclasses.fields(ServeStats):
        assert getattr(pstats, f.name) == getattr(jstats, f.name), f.name


def _port_serve(pcfg, params, plan, devices, layout, **kw):
    reqs = _reqs(p_synth, pcfg.vocab_size)
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # no placement, no fallback
        eng = PEngine(pcfg, _asg(PMOD, plan), params=params, devices=devices,
                      cache_layout=layout, **ENGINE, **kw)
    return reqs, eng.serve(reqs, deadline=1e9, clock=PClock()), eng


# the layout each architecture's serve is held to the reference engine's
# on (the other against the port's one-device serve, which
# tests/test_torch_hybrid.py and test_torch_xlstm.py hold to the
# reference's): the cheaper reference serve of each
REF_LAYOUT = {"jamba-v0.1-52b": "contiguous", "xlstm-125m": "paged"}


@pytest.mark.parametrize("arch", list(PLANS))
def test_engine_serves_the_reference_tokens_over_shards(families, arch):
    """Tokens and every ServeStats field equal to the reference engine's
    on the same plan (one JAX device: its TP groups collapse) in one
    layout, and to the port's one-device serve in the other (paged /
    contiguous slots); the stages' devices as the plan maps them."""
    jcfg, pcfg, params = families[arch][:3]
    plan = PLANS[arch]
    jreqs = _reqs(j_synth, jcfg.vocab_size)
    jeng = JEngine(jcfg, _asg(JMOD, plan), params=jax.tree.map(
        jnp.asarray, bridge.params_to_numpy(params)),
        cache_layout=REF_LAYOUT[arch], **ENGINE)
    jstats = jeng.serve(jreqs, deadline=1e9, clock=JClock())
    for layout in ("paged", "contiguous"):
        want = ((jreqs, jstats) if layout == REF_LAYOUT[arch] else
                _port_serve(pcfg, params, plan, CPUS[:1], layout)[:2])
        preqs, pstats, eng = _port_serve(pcfg, params, plan, CPUS, layout)
        _same(want[0], preqs, want[1], pstats)
        assert eng.replicas[0].describe_devices() == DEVICES[arch]


# ---------------------------------------------------------------------------
# int8 weights
# ---------------------------------------------------------------------------

QUANT = {"granite-8b": ("granite-8b", {}),
         "phi3.5-moe-42b-a6.6b": ("phi3.5-moe-42b-a6.6b", {}),
         "phi3.5-moe-e6": ("phi3.5-moe-42b-a6.6b", dict(num_experts=6)),
         "jamba-v0.1-52b": ("jamba-v0.1-52b", {})}


@pytest.fixture(scope="module")
def quantized():
    """{name: (jcfg, pcfg, port params, toks, the reference's prefill and
    decode logits, the plain numpy tree)}: the port's seeded weights
    quantized on the JAX side (``repro.models.quant``) and bridged, int8 q
    and float32 s."""
    out = {}
    for name, (arch, kw) in QUANT.items():
        jcfg, pcfg = _variant(arch, **kw)
        tree = bridge.params_to_numpy(PM.init_params(pcfg, 0, device="cpu"))
        jq = JQ.quantize_params(jax.tree.map(jnp.asarray, tree), jcfg)
        toks, _ = _batch(pcfg)
        out[name] = (jcfg, pcfg, bridge.params_from_numpy(
            jax.tree.map(np.asarray, jq), device="cpu"), toks,
            *_reference(jcfg, jq, toks, {}, new=2)[:2], tree)
    return out


def _qleaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict) and set(v) == {"q", "s"}:
            yield path + (k,), v
        elif isinstance(v, dict):
            yield from _qleaves(v, path + (k,))


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", list(QUANT))
def test_int8_tp_logits_and_shard_bytes(quantized, name, tp):
    """Logits of one stage over tp shards against the reference's
    quantized single-device model (and the port's TP 1); every shard
    holds 1/tp of each split weight's int8 bytes, its scales with the
    output columns (or the experts) and whole beside a row-parallel cut,
    each in storage of its own."""
    jcfg, pcfg, params, toks, lg_ref, lg2_ref, _ = quantized[name]
    L = pcfg.num_layers
    got, one, pipes = [None, None], [None, None], []
    for res, devs in ((got, CPUS[:tp]), (one, ["cpu"])):
        pipe = AsymmetricPipeline(pcfg, params, [L], [devs])
        res[0] = pipe.prefill(toks, max_new=NEW)
        res[1] = pipe.decode_step(res[0].argmax(-1).astype(np.int32))
        pipes.append(pipe)
    assert np.abs(got[0] - lg_ref).max() < PREFILL_ATOL
    assert np.abs(got[1] - lg2_ref).max() < DECODE_ATOL
    for a, b in zip(got, one):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    st = pipes[0].stages[0]
    checked = 0
    for i, lp in enumerate(st.layer_params):
        whole = PM.slice_layer_params(pcfg, params, i)
        j = PM.layer_sub_index(pcfg, i)[1]
        for path, w in _qleaves(whole):
            sub, leaf = path
            placed = lp[sub]
            qd, sd = PS.quant_split(pcfg, ("blocks", f"sub{j}") + path,
                                    w["q"].dim() + 1, tp)
            if not isinstance(placed, PM.Shards):
                assert qd is None
                continue
            for s in placed:
                if leaf not in s.params:          # run once (Shards.whole)
                    assert qd is None and leaf in placed.whole
                    continue
                got_w = s.params[leaf]
                if sub in ("mixer", "xattn") and pcfg.layer_kind(i) == "attn":
                    # cut by head ranges (a subset of replicated kv heads)
                    frac = got_w["q"].numel() / w["q"].numel()
                    assert frac in (1 / tp, s.cfg.num_kv_heads
                                    / pcfg.num_kv_heads), (path, frac)
                else:
                    assert qd is not None, path
                    assert got_w["q"].numel() * tp == w["q"].numel(), path
                want_s = (w["s"].numel() if sd is None
                          else w["s"].numel() // tp)
                if not (sub in ("mixer", "xattn")
                        and pcfg.layer_kind(i) == "attn"):
                    assert got_w["s"].numel() == want_s, (path, sd)
                for t in got_w.values():
                    assert t.untyped_storage().nbytes() == \
                        t.numel() * t.element_size(), path
                assert got_w["q"].dtype == torch.int8
                assert got_w["s"].dtype == torch.float32
                checked += 1
    assert checked > 0


@pytest.mark.parametrize("tp", [2, 4])
def test_int8_engine_serves_the_reference_tokens(quantized, tp):
    """granite-8b's int8 weights on a plan whose first stage is TP tp:
    the smoke serving workload's tokens and every ServeStats field equal
    to the reference engine's on the same weights (quantized by it)."""
    jcfg, pcfg, params = quantized["granite-8b"][:3]
    L = pcfg.num_layers
    # device id tp maps onto cpu:(tp % 4); the reference's one device
    # collapses every plan alike, so one serve of it stands for both
    plan = [(list(range(tp)), 1), ([tp], L - 1)]
    if "int8" not in _SERVES:
        jreqs = _reqs(j_synth, jcfg.vocab_size)
        jeng = JEngine(jcfg, _asg(JMOD, plan), params=jax.tree.map(
            jnp.asarray, quantized["granite-8b"][-1]), cache_layout="paged",
            quantize=True, **ENGINE)
        _SERVES["int8"] = (jreqs, jeng.serve(jreqs, deadline=1e9,
                                             clock=JClock()))
    jreqs, jstats = _SERVES["int8"]
    preqs, pstats, eng = _port_serve(pcfg, params, plan, CPUS, "paged")
    _same(jreqs, preqs, jstats, pstats)
    assert eng.replicas[0].describe_devices()[0] == [f"cpu:{i}"
                                                    for i in range(tp)]


_SERVES = {}


def test_reference_rules_replicate_int8_leaves_f9():
    """ROADMAP.md F9: ``repro.models.quant``'s docstring says quantized
    leaves keep their Megatron split on "q" and shard "s" with the output
    channels; the reference's ``param_specs`` matches on the last path
    element ("q" / "s") and replicates them all (only embed splits). The
    port's ``param_splits`` gives the reference's rules as they are, and
    its ``quant_split`` (which the executor cuts by) the promised split."""
    jcfg, pcfg = _variant("granite-8b")
    jq = jax.eval_shape(lambda: JQ.quantize_params(
        JM.init_params(jcfg, jax.random.PRNGKey(0)), jcfg))
    specs = jax.tree_util.tree_flatten_with_path(
        JS.param_specs(jcfg, jq, tp=2),
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]
    split = {tuple(k.key for k in path) for path, s in specs
             if "model" in tuple(s)}
    assert split == {("embed",)}
    qpaths = {tuple(k.key for k in path) for path, _ in specs
              if path[-1].key in ("q", "s")}
    assert len(qpaths) > 0
    pq = quantize_params(PM.init_params(pcfg, 0, device="meta"))
    got = {p: d for p, d in _flat(PS.param_splits(pcfg, pq, 2)).items()
           if d is not None}
    assert set(got) == {("embed",)}
    cuts = {}
    for path in sorted(qpaths):
        if path[-1] != "q":
            continue
        leaf = _get(pq, path)
        cuts[path[-3:-1]] = PS.quant_split(pcfg, path[:-1], leaf.dim(), 2)
    assert cuts[("mixer", "wq")] == (2, 1)          # columns: s with them
    assert cuts[("mixer", "wo")] == (1, None)       # rows: s whole
    assert cuts[("mlp", "w_up")] == (2, 1)
    assert cuts[("mlp", "w_down")] == (1, None)


def _flat(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, path + (k,)))
        else:
            out[path + (k,)] = v
    return out


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree
