"""xlstm-125m in the port against the JAX package: the chunked mLSTM scan
(``ops.mlstm_scan``, against the reference's and its sequential oracle
``ref.mlstm_scan_ref``, from a zero state and from a given one), the mLSTM
decode step, the mLSTM and sLSTM blocks (prefill with right and left
padding, decode), whole-model prefill and decode of reduced xlstm-125m
(one period: three mLSTM layers and one sLSTM layer), and the engines
serving it on the paged layout through a [1, 3] pipeline (recurrent slot
rows only, no page pool is read) and on the contiguous one, plainly and
with int8 weights (the same quantized weights on both sides), with greedy
tokens and every ServeStats counter equal to the JAX engine's. A stack
without attention has no page pool to run dry, so preemption and
re-prefill are served on a variant whose period holds an attention layer
among the mLSTM and sLSTM ones; a re-inserted slot's state must equal a
fresh insert's. Prefix caching, chunked prefill,
quantized pages and speculation must warn with the reference's words and
serve the plain tokens.

Inputs come from numpy seeds. fp32; tolerances atol = rtol = 1e-4, as in
test_torch_models.py (the two sides sum in other orders)."""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.plan import Assignment, PipelinePlan, StagePlan
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import model as JM
from repro.models import quant as JQ
from repro.models import xlstm as JX
from repro.serving import request as jreq
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving.loop import VirtualClock as JClock
from repro_torch import bridge
from repro_torch.configs import get_config as port_config
from repro_torch.configs.base import ATTN, MLSTM, SLSTM
from repro_torch.core import plan as port_plan
from repro_torch.kernels import ops, ref
from repro_torch.models import model as PM
from repro_torch.models import xlstm as PX
from repro_torch.serving import request as preq
from repro_torch.serving.engine import InferenceEngine as PEngine
from repro_torch.serving.loop import VirtualClock as PClock
from repro_torch.serving.pipeline import AsymmetricPipeline as PPipeline

from _torch_threads import one_torch_thread  # noqa: F401

ARCH = "xlstm-125m"
TOL = dict(atol=1e-4, rtol=1e-4)
COUNTERS = ("latencies", "iterations", "prefill_tokens", "prefix_lookups",
            "prefix_hits", "prefix_hit_tokens", "cow_copies", "preemptions",
            "spec_steps", "spec_proposed", "spec_accepted", "spec_tokens",
            "kv_bytes_resident", "kv_bytes_saved")


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got, want):
    if isinstance(got, dict):
        assert set(got) == set(want)
        for k in got:
            _close(got[k], want[k])
        return
    np.testing.assert_allclose(torch.as_tensor(got).float().numpy(),
                               np.asarray(want, np.float32), **TOL)


# an attention layer in the period, so that decode growth can run a page
# pool dry and preempt
MIXED = (MLSTM, ATTN, MLSTM, SLSTM)


def _setup(**kw):
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **kw)
    tree = jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(0)))
    return cfg, dataclasses.replace(port_config(ARCH).reduced(), **kw), tree


@pytest.fixture(scope="module")
def weights():
    return _setup()


@pytest.fixture(scope="module")
def mixed():
    return _setup(layer_pattern=MIXED)


def _mlstm_inputs(seed, b, s, h, dk, dv):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((b, s, h, dk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    sig = lambda a: (1 / (1 + np.exp(-a))).astype(np.float32)  # noqa: E731
    ig = sig(rng.standard_normal((b, s, h)))
    fg = sig(rng.standard_normal((b, s, h)) + 2.0)
    C0 = rng.standard_normal((b, h, dk, dv)).astype(np.float32)
    n0 = rng.standard_normal((b, h, dk)).astype(np.float32)
    return (q, k, v, ig, fg), dict(C0=C0, n0=n0)


# --- the mLSTM recurrence ----------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 37, 128, 300])
def test_mlstm_scan_matches_reference_and_oracle(s, with_state):
    # s = 37 and 300 are no multiple of the 128-step chunk (pad steps)
    args, state = _mlstm_inputs(s, 2, s, 4, 8, 16)
    state = state if with_state else {}
    jargs = [jnp.asarray(a) for a in args]
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    targs = [_t(a) for a in args]
    tstate = {k: _t(v) for k, v in state.items()}
    y, (C, n) = ops.mlstm_scan(*targs, **tstate)
    assert y.dtype == torch.float32 and C.dtype == n.dtype == torch.float32
    for want in (jops.mlstm_scan(*jargs, **jstate),
                 jref.mlstm_scan_ref(*jargs, **jstate)):
        _close(y, want[0])
        _close(C, want[1][0])
        _close(n, want[1][1])
    oy, (oC, on) = ref.mlstm_scan_ref(*targs, **tstate)
    _close(oy, y.numpy())
    _close(oC, C.numpy())
    _close(on, n.numpy())


def test_mlstm_step_matches_reference():
    args, state = _mlstm_inputs(9, 3, 1, 4, 8, 16)
    step = [a[:, 0] for a in args]
    want = jops.mlstm_step(*map(jnp.asarray, step), jnp.asarray(state["C0"]),
                           jnp.asarray(state["n0"]))
    got = ops.mlstm_step(*map(_t, step), _t(state["C0"]), _t(state["n0"]))
    _close(got[0], want[0])
    _close(got[1][0], want[1][0])
    _close(got[1][1], want[1][1])
    # a step equals a one-step scan from the same state
    y1, (C1, n1) = ops.mlstm_scan(*map(_t, args), C0=_t(state["C0"]),
                                  n0=_t(state["n0"]))
    _close(got[0], y1[:, 0].numpy())
    _close(got[1][0], C1.numpy())


# --- the blocks --------------------------------------------------------------

def _sub(tree, cfg, kind):
    j = next(j for j, (k, _) in enumerate(JM.sub_kinds(cfg)) if k == kind)
    return jax.tree.map(lambda a: a[0], tree["blocks"][f"sub{j}"]["mixer"])


PADS = {"none": None,
        "right": np.array([[1] * 13, [1] * 6 + [0] * 7, [1] * 2 + [0] * 11]),
        "left": np.array([[1] * 13, [0] * 7 + [1] * 6, [0] * 11 + [1] * 2])}


@pytest.mark.parametrize("pad", sorted(PADS))
@pytest.mark.parametrize("kind", [MLSTM, SLSTM])
def test_block_prefill_and_decode_match_reference(weights, kind, pad):
    cfg, pcfg, tree = weights
    lp = _sub(tree, cfg, kind)
    x = (0.5 * np.random.default_rng(4).standard_normal(
        (3, 13, cfg.d_model))).astype(np.float32)
    valid = PADS[pad]
    jfns = {MLSTM: (JX.mlstm_prefill, JX.mlstm_decode),
            SLSTM: (JX.slstm_prefill, JX.slstm_decode)}[kind]
    pfns = {MLSTM: (PX.mlstm_prefill, PX.mlstm_decode),
            SLSTM: (PX.slstm_prefill, PX.slstm_decode)}[kind]
    jcache = jax.tree.map(lambda a: a[0], JM.init_cache(cfg, 3, 1)[
        f"sub{0 if kind == MLSTM else 3}"])
    pcache = PM._slot_state(pcfg, kind, (3,), torch.float32, "cpu")
    assert jax.tree.map(lambda a: a.shape, jcache) == \
        {k: tuple(v.shape) for k, v in pcache.items()}
    want, wc = jfns[0](_j(lp), jnp.asarray(x), cfg, cache=jcache,
                       valid=None if valid is None else jnp.asarray(valid))
    p = bridge.params_from_numpy(lp, device="cpu")
    got, gc = pfns[0](p, _t(x), pcfg, cache=pcache,
                      valid=None if valid is None else _t(valid))
    _close(got, want)
    _close(gc, wc)
    # the next token from the prefill's state
    x1 = x[:, :1] * 0.7
    want1, wc1 = jfns[1](_j(lp), jnp.asarray(x1), cfg, cache=wc)
    got1, gc1 = pfns[1](p, _t(x1), pcfg, cache=gc)
    _close(got1, want1)
    _close(gc1, wc1)


def test_slstm_step_and_gates_match_reference(weights):
    cfg, pcfg, tree = weights
    lp = _sub(tree, cfg, SLSTM)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    state = {k: (rng.standard_normal((2, cfg.d_model)) * 0.3
                 ).astype(np.float32) for k in ("c", "n", "m", "h")}
    p = bridge.params_from_numpy(lp, device="cpu")
    for g, w in zip(PX.slstm_gates(p, _t(x), _t(state["h"]), pcfg),
                    JX.slstm_gates(_j(lp), jnp.asarray(x),
                                   jnp.asarray(state["h"]), cfg)):
        _close(g, w)
    _close(PX.slstm_step(p, _t(x), {k: _t(v) for k, v in state.items()},
                         pcfg),
           JX.slstm_step(_j(lp), jnp.asarray(x), _j(state), cfg))
    z = PX.slstm_init_state(2, cfg.d_model, device="cpu")
    _close(z, JX.slstm_init_state(2, cfg.d_model))


def test_xlstm_dims_match_reference(weights):
    cfg, pcfg, _ = weights
    full, pfull = get_config(ARCH), port_config(ARCH)
    for c, pc in ((cfg, pcfg), (full, pfull)):
        assert PX.m_d_inner(pc) == JX.m_d_inner(c)
        assert PX.m_qk_dim(pc) == JX.m_qk_dim(c)


# --- the whole model ---------------------------------------------------------

def test_prefill_and_decode_logits_match_reference(weights):
    cfg, pcfg, tree = weights
    b, s = 3, 13
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (b, s),
                                             dtype=np.int32)
    lens = np.array([13, 6, 2], np.int32)
    jl, jc = JM.prefill(cfg, _j(tree), {"tokens": jnp.asarray(toks)},
                        JM.init_cache(cfg, b, s + 2), lens=jnp.asarray(lens))
    params = bridge.params_from_numpy(tree, device="cpu")
    pc = PM.init_cache(pcfg, b, s + 2, device="cpu")
    assert jax.tree.map(lambda a: a.shape, jc) == \
        jax.tree.map(lambda t: tuple(t.shape), pc)
    pl, pc = PM.prefill(pcfg, params, {"tokens": toks}, pc, lens=lens)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    _close(pc, jc)
    nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    jl2, jc2 = JM.decode_step(cfg, _j(tree), jnp.asarray(nxt), jc,
                              jnp.asarray(lens))
    pl2, pc2 = PM.decode_step(pcfg, params, nxt, pc, lens)
    np.testing.assert_allclose(pl2.numpy(), np.asarray(jl2), **TOL)
    _close(pc2, jc2)


def test_seeded_init_has_the_reference_layout(weights):
    cfg, pcfg, tree = weights
    got = PM.init_params(pcfg, 0, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), got) == \
        jax.tree.map(lambda a: a.shape, tree)
    assert "ln2" not in got["blocks"]["sub0"]          # d_ff 0: no MLP
    assert float(got["blocks"]["sub3"]["mixer"]["b_f"].min()) == 1.0


# --- the engines -------------------------------------------------------------

def _synth(mod, vocab):
    return mod.synth_workload(rate=40.0, duration=0.25, vocab=vocab,
                              prompt_len=20, prompt_jitter=8, out_len=5,
                              seed=1)


def _short(mod, vocab):
    return mod.synth_workload(rate=40.0, duration=0.25, vocab=vocab,
                              prompt_len=8, prompt_jitter=5, out_len=4,
                              seed=1)


def _quantized(tree, cfg):
    return jax.tree.map(np.asarray, JQ.quantize_params(_j(tree), cfg))


SERVES = {
    "paged": (_synth, dict(cache_layout="paged", block_size=8), None),
    "contiguous": (_synth, dict(cache_layout="contiguous"), None),
    "w8": (_synth, dict(cache_layout="paged", block_size=8), _quantized),
    # on MIXED: 2-token blocks, so decode growth runs the attention stage's
    # pool dry and preempts; the re-prefill rewrites the slots' mLSTM and
    # sLSTM state
    "preempt": (_short, dict(cache_layout="paged", block_size=2,
                             stage_blocks=[14, 14]), None),
}
SPLIT = [1, 3]


def _jax_engine(cfg, tree, **kw):
    asg = Assignment([PipelinePlan([StagePlan([0], SPLIT[0]),
                                    StagePlan([1], SPLIT[1])])])
    return JEngine(cfg, asg, params=_j(tree), policy="continuous",
                   n_slots=4, max_len=64, **kw)


def _port_engine(pcfg, tree, **kw):
    asg = port_plan.Assignment([port_plan.PipelinePlan(
        [port_plan.StagePlan([0], SPLIT[0]),
         port_plan.StagePlan([1], SPLIT[1])])])
    return PEngine(pcfg, asg, params=bridge.params_from_numpy(tree,
                                                              device="cpu"),
                   device="cpu", n_slots=4, max_len=64, **kw)


def _serve(engine, mod, clock, make, vocab):
    reqs = make(mod, vocab)
    stats = engine.serve(reqs, deadline=120.0, clock=clock)
    return [list(r.output) for r in reqs], stats


def _same(got, want):
    (gt, gs), (wt, ws) = got, want
    assert len(gt) == len(wt) > 0
    for i, (a, b) in enumerate(zip(gt, wt)):
        assert a == b, f"request {i}: {a} vs {b}"
    for c in COUNTERS:
        assert getattr(gs, c) == getattr(ws, c), c


def _model(name, weights, mixed):
    return mixed if name == "preempt" else weights


@pytest.fixture(scope="module")
def reference_serves(weights, mixed):
    out = {}
    for name, (make, kw, prep) in SERVES.items():
        cfg, _, tree = _model(name, weights, mixed)
        t = prep(tree, cfg) if prep else tree
        out[name] = _serve(_jax_engine(cfg, t, **kw), jreq, JClock(), make,
                           cfg.vocab_size)
    return out


@pytest.mark.parametrize("name", sorted(SERVES))
def test_port_serves_xlstm_token_identical_to_reference(weights, mixed,
                                                        reference_serves,
                                                        name):
    cfg, pcfg, tree = _model(name, weights, mixed)
    make, kw, prep = SERVES[name]
    engine = _port_engine(pcfg, prep(tree, cfg) if prep else tree, **kw)
    assert [st.has_attn for st in engine.replicas[0].stages] == \
        [False, name == "preempt"]
    got = _serve(engine, preq, PClock(), make, pcfg.vocab_size)
    _same(got, reference_serves[name])
    if name == "preempt":
        assert got[1].preemptions > 0


FALLBACKS = {
    "prefix_caching": dict(prefix_caching=True),
    "prefill_chunk": dict(prefill_chunk=16),
    "kv_int8": dict(kv_dtype="int8"),
    "spec_decode": dict(spec_decode=True, spec_k=2),
}


def _warnings_of(build):
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        engine = build()
    return engine, [str(w.message) for w in got
                    if issubclass(w.category, UserWarning)]


@pytest.mark.parametrize("name", sorted(FALLBACKS))
def test_xlstm_fallbacks_warn_and_serve_plain(weights, reference_serves,
                                              name):
    cfg, pcfg, tree = weights
    kw = dict(cache_layout="paged", block_size=8, **FALLBACKS[name])
    _, want = _warnings_of(lambda: _jax_engine(cfg, tree, **kw))
    engine, got = _warnings_of(lambda: _port_engine(pcfg, tree, **kw))
    assert want and got == want
    _same(_serve(engine, preq, PClock(), _synth, pcfg.vocab_size),
          reference_serves["paged"])


def test_reinsert_rewrites_the_slot_state(weights):
    """A slot that held a decoding request and takes another (the batcher's
    re-prefill after a preemption, or a freed slot's next request) ends up
    with the state a fresh insert gives: nothing of the old request's
    state survives."""
    _, pcfg, tree = weights
    rng = np.random.default_rng(11)
    a, b = (rng.integers(0, pcfg.vocab_size, (1, 12), dtype=np.int32)
            for _ in range(2))
    params = bridge.params_from_numpy(tree, device="cpu")
    pipes = [PPipeline(pcfg, params, SPLIT, device="cpu") for _ in range(2)]
    for p in pipes:
        p.init_paged_caches(4, 32, block_size=8, stage_blocks=[17, 17])
    dest = [np.zeros(4, np.int32)] * 2          # no attention layer to page
    tables = [np.zeros((4, 4), np.int32)] * 2
    pipes[0].insert_slots_paged(a, np.array([12]), [1], dest)
    for t in range(3):
        pipes[0].decode_slots_paged(np.full(4, 5 + t), np.full(4, 12 + t),
                                    tables)
    got = pipes[0].insert_slots_paged(b, np.array([9]), [1], dest)
    want = pipes[1].insert_slots_paged(b, np.array([9]), [1], dest)
    np.testing.assert_array_equal(got, want)
    for si in range(2):
        for gc, wc in zip(pipes[0].paged_caches[si],
                          pipes[1].paged_caches[si]):
            for n in gc:
                torch.testing.assert_close(gc[n][1], wc[n][1], rtol=0, atol=0)
