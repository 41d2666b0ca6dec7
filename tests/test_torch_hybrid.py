"""Hybrid Mamba + MoE serving in the port against the JAX package: the
selective scan's plain version (against ``ref.ssm_scan_ref`` and the Pallas
kernel in interpret mode), the decode step, the Mamba block, the grouped
MoE dispatch (capacity drops and int8 experts included), the contiguous
prefill / decode of reduced jamba-v0.1-52b, and the engines serving it on
a [1, 3] pipeline (stage 0 holds one Mamba layer and no attention) with
greedy tokens and every ServeStats counter identical. The hybrid
fall-backs (prefix caching, chunked prefill, quantized pages, speculation)
must warn with the reference's words and serve the plain tokens.

Inputs come from numpy seeds; the reference runs its XLA backend, as its
own CPU tests do. Tolerances: fp32 atol 1e-5 for the scan and the blocks
(the two sides sum in other orders), one bf16 ulp of the largest output in
bf16, 1e-4 on the logits of the whole 4-layer model."""
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
from repro.kernels.ssm_scan import ssm_scan_pallas
from repro.models import mamba as JMamba
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.models import quant as JQ
from repro.serving import request as jreq
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving.loop import VirtualClock as JClock
from repro_torch import bridge
from repro_torch.configs import get_config as port_config
from repro_torch.core import plan as port_plan
from repro_torch.kernels import ops, ref
from repro_torch.models import mamba as PMamba
from repro_torch.models import model as PM
from repro_torch.models import moe as PMoE
from repro_torch.serving import request as preq
from repro_torch.serving.engine import InferenceEngine as PEngine
from repro_torch.serving.loop import VirtualClock as PClock

from _torch_threads import one_torch_thread  # noqa: F401

ARCH = "jamba-v0.1-52b"
ATOL = 1e-5
COUNTERS = ("latencies", "iterations", "prefill_tokens", "prefix_lookups",
            "prefix_hits", "prefix_hit_tokens", "cow_copies", "preemptions",
            "spec_steps", "spec_proposed", "spec_accepted", "spec_tokens",
            "kv_bytes_resident", "kv_bytes_saved")


def _rn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _scan_inputs(seed, b, s, din, ds):
    rng = np.random.default_rng(seed)
    x = _rn(rng, b, s, din)
    dt = np.log1p(np.exp(_rn(rng, b, s, din)))             # softplus
    A = -np.exp(_rn(rng, din, ds) * 0.5)
    B, C, D = _rn(rng, b, s, ds), _rn(rng, b, s, ds), _rn(rng, din)
    h0 = _rn(rng, b, din, ds) * 0.1
    return x, dt, A, B, C, D, h0


def _close(got, want, dtype):
    got = np.asarray(torch.as_tensor(got).float())
    want = np.asarray(jnp.asarray(want, jnp.float32))
    tol = ATOL if dtype == "float32" else \
        float(np.abs(want).max()) * 2.0 ** -7 + 1e-6
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.fixture(scope="module")
def weights():
    cfg = get_config(ARCH).reduced()
    tree = jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(0)))
    return cfg, port_config(ARCH).reduced(), tree


# --- (a) the selective scan: plain version against the reference -----------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s,chunk", [(64, 16), (20, 20), (37, None)])
def test_plain_scan_matches_reference(dtype, with_h0, s, chunk):
    # s = 37 is no multiple of any chunk the Pallas kernel could take
    # (ssm_scan_pallas asserts s % chunk == 0, ROADMAP F3): the XLA path of
    # the reference pads it with dt = 0 steps
    b, din, ds = 2, 16, 8
    x, dt, A, B, C, D, h0 = _scan_inputs(s, b, s, din, ds)
    jdt = jnp.dtype(dtype)
    jx, jdtv = jnp.asarray(x, jdt), jnp.asarray(dt, jdt)
    jh0 = jnp.asarray(h0) if with_h0 else None
    want_y, want_h = jref.ssm_scan_ref(jx, jdtv, A, B, C, D, h0=jh0)
    tdt = getattr(torch, dtype)
    y, h = ops.ssm_scan(torch.from_numpy(x).to(tdt),
                        torch.from_numpy(dt).to(tdt), torch.from_numpy(A),
                        torch.from_numpy(B), torch.from_numpy(C),
                        torch.from_numpy(D),
                        h0=torch.from_numpy(h0) if with_h0 else None)
    assert y.dtype == tdt and h.dtype == torch.float32
    _close(y, want_y, dtype)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=ATOL)
    if chunk is not None:
        py, ph = ssm_scan_pallas(jx, jdtv, A, B, C, D, h0=jh0, chunk=chunk,
                                 d_block=8, interpret=True)
    else:
        py, ph = jops.ssm_scan(jx, jdtv, A, B, C, D, h0=jh0, chunk=16)
    _close(y, py, dtype)
    np.testing.assert_allclose(h.numpy(), np.asarray(ph), atol=ATOL)


def test_port_scan_takes_widths_the_pallas_kernel_refuses():
    # ROADMAP F3: the batcher buckets prompt widths to multiples of 16, and
    # the Pallas kernel's chunk = min(128, s) must divide s; the port takes
    # any s >= 1
    x, dt, A, B, C, D, _ = _scan_inputs(0, 1, 144, 8, 4)
    with pytest.raises(AssertionError):
        ssm_scan_pallas(*map(jnp.asarray, (x, dt, A, B, C, D)),
                        interpret=True)
    y, h = ops.ssm_scan(*map(torch.from_numpy, (x, dt, A, B, C, D)))
    want_y, want_h = jref.ssm_scan_ref(*map(jnp.asarray,
                                            (x, dt, A, B, C, D)))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=ATOL)


# --- (a') the kernel's lane split: its order of sums, its launch geometry ---

def _lane_split_scan(x, dt, A, B, C, D, h0, lanes):
    """numpy float32 model of csrc/ssm_scan.cu's order of operations: exp
    as exp2 of dt times A log2 e; lane q of a channel's group sums h . C
    over its ds / L consecutive state elements in order, lane 0 starting
    from D x; the L partial sums combine as the kernel's reduce-scatter
    does (lanes L / 2 apart first, then L / 4, ..., then 1: at L = 4,
    (P0 + P2) + (P1 + P3))."""
    f = np.float32
    b, s, din = x.shape
    ds = A.shape[-1]
    k = ds // lanes
    a2 = A.astype(f) * f(1.4426950408889634)
    h = np.zeros((b, din, ds), f) if h0 is None else h0.astype(f)
    y = np.empty((b, s, din), f)
    for t in range(s):
        xt, dtt = x[:, t].astype(f), dt[:, t].astype(f)
        h = np.exp2(dtt[..., None] * a2) * h \
            + (dtt * xt)[..., None] * B[:, t, None, :].astype(f)
        hc = h * C[:, t, None, :].astype(f)                # (b, din, ds)
        part = [np.zeros((b, din), f) for _ in range(lanes)]
        part[0] = D.astype(f) * xt
        for q in range(lanes):
            for j in range(k):
                part[q] = part[q] + hc[..., q * k + j]
        w = lanes // 2
        while w:
            part = [part[q] + part[q ^ w] for q in range(lanes)]
            w //= 2
        y[:, t] = part[0]
    return y, h


@pytest.mark.parametrize("ds", [4, 8, 16])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s", [1, 17, 40])
def test_lane_split_order_matches_reference(ds, with_h0, s):
    # fp32 atol 1e-5 (ATOL): the lane split only reorders the fp32 sum of
    # ds products and D x (and exp becomes exp2 of a rounded product);
    # every value is O(1), so a reordering moves it by a few ulps
    from repro_torch.kernels import ssm_scan as pss
    lanes = pss.LANES[ds]
    assert ds % lanes == 0 and 32 % lanes == 0
    x, dt, A, B, C, D, h0 = _scan_inputs(100 + s, 2, s, 24, ds)
    h0 = h0 if with_h0 else None
    y, h = _lane_split_scan(x, dt, A, B, C, D, h0, lanes)
    want_y, want_h = ref.ssm_scan_ref(
        *map(torch.from_numpy, (x, dt, A, B, C, D)),
        h0=None if h0 is None else torch.from_numpy(h0))
    np.testing.assert_allclose(y, want_y.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(h, want_h.numpy(), rtol=0, atol=ATOL)
    jy, jh = jops.ssm_scan(*map(jnp.asarray, (x, dt, A, B, C, D)),
                           h0=None if h0 is None else jnp.asarray(h0),
                           chunk=16)
    np.testing.assert_allclose(y, np.asarray(jy), rtol=0, atol=ATOL)
    np.testing.assert_allclose(h, np.asarray(jh), rtol=0, atol=ATOL)


@pytest.mark.parametrize("ds", [4, 8, 16])
@pytest.mark.parametrize("din", [8192, 200, 24, 16])
def test_scan_launch_covers_each_state_element_once(ds, din):
    from repro_torch.kernels import ssm_scan as pss
    b = 3
    lanes, ch, (gx, gy) = pss.geometry(b, din, ds)
    assert (gx, gy) == (-(-din * lanes // pss.THREADS), b)
    assert ch * lanes == pss.THREADS and 32 % lanes == 0
    row, c, n0 = pss.thread_map(b, din, ds)
    assert len(row) == gx * gy * pss.THREADS
    # a channel's lanes are neighbours of one warp, first lane first
    t = torch.arange(len(row)) % pss.THREADS
    assert torch.equal(c.view(-1, lanes).amin(1), c.view(-1, lanes).amax(1))
    assert torch.equal((t // 32).view(-1, lanes).amin(1),
                       (t // 32).view(-1, lanes).amax(1))
    assert torch.equal(n0.view(-1, lanes)[:, 0], torch.zeros(len(row) // lanes,
                                                             dtype=n0.dtype))
    live = c < din
    k = ds // lanes
    # every live thread's elements n0 .. n0 + k - 1, over all threads: each
    # (row, channel, state element) exactly once; dead threads only past din
    n = (n0[live, None] + torch.arange(k)).flatten()
    key = ((row[live, None] * din + c[live, None]) * ds).expand(-1, k) \
        .flatten() + n
    counts = torch.bincount(key, minlength=b * din * ds)
    assert len(counts) == b * din * ds and bool((counts == 1).all())
    assert int((~live).sum()) == (gx * ch - din) * lanes * b


# --- (b) ssm_step: a chain of steps is the scan ------------------------------

def test_ssm_step_chain_equals_scan_prefix():
    b, s, din, ds = 3, 9, 16, 4
    arrays = _scan_inputs(5, b, s, din, ds)
    x, dt, A, B, C, D, h0 = map(torch.from_numpy, arrays)
    jx, jdt, jA, jB, jC, jD, jh = map(jnp.asarray, arrays)
    y_scan, h_scan = ref.ssm_scan_ref(x, dt, A, B, C, D, h0=h0)
    h = h0.clone()
    for t in range(s):
        y, h = ref.ssm_step(x[:, t], dt[:, t], A, B[:, t], C[:, t], D, h)
        jy, jh = jops.ssm_step(jx[:, t], jdt[:, t], jA, jB[:, t], jC[:, t],
                               jD, jh)
        np.testing.assert_allclose(y.numpy(), y_scan[:, t].numpy(),
                                   atol=ATOL)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=ATOL)
    np.testing.assert_allclose(h.numpy(), h_scan.numpy(), atol=ATOL)


# --- (c) the Mamba block on bridged weights ---------------------------------

def test_mamba_prefill_and_decode_match_reference(weights):
    cfg, pcfg, tree = weights
    assert cfg.layer_kind(0) == "mamba"
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      tree["blocks"]["sub0"]["mixer"])
    pp = bridge.params_from_numpy(
        jax.tree.map(lambda a: a[0], tree["blocks"]["sub0"]["mixer"]),
        device="cpu")
    b, s, din = 3, 12, PMamba.d_inner(pcfg)
    x = _rn(np.random.default_rng(7), b, s, cfg.d_model)
    lens = np.array([5, 12, 2], np.int32)      # 2 < w - 1: leading zeros
    valid = (np.arange(s)[None] < lens[:, None]).astype(np.int32)
    w, ds = cfg.ssm_d_conv, cfg.ssm_d_state
    jcache = {"conv": jnp.zeros((b, w - 1, din)),
              "h": jnp.zeros((b, din, ds))}
    pcache = {"conv": torch.zeros(b, w - 1, din), "h": torch.zeros(b, din, ds)}
    jo, jc = JMamba.mamba_prefill(jp, jnp.asarray(x), cfg,
                                  valid=jnp.asarray(valid),
                                  lens=jnp.asarray(lens), cache=jcache)
    po, pc = PMamba.mamba_prefill(pp, torch.from_numpy(x), pcfg,
                                  valid=torch.from_numpy(valid),
                                  lens=torch.from_numpy(lens), cache=pcache)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=ATOL)
    for n in ("conv", "h"):
        assert pc[n].dtype == torch.float32
        np.testing.assert_allclose(pc[n].numpy(), np.asarray(jc[n]),
                                   atol=ATOL)
    xd = _rn(np.random.default_rng(8), b, 1, cfg.d_model)
    jo, jc = JMamba.mamba_decode(jp, jnp.asarray(xd), cfg, cache=jc)
    po, pc = PMamba.mamba_decode(pp, torch.from_numpy(xd), pcfg, cache=pc)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=ATOL)
    for n in ("conv", "h"):
        np.testing.assert_allclose(pc[n].numpy(), np.asarray(jc[n]),
                                   atol=ATOL)


# --- (d) grouped MoE dispatch -----------------------------------------------

@pytest.mark.parametrize("s", [1, 40])
@pytest.mark.parametrize("int8", [False, True])
def test_moe_matches_reference(weights, s, int8):
    cfg, pcfg, tree = weights
    assert cfg.is_moe_layer(1)
    leaf = jax.tree.map(lambda a: a[0], tree["blocks"]["sub1"]["moe"])
    if int8:
        leaf = jax.tree.map(np.asarray,
                            JQ.quantize_params(jax.tree.map(jnp.asarray,
                                                            leaf), cfg))
        assert JQ.is_quantized(leaf["w_gate"])
    x = _rn(np.random.default_rng(0), 2, s, cfg.d_model)
    if s * cfg.top_k > 64:
        # lean every token towards expert 0, so that it gets more tokens
        # than its capacity C = int(1.25 * s * k / E) and drops some
        r0 = leaf["router"][:, 0]
        x = (x + 4.0 * r0 / np.linalg.norm(r0) * np.sqrt(cfg.d_model)
             ).astype(np.float32)
        probs = jax.nn.softmax(jnp.asarray(x) @ leaf["router"], axis=-1)
        top = np.asarray(jax.lax.top_k(probs, cfg.top_k)[1])
        assert (top == 0).sum(axis=(1, 2)).min() > int(
            cfg.capacity_factor * s * cfg.top_k / cfg.num_experts)
    want = JMoE._moe_grouped(jax.tree.map(jnp.asarray, leaf),
                             jnp.asarray(x), cfg, return_aux=False)
    got = PMoE.moe_mlp(bridge.params_from_numpy(leaf, device="cpu"),
                       torch.from_numpy(x), pcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


# --- (e) the whole model: contiguous prefill and decode ----------------------

def test_prefill_and_decode_logits_match_reference(weights):
    cfg, pcfg, tree = weights
    b, s = 3, 13
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (b, s),
                                             dtype=np.int32)
    lens = np.array([13, 6, 2], np.int32)
    jl, jc = JM.prefill(cfg, jax.tree.map(jnp.asarray, tree),
                        {"tokens": jnp.asarray(toks)},
                        JM.init_cache(cfg, b, s + 2), lens=jnp.asarray(lens))
    params = bridge.params_from_numpy(tree, device="cpu")
    pc = PM.init_cache(pcfg, b, s + 2, device="cpu")
    assert jax.tree.map(lambda a: a.shape, jc) == \
        jax.tree.map(lambda t: tuple(t.shape), pc)
    pl, pc = PM.prefill(pcfg, params, {"tokens": toks}, pc, lens=lens)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4)
    nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    jl2, _ = JM.decode_step(cfg, jax.tree.map(jnp.asarray, tree),
                            jnp.asarray(nxt), jc, jnp.asarray(lens))
    pl2, _ = PM.decode_step(pcfg, params, nxt, pc, lens)
    np.testing.assert_allclose(pl2.numpy(), np.asarray(jl2), atol=1e-4)


# --- (f), (g) the engines -----------------------------------------------------

def _long(mod, vocab):
    # padded widths 48-64 with top-2 of 4 experts: s * k > 64, so the
    # prefill's MoE capacity drops tokens
    return mod.synth_workload(rate=40.0, duration=0.25, vocab=vocab,
                              prompt_len=40, prompt_jitter=12, out_len=4,
                              seed=1)


def _short(mod, vocab):
    return mod.synth_workload(rate=40.0, duration=0.25, vocab=vocab,
                              prompt_len=8, prompt_jitter=5, out_len=4,
                              seed=1)


SERVES = {
    "synthetic": (_long, dict(block_size=8)),
    # 2-token blocks: decode growth runs the attention stage's pool dry and
    # preempts; the re-prefill rewrites the slot's recurrent state
    "preempt": (_short, dict(block_size=2, stage_blocks=[14, 14])),
    "quantize": (_long, dict(block_size=8, quantize=True)),
}
SPLIT = [1, 3]                     # stage 0: one Mamba layer, no attention


def _jax_serve(cfg, tree, make, **kw):
    asg = Assignment([PipelinePlan([StagePlan([0], SPLIT[0]),
                                    StagePlan([1], SPLIT[1])])])
    reqs = make(jreq, cfg.vocab_size)
    stats = JEngine(cfg, asg, params=jax.tree.map(jnp.asarray, tree),
                    policy="continuous", cache_layout="paged", n_slots=4,
                    max_len=64, **kw).serve(reqs, deadline=120.0,
                                            clock=JClock())
    return [list(r.output) for r in reqs], stats


def _port_engine(pcfg, tree, **kw):
    asg = port_plan.Assignment([port_plan.PipelinePlan(
        [port_plan.StagePlan([0], SPLIT[0]),
         port_plan.StagePlan([1], SPLIT[1])])])
    return PEngine(pcfg, asg, params=bridge.params_from_numpy(tree,
                                                              device="cpu"),
                   device="cpu", cache_layout="paged", n_slots=4, max_len=64,
                   **kw)


def _port_serve(engine, pcfg, make):
    reqs = make(preq, pcfg.vocab_size)
    stats = engine.serve(reqs, deadline=120.0, clock=PClock())
    return [list(r.output) for r in reqs], stats


def _same(got, want):
    (gt, gs), (wt, ws) = got, want
    assert len(gt) == len(wt) > 0
    for i, (a, b) in enumerate(zip(gt, wt)):
        assert a == b, f"request {i}: {a} vs {b}"
    for c in COUNTERS:
        assert getattr(gs, c) == getattr(ws, c), c


@pytest.fixture(scope="module")
def reference_serves(weights):
    cfg, _, tree = weights
    return {name: _jax_serve(cfg, tree, make, **kw)
            for name, (make, kw) in SERVES.items()}


@pytest.mark.parametrize("name", sorted(SERVES))
def test_port_serves_jamba_token_identical_to_reference(weights,
                                                        reference_serves,
                                                        name):
    _, pcfg, tree = weights
    make, kw = SERVES[name]
    engine = _port_engine(pcfg, tree, **kw)
    assert not engine.replicas[0].stages[0].has_attn
    got = _port_serve(engine, pcfg, make)
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
def test_hybrid_fallbacks_warn_and_serve_plain(weights, reference_serves,
                                               name):
    cfg, pcfg, tree = weights
    kw = dict(block_size=8, **FALLBACKS[name])
    _, want = _warnings_of(lambda: JEngine(
        cfg, Assignment([PipelinePlan([StagePlan([0], 1), StagePlan([1], 3)])]),
        params=jax.tree.map(jnp.asarray, tree), policy="continuous",
        cache_layout="paged", n_slots=4, max_len=64, **kw))
    engine, got = _warnings_of(lambda: _port_engine(pcfg, tree, **kw))
    assert want and got == want
    _same(_port_serve(engine, pcfg, _long), reference_serves["synthetic"])
