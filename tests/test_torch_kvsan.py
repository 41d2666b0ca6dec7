"""KVSAN, the port's page-lifecycle sanitizer (repro_torch.analysis.kvsan),
against the JAX package's (repro.analysis.kvsan), on the CPU (mirrors
tests/test_analysis.py's KVSAN cases):

  * every violation class raises on a hand-driven BlockPool / HostPagePool
    with the reference's message, and legal lifecycle interleavings never
    do;
  * serving under ``kvsan=True`` is pure observation: mixed prefix /
    speculative / preempting traffic, a disaggregated serve, a host-tier
    serve and a cluster-prefix serve on fp32 and int8 pages give the
    unsanitized serve's tokens, and the reference's tokens and every
    ServeStats counter on the same bridged granite-8b (reduced, fp32)
    weights, with no violation and no leak;
  * an injected leak is counted once and reaches ``ServeStats.kvsan_leaks``
    and the summary line, as in the reference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import kvsan as jk
from repro.configs import get_config
from repro.models import model as JM
from repro.serving import block_manager as jbm
from repro.serving import cluster_kv as jck
from repro.serving import continuous as jcont
from repro.serving import disagg as jdis
from repro.serving import loop as jloop
from repro.serving import request as jreq
from repro.serving.pipeline import AsymmetricPipeline as JPipe
from repro.serving.spec import SpecConfig as JSpec
from repro_torch import bridge
from repro_torch.analysis import kvsan as pk
from repro_torch.configs import get_config as port_config
from repro_torch.serving import block_manager as pbm
from repro_torch.serving import cluster_kv as pck
from repro_torch.serving import continuous as pcont
from repro_torch.serving import disagg as pdis
from repro_torch.serving import loop as ploop
from repro_torch.serving import request as preq
from repro_torch.serving.pipeline import AsymmetricPipeline as PPipe
from repro_torch.serving.spec import SpecConfig as PSpec

from _torch_threads import one_torch_thread  # noqa: F401


class _Pkg:
    """One package's modules, by role."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


J = _Pkg(k=jk, bm=jbm, ck=jck, cont=jcont, dis=jdis, loop=jloop, req=jreq,
         Spec=JSpec)
P = _Pkg(k=pk, bm=pbm, ck=pck, cont=pcont, dis=pdis, loop=ploop, req=preq,
         Spec=PSpec)


# ---------------------------------------------------------------------------
# Hand-driven violation classes: the reference's message for each
# ---------------------------------------------------------------------------

def _sanitized_pool(mod, n=8, bs=4, **kw):
    san = mod.k.KVSanitizer(**kw)
    pool = mod.bm.BlockPool(n, bs)
    san.attach_pool(0, pool)
    return san, pool


def _double_free(mod):
    san, pool = _sanitized_pool(mod)
    (b,) = pool.alloc(1)
    pool.free(b)
    pool.free(b)


def _incref_dead(mod):
    san, pool = _sanitized_pool(mod)
    (b,) = pool.alloc(1)
    pool.free(b)
    pool.incref(b)


def _write_after_free(mod):
    san, pool = _sanitized_pool(mod)
    (b,) = pool.alloc(1)
    pool.free(b)
    san.note_write(0, [b])


def _read_freed(mod):
    san, pool = _sanitized_pool(mod)
    blocks = pool.alloc(2)
    san.note_write(0, blocks)
    pool.free(blocks[1])
    san.slot_access(0, blocks, kv_len=7, write_start=7, block_size=4)


def _read_before_write(mod):
    san, pool = _sanitized_pool(mod)
    blocks = pool.alloc(2)
    san.slot_access(0, blocks, kv_len=7, write_start=6, block_size=4)


def _unwritten_tokens(mod):
    san, pool = _sanitized_pool(mod)
    blocks = pool.alloc(1)
    san.slot_access(0, blocks, kv_len=3, write_start=2, block_size=4)


def _table_too_short(mod):
    san, pool = _sanitized_pool(mod)
    blocks = pool.alloc(1)
    san.note_write(0, blocks)
    san.slot_access(0, blocks, kv_len=9, write_start=9, block_size=4)


def _null_inside(mod):
    san, pool = _sanitized_pool(mod)
    blocks = pool.alloc(1)
    san.note_write(0, blocks)
    san.slot_access(0, [blocks[0], mod.bm.NULL_BLOCK], kv_len=6,
                    write_start=6, block_size=4)


def _cow_unwritten(mod):
    san, pool = _sanitized_pool(mod)
    src, dst = pool.alloc(2)
    san.on_copy(0, src, dst)


def _cow_into_freed(mod):
    san, pool = _sanitized_pool(mod)
    src, dst = pool.alloc(2)
    san.note_write(0, [src])
    pool.free(dst)
    san.on_copy(0, src, dst)


def _spill_unwritten(mod):
    san, pool = _sanitized_pool(mod)
    (b,) = pool.alloc(1)
    san.on_spill(0, b)


def _dangling(mod):
    san, pool = _sanitized_pool(mod)
    (b,) = pool.alloc(1)
    pool.free(b)
    san.audit_pool(0, pool, {b: 1})


def _shadow_diverged(mod):
    san, pool = _sanitized_pool(mod)
    (b,) = pool.alloc(1)
    pool._ref[b] = 3
    san.audit_pool(0, pool, {b: 3})


def _two_tier_alias(mod):
    san = mod.k.KVSanitizer()
    host = mod.bm.HostPagePool(4, block_size=4)
    san.attach_host(0, host)
    host.put(101, "payload")
    host.put(101, "payload-again")


def _host_diverged(mod):
    san = mod.k.KVSanitizer()
    host = mod.bm.HostPagePool(4, block_size=4)
    san.attach_host(0, host)
    host._pages[55] = "smuggled"
    san.audit_host(0, host)


def _quant_without_scales(mod):
    san = mod.k.KVSanitizer(quant=True)
    host = mod.bm.HostPagePool(4, block_size=4)
    san.attach_host(0, host)
    host.put(7, [{"k": torch.zeros(1), "v": torch.zeros(1)}])


def _fp_with_scales(mod):
    san = mod.k.KVSanitizer(quant=False)
    host = mod.bm.HostPagePool(4, block_size=4)
    san.attach_host(0, host)
    host.put(8, [{"k": torch.zeros(1), "v": torch.zeros(1),
                  "k_scale": torch.ones(1), "v_scale": torch.ones(1)}])


VIOLATIONS = {
    "double-free": (_double_free, "double free"),
    "incref-dead": (_incref_dead, "use-after-free alias"),
    "write-after-free": (_write_after_free, "use-after-free write"),
    "read-freed": (_read_freed, "use-after-free"),
    "read-before-write": (_read_before_write, "no write ever landed"),
    "unwritten-tokens": (_unwritten_tokens, "unwritten tokens"),
    "table-too-short": (_table_too_short, "needs"),
    "null-inside": (_null_inside, "null block inside"),
    "cow-unwritten": (_cow_unwritten, "COW copies from"),
    "cow-into-freed": (_cow_into_freed, "COW copies into freed"),
    "spill-unwritten": (_spill_unwritten, "spill extracts"),
    "dangling": (_dangling, "dangling"),
    "shadow-diverged": (_shadow_diverged, "diverged"),
    "two-tier-alias": (_two_tier_alias, "two-tier alias"),
    "host-diverged": (_host_diverged, "host tier diverged"),
    "quant-without-scales": (_quant_without_scales, "without scale leaves"),
    "fp-with-scales": (_fp_with_scales, "with scale leaves"),
}


@pytest.mark.parametrize("name", sorted(VIOLATIONS))
def test_violation_raises_as_the_reference(name):
    fn, match = VIOLATIONS[name]
    with pytest.raises(jk.KVSanViolation, match=match) as want:
        fn(J)
    with pytest.raises(pk.KVSanViolation, match=match) as got:
        fn(P)
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, AssertionError)


def _legal(mod):
    san, pool = _sanitized_pool(mod, bs=4)
    blocks = pool.alloc(2)
    san.slot_access(0, blocks, kv_len=6, write_start=0, block_size=4)
    for pos in range(6, 8):
        san.slot_access(0, blocks, kv_len=pos + 1, write_start=pos,
                        block_size=4)
    san.slot_access(0, blocks, kv_len=8, write_start=8, block_size=4)
    san.on_spill(0, blocks[0])
    pool.incref(blocks[0])
    pool.free(blocks[0])
    states = [san.state(0, b) for b in blocks]
    for b in blocks:
        pool.free(b)
    # leaks: counted once, cleared when explained, never re-counted
    (b,) = pool.alloc(1)
    san.note_write(0, [b])
    leaks = [san.audit_pool(0, pool, {}), san.audit_pool(0, pool, {}),
             san.audit_pool(0, pool, {b: 1})]
    pool.free(b)
    leaks.append(san.audit_pool(0, pool, {}))
    # the host tier's LRU drop keeps the shadow in sync
    host = mod.bm.HostPagePool(2, block_size=4)
    dropped = []
    host.on_evict = dropped.append
    san.attach_host(1, host)
    for h in (1, 2, 3):
        host.put(h, f"p{h}")
    san.audit_host(1, host)
    host.discard(2)
    assert host.get(3) == "p3"
    host.put(3, "p3")
    san.audit_host(1, host)
    return (states, [san.state(0, x) for x in blocks], leaks, san.leaks,
            list(san.violations), dropped)


def test_legal_lifecycle_and_leak_counting_equal_reference():
    got, want = _legal(P), _legal(J)
    assert got == want
    assert got[0] == [pk.WRITTEN, pk.WRITTEN]
    assert got[2] == [1, 0, 0, 0] and got[3] == 1 and got[5] == [1]


def _drive_legal_lifecycle(mod, seed):
    rng = np.random.default_rng(seed)
    san, pool = _sanitized_pool(mod, n=12, bs=4)
    live, written = {}, set()
    for _ in range(200):
        op = rng.integers(0, 5)
        if op == 0 and pool.n_free > 0:
            (b,) = pool.alloc(1)
            live[b] = 0
        elif op == 1 and live:
            b = int(rng.choice(list(live)))
            san.note_write(0, [b])
            written.add(b)
        elif op == 2 and live:
            b = int(rng.choice(list(live)))
            pool.incref(b)
            live[b] += 1
        elif op == 3 and live:
            b = int(rng.choice(list(live)))
            pool.free(b)
            if live[b] > 0:
                live[b] -= 1
            else:
                del live[b]
                written.discard(b)
        elif op == 4:
            ws = [b for b in written if b in live]
            if ws:
                san.slot_access(0, [ws[0]], kv_len=4, write_start=4,
                                block_size=4)
    expected = {b: n + 1 for b, n in live.items()}
    fresh = san.audit_pool(0, pool, expected)
    return fresh, san.violations, san.leaks, sorted(live.items())


@pytest.mark.parametrize("seed", [0, 1, 2023])
def test_legal_lifecycle_seeded_is_silent(seed):
    got = _drive_legal_lifecycle(P, seed)
    assert got == _drive_legal_lifecycle(J, seed)
    assert got[:3] == (0, [], 0)


# ---------------------------------------------------------------------------
# Serving under KVSAN
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
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


def _mixed_workload(mod, cfg, seed):
    """Prefix riders + unique prompts + enough decode growth to preempt."""
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


def _families(mod, cfg):
    reqs = []
    for i in range(6):
        rng = np.random.RandomState(100 + i % 3)
        prompt = rng.randint(0, cfg.vocab_size, size=24).astype(np.int32)
        reqs.append(mod.req.Request(rid=i, prompt=prompt, max_new_tokens=4,
                                    arrival=0.3 * i))
    return reqs


def _serve(mod, weights, case, kvsan):
    """One serve of `case`; returns (engines, requests, stats)."""
    cfg, pipe = weights
    B = mod.cont.PagedPipelineBatcher
    if case == "mixed":
        # admission on the bare prompt footprint over a pool too small for
        # every admitted generation: prefix sharing, spec chunks and
        # preemption all at once
        ws = [B(pipe(mod), n_slots=3, max_len=48, block_size=8,
                stage_blocks=[9, 9], admit_headroom=0, prefix_caching=True,
                spec=mod.Spec(k=2), kvsan=kvsan)]
        reqs = _mixed_workload(mod, cfg, 3)
    elif case == "disagg":
        ws = [B(pipe(mod), n_slots=4, max_len=48, block_size=8, role=r,
                prefix_caching=(r == "prefill"), kvsan=kvsan)
              for r in ("prefill", "decode")]
        mod.dis.wire_disaggregation(ws, ["prefill", "decode"],
                                    mod.dis.KVLink())
        reqs = _mixed_workload(mod, cfg, 5)
    elif case.startswith("host"):
        ws = [B(pipe(mod), n_slots=3, max_len=48, block_size=8,
                stage_blocks=[9, 9], prefix_caching=True, host_blocks=64,
                kvsan=kvsan,
                kv_dtype="int8" if case.endswith("int8") else None)]
        reqs = _families(mod, cfg)
    else:
        ws = [B(pipe(mod), n_slots=2, max_len=48, block_size=8,
                stage_blocks=[10, 10], prefix_caching=True, host_blocks=4,
                replica_id=i, kvsan=kvsan,
                kv_dtype="int8" if case.endswith("int8") else None)
              for i in range(2)]
        mod.ck.wire_cluster_prefix(ws)
        reqs = _families(mod, cfg)
    stats = mod.loop.run_serve_loop(ws, reqs, deadline=1e9,
                                    clock=mod.loop.VirtualClock())
    return ws, reqs, stats


SERVES = ("mixed", "disagg", "host", "host-int8", "cluster", "cluster-int8")


@pytest.mark.parametrize("case", SERVES)
def test_kvsan_serving_token_identical_silent_and_equal_reference(weights,
                                                                  case):
    _, off, s_off = _serve(P, weights, case, kvsan=False)
    ws, on, s_on = _serve(P, weights, case, kvsan=True)
    _, jon, js = _serve(J, weights, case, kvsan=True)
    for a, b, c in zip(off, on, jon):
        assert list(a.output) == list(b.output) == list(c.output), a.rid
    for f in dataclasses.fields(ploop.ServeStats):
        assert getattr(s_on, f.name) == getattr(s_off, f.name), f.name
        assert getattr(s_on, f.name) == getattr(js, f.name), f.name
    assert s_on.kvsan_leaks == 0
    assert all(w._san is not None and w._san.violations == [] for w in ws)
    if case == "mixed":
        assert s_on.prefix_hits > 0 and s_on.spec_steps > 0
        assert s_on.preemptions > 0
    elif case == "disagg":
        assert s_on.migrations == len(on)
    elif case.startswith("host"):
        assert s_on.host_promotions > 0
    else:
        assert s_on.prefix_fetches > 0 or s_on.host_promotions > 0


def _leak(mod, weights):
    ws, _, stats = _serve(mod, weights, "mixed", kvsan=True)
    b = ws[0]
    si = next(i for i, p in enumerate(b._pools) if p is not None)
    (bid,) = b._pools[si].alloc(1)
    b._san.note_write(si, [bid])
    b._kvsan_audit()
    once = b.kvsan_leaks
    b._pools[si].free(bid)
    b._kvsan_audit()
    # a leak found by the per-iteration audit DURING a serve lands in that
    # serve's delta window
    (bid,) = b._pools[si].alloc(1)
    b._san.note_write(si, [bid])
    later = mod.loop.run_serve_loop([b], _mixed_workload(mod, weights[0], 5),
                                    deadline=1e9,
                                    clock=mod.loop.VirtualClock())
    return (stats.kvsan_leaks, once, b.kvsan_leaks, later.kvsan_leaks,
            later.summary(), [v for v in b._san.violations if "leak" in v])


def test_injected_leak_reaches_serve_stats(weights):
    got, want = _leak(P, weights), _leak(J, weights)
    assert got == want
    assert got[:4] == (0, 1, 2, 1)
    assert "KVSAN-LEAKS=1" in got[4] and len(got[5]) == 2
