"""The host page tier, the cluster prefix directory and prefix-aware
routing in the port against the JAX package's, on the CPU (mirrors
tests/test_prefix_cluster.py's engine-level cases).

Tiers and the directory change WHERE pages come from — device pool, host
spill, a peer replica — never what is generated: the port's tiered and
clustered serves give its cold serve's tokens, and the reference's tokens,
timestamps and every ServeStats counter, on the same bridged granite-8b
(reduced, fp32) weights, on fp32 and on int8 pages. The bookkeeping
(PrefixIndex LRU and spill order, HostPagePool's LRU, the directory's
holders and residency) follows the reference op for op, the seeded tier
interleavings keep every invariant and end in the reference's state, and
the Router picks the reference's replica under the same seed."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import model as JM
from repro.serving import block_manager as jbm
from repro.serving import cluster_kv as jck
from repro.serving import continuous as jcont
from repro.serving import loop as jloop
from repro.serving import request as jreq
from repro.serving import router as jrouter
from repro.serving.pipeline import AsymmetricPipeline as JPipe
from repro_torch import bridge
from repro_torch.configs import get_config as port_config
from repro_torch.serving import block_manager as pbm
from repro_torch.serving import cluster_kv as pck
from repro_torch.serving import continuous as pcont
from repro_torch.serving import loop as ploop
from repro_torch.serving import request as preq
from repro_torch.serving import router as prouter
from repro_torch.serving.pipeline import AsymmetricPipeline as PPipe


class _Pkg:
    """One package's modules, by role."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


J = _Pkg(bm=jbm, ck=jck, cont=jcont, loop=jloop, req=jreq, router=jrouter)
P = _Pkg(bm=pbm, ck=pck, cont=pcont, loop=ploop, req=preq, router=prouter)


# ---------------------------------------------------------------------------
# PrefixIndex: LRU order and the spill hook
# ---------------------------------------------------------------------------

def _rehit_trace(mod):
    """test_prefix_cluster.py's partial re-hit case: which hashes spill, in
    which order, and what still matches."""
    bm = mod.bm
    pool = bm.BlockPool(8, block_size=4)
    ix = bm.PrefixIndex(pool)
    evicted = []
    ix.spill = lambda h, bid: evicted.append((h, bid))
    hs_a = bm.chunk_hashes(np.arange(12, dtype=np.int32), 4)
    ta = bm.BlockTable(pool)
    assert ta.allocate_tokens(12)
    ix.register(hs_a, ta.blocks)
    hs_b = bm.chunk_hashes(100 + np.arange(8, dtype=np.int32), 4)
    tb = bm.BlockTable(pool)
    assert tb.allocate_tokens(8)
    ix.register(hs_b, tb.blocks)
    ta.release()
    tb.release()
    t = bm.BlockTable(pool, ix.acquire(hs_a[:1]))   # the short head re-hits
    t.release()
    out = [ix.evict(2), list(evicted), ix.match_len(hs_a),
           ix.match_len(hs_b), ix.evict(1), list(evicted),
           ix.match_len(hs_a), sorted(ix.indexed_blocks())]
    ix.clear()
    out += [len(ix), ix.n_evictable(), pool.n_free]
    return out, hs_a, hs_b


def test_partial_prefix_rehit_refreshes_lru_order():
    (got, hs_a, hs_b), (want, _, _) = _rehit_trace(P), _rehit_trace(J)
    assert got == want
    # the cold deep tail of A goes first, the re-hit head and chain B stay
    assert [h for h, _ in got[1]] == [hs_a[2], hs_a[1]]
    assert got[2:4] == [1, 2]
    assert got[5][-1][0] == hs_b[1]


def _tail_first(mod):
    bm = mod.bm
    pool = bm.BlockPool(6, block_size=4)
    ix = bm.PrefixIndex(pool)
    order = []
    ix.spill = lambda h, bid: order.append(h)
    hs = bm.chunk_hashes(np.arange(16, dtype=np.int32), 4)
    t = bm.BlockTable(pool)
    assert t.allocate_tokens(16)
    ix.register(hs, t.blocks)
    t.release()
    return ix.evict(3), order, hs, ix.match_len(hs), ix.lookup(hs[0])


def test_register_orders_chain_tail_first_for_eviction():
    got, want = _tail_first(P), _tail_first(J)
    assert got == want
    n, order, hs, left, head = got
    assert n == 3 and order == [hs[3], hs[2], hs[1]] and left == 1
    assert head is not None


def test_block_table_helpers_equal_reference():
    for mod in (P, J):
        bm = mod.bm
        pool = bm.BlockPool(10, block_size=4)
        t = bm.BlockTable(pool)
        assert t.ensure(6) and t.n_blocks == 2
        f = t.fork()
        assert f.blocks == t.blocks and pool.ref(t.blocks[0]) == 2
        f.release()
        assert pool.peak_used == 2
    pt, jt = (m.bm.BlockTable(m.bm.BlockPool(10, 4)) for m in (P, J))
    for t in (pt, jt):
        t.allocate_tokens(11)
    np.testing.assert_array_equal(pt.gather_positions(11),
                                  jt.gather_positions(11))


# ---------------------------------------------------------------------------
# HostPagePool and the directory
# ---------------------------------------------------------------------------

def _host_trace(mod, seed):
    """A seeded run of put / get / peek / restore / discard: every result,
    every LRU drop and the resident order after each op."""
    hp = mod.bm.HostPagePool(3, block_size=4)
    dropped = []
    hp.on_evict = dropped.append
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(60):
        h = int(rng.randint(0, 8))
        op = rng.randint(6)
        if op in (0, 5):
            hp.put(h, [{"k": torch.full((1, 4, 2, 2), float(h))}])
        elif op == 1:
            got = hp.get(h)
            out.append(None if got is None else float(got[0]["k"][0, 0, 0, 0]))
            if got is not None and rng.randint(2):
                hp.restore(h, got)
        elif op == 2:
            out.append(hp.peek(h) is not None)
        elif op == 3:
            hp.discard(h)
        else:
            out.append(hp.match_len([h, (h + 1) % 8]))
        out.append(hp.hashes())
    return out, dropped, (hp.demotions, hp.promotions, hp.evictions, len(hp))


@pytest.mark.parametrize("seed", range(3))
def test_host_pool_lru_order_equals_reference(seed):
    got, want = _host_trace(P, seed), _host_trace(J, seed)
    assert got == want
    assert got[1], "the LRU bound never dropped a page"


def test_host_pool_one_tier_and_bytes():
    hp = pbm.HostPagePool(2, block_size=4)
    dropped = []
    hp.on_evict = dropped.append
    page = [{"k": torch.ones(1, 4, 2, 2), "v": torch.ones(1, 4, 2, 2),
             "k_scale": torch.ones(1, 4, 2), "v_scale": torch.ones(1, 4, 2)}]
    hp.put(1, page)
    assert hp.nbytes() == 2 * 64 + 2 * 32
    assert hp.get(1) is page and 1 not in hp and hp.promotions == 1
    with pytest.raises(ValueError):
        pbm.HostPagePool(0, block_size=4)


def _directory(mod):
    d = mod.ck.ClusterPrefixDirectory()
    d.publish(7, 0, "host")
    d.publish(7, 1, "device")
    d.publish(7, 2, "device")
    out = [d.holders(7), d.holders(7, exclude=1)]
    d.publish(1, 0, "device")
    d.publish(2, 0, "host")
    out.append(d.resident_blocks([1, 2, 3, 7], 0))
    d.unpublish(2, 0)
    out += [d.resident_blocks([1, 2, 3, 7], 0), sorted(d.entries_for(0)),
            len(d)]
    for r in (0, 1, 2):
        d.unpublish(7, r)
    out += [d.tier(7, 2), len(d)]
    return out


def test_directory_equals_reference():
    got = _directory(P)
    assert got == _directory(J)
    assert got[0] == [(1, "device"), (2, "device"), (0, "host")]


# ---------------------------------------------------------------------------
# Seeded tier interleavings: invariants, and the reference's end state
# ---------------------------------------------------------------------------

class _Rep:
    """One replica's tier stack in miniature, wired as PagedPipelineBatcher
    wires it (test_prefix_cluster.py's model)."""

    def __init__(self, bm, rid, directory, n_usable, block_size, host_cap):
        self.rid = rid
        self.d = directory
        self.pool = bm.BlockPool(n_usable + 1, block_size)
        self.ix = bm.PrefixIndex(self.pool)
        self.host = bm.HostPagePool(host_cap, block_size)
        self.tables = []

        def spill(h, bid):
            self.host.put(h, {"blk": int(bid)})
            self.d.publish(h, self.rid, "host")
        self.ix.spill = spill
        self.host.on_evict = lambda h: self.d.unpublish(h, self.rid)


def _admit(bm, rep, peers, prompt, block_size):
    hs = bm.chunk_hashes(prompt, block_size)
    L = rep.ix.match_len(hs)
    t = bm.BlockTable(rep.pool, rep.ix.acquire(hs[:L]))
    for h in hs[L:]:
        pay, src = rep.host.get(h), "host"
        if pay is None:
            src = None
            for peer in peers:
                if peer.ix.lookup(h) is not None \
                        or peer.host.peek(h) is not None:
                    pay, src = {"blk": -1}, "fetch"
                    break
        if pay is None:
            break
        if rep.pool.n_free < 1:
            rep.ix.evict(1)
        blks = rep.pool.alloc(1)
        if blks is None:
            if src == "host":
                rep.host.restore(h, pay)
            break
        rep.ix.register([h], blks)
        t.adopt(blks)
        rep.host.discard(h)
        rep.d.publish(h, rep.rid, "device")
    n_have = t.n_blocks * block_size
    if len(prompt) > n_have and not t.ensure(len(prompt) - 1):
        rep.ix.evict(len(prompt) // block_size + 1)
        if not t.ensure(len(prompt) - 1):
            t.release()
            return
    k = min(len(hs), t.n_blocks)
    rep.ix.register(hs[:k], t.blocks[:k])
    for h in hs[:k]:
        rep.host.discard(h)
        rep.d.publish(h, rep.rid, "device")
    rep.tables.append(t)


def _check_invariants(reps, directory):
    for rep in reps:
        holds = np.zeros(rep.pool.n_blocks, np.int64)
        for t in rep.tables:
            for b in t.blocks:
                holds[b] += 1
        for b in rep.ix.indexed_blocks():
            holds[b] += 1
        for b in range(1, rep.pool.n_blocks):
            assert rep.pool.ref(b) == holds[b], (rep.rid, b)
        assert not set(rep.ix._block_of) & set(rep.host.hashes()), rep.rid
        assert len(rep.host) <= rep.host.capacity
    for h, m in directory._res.items():
        for rid, tier in m.items():
            rep = reps[rid]
            if tier == "device":
                assert rep.ix.lookup(h) is not None, (h, rid)
            else:
                assert h in rep.host, (h, rid)


def _interleave(mod, seed, n_ops=40):
    bm = mod.bm
    rng = np.random.RandomState(seed % (2 ** 31))
    bs = 4
    d = mod.ck.ClusterPrefixDirectory()
    reps = [_Rep(bm, 0, d, 5, bs, 3), _Rep(bm, 1, d, 7, bs, 2)]
    for _ in range(n_ops):
        rep = reps[rng.randint(len(reps))]
        peers = [r for r in reps if r is not rep]
        op = rng.randint(4)
        if op == 0:                     # admit from a tiny alphabet
            n_tok = rng.randint(1, 3 * bs + 2)
            _admit(bm, rep, peers, rng.randint(0, 3, size=n_tok), bs)
        elif op == 1 and rep.tables:    # finish a request
            rep.tables.pop(rng.randint(len(rep.tables))).release()
        elif op == 2:                   # eviction pressure -> demotions
            rep.ix.evict(rng.randint(1, 3))
        else:                           # host churn via repeat admits
            n_tok = rng.randint(bs, 2 * bs + 1)
            _admit(bm, rep, peers, rng.randint(0, 2, size=n_tok), bs)
        _check_invariants(reps, d)
    state = (sorted((h, sorted(m.items())) for h, m in d._res.items()),
             [(r.host.hashes(), sorted(r.ix.indexed_blocks()),
               [t.blocks for t in r.tables]) for r in reps])
    for rep in reps:
        for t in rep.tables:
            t.release()
        rep.tables = []
    _check_invariants(reps, d)
    return state


@pytest.mark.parametrize("seed", range(8))
def test_tier_invariants_seeded_equal_reference(seed):
    s = seed * 7919 + 13
    assert _interleave(P, s) == _interleave(J, s)


# ---------------------------------------------------------------------------
# Routing: tiebreaks and prefix-aware dispatch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    cfg = get_config("granite-8b").reduced()
    tree = jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(0)))
    jparams = jax.tree.map(jnp.asarray, tree)
    pcfg = port_config("granite-8b").reduced()
    pparams = bridge.params_from_numpy(tree, device="cpu")
    dev = jax.devices()[0]

    def pipe(mod, split):
        if mod is J:
            return JPipe(cfg, jparams, split, [[dev]] * len(split))
        return PPipe(pcfg, pparams, split, device="cpu")
    return cfg, pipe


def _router(weights, mod, **kw):
    cfg, pipe = weights
    base = dict(n_slots=2, max_len=48, cache_layout="paged", block_size=8,
                prefix_caching=True)
    base.update(kw)
    return mod.router.Router([pipe(mod, [cfg.num_layers]) for _ in range(2)],
                             **base)


def test_router_picks_the_reference_replica(weights):
    req = {m: m.req.Request(rid=0, prompt=np.arange(24, dtype=np.int32),
                            max_new_tokens=2, arrival=0.0) for m in (J, P)}
    # idle workers tie on load: the lowest replica id, in either order
    for mod in (J, P):
        r = _router(weights, mod)
        assert r._dispatch(list(r.workers), req[mod], 0.0).replica_id == 0
        assert r._dispatch(list(reversed(r.workers)), req[mod],
                           0.0).replica_id == 0
    # a seeded draw routes as the reference's, call for call
    picks = {}
    for mod in (J, P):
        r = _router(weights, mod, route_seed=123)
        picks[mod] = [r._dispatch(list(r.workers), req[mod], 0.0).replica_id
                      for _ in range(12)]
    assert picks[P] == picks[J] and len(set(picks[P])) == 2
    # prefix affinity: device blocks full, host blocks discounted, weight 0
    # back to least-loaded
    seen = {}
    for mod in (J, P):
        r = _router(weights, mod, cluster_prefix=True, route_seed=5)
        assert r.cluster_dir is not None
        hs = mod.bm.chunk_hashes(req[mod].prompt, 8)
        out = []
        for tier, upto in (("device", 3), ("host", 3), ("device", 1)):
            for h in hs[:upto]:
                r.cluster_dir.publish(h, 1, tier)
            out.append(r._dispatch(list(r.workers), req[mod], 0.0).replica_id)
        r.prefix_route_weight = 0.0
        out.append(r._dispatch(list(r.workers), req[mod], 0.0).replica_id)
        seen[mod] = out
    assert seen[P] == seen[J]
    assert seen[P][:2] == [1, 1]


# ---------------------------------------------------------------------------
# End to end: the tiers are invisible to the token stream
# ---------------------------------------------------------------------------

def _families(mod, cfg):
    reqs = []
    for i in range(6):
        rng = np.random.RandomState(100 + i % 3)      # 3 prompt families
        prompt = rng.randint(0, cfg.vocab_size, size=24).astype(np.int32)
        reqs.append(mod.req.Request(rid=i, prompt=prompt, max_new_tokens=4,
                                    arrival=0.3 * i))
    return reqs


@pytest.fixture(scope="module")
def cold(weights):
    """The port's cold contiguous serve of the three prompt families, per
    pool precision (what the tiers must reproduce)."""
    cfg, pipe = weights
    out = {}
    for kv in (None, "int8"):
        reqs = _families(P, cfg)
        w = (pcont.PipelineBatcher(pipe(P, [1, cfg.num_layers - 1]),
                                   n_slots=2, max_len=48) if kv is None
             else pcont.PagedPipelineBatcher(
                 pipe(P, [1, cfg.num_layers - 1]), n_slots=2, max_len=48,
                 block_size=8, kv_dtype=kv))
        w.serve(reqs, deadline=1e9)
        out[kv] = [list(r.output) for r in reqs]
    return out


CASES = {
    # device pools too small for three 24-token families: evictions demote
    # to the host tier and revisits promote back
    "host-tier": (1, dict(stage_blocks=[10, 10], prefix_caching=True,
                          host_blocks=64, host_swap_cost=0.05,
                          prefill_token_cost=0.125)),
    # two replicas behind one directory: a prompt landing on the replica
    # that never saw its family fetches the pages from the peer
    "cluster-fetch": (2, dict(prefix_caching=True,
                              prefill_token_cost=0.125)),
    # pools tight enough that decode growth preempts; the victim's prefix
    # demotes and the re-admission promotes it
    "preempt-host": (1, dict(n_slots=3, stage_blocks=[9, 9],
                             prefix_caching=True, host_blocks=64,
                             prefill_token_cost=0.125)),
    # the same on int8 pages: the one-byte payloads spill and travel with
    # their scales
    "host-tier-int8": (1, dict(stage_blocks=[10, 10], prefix_caching=True,
                               host_blocks=64, host_swap_cost=0.05,
                               kv_dtype="int8")),
    "cluster-fetch-int8": (2, dict(prefix_caching=True, kv_dtype="int8")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tiered_serving_equals_cold_and_reference(weights, cold, case):
    cfg, pipe = weights
    n_rep, kw = CASES[case]
    res = {}
    for mod in (J, P):
        reqs = _families(mod, cfg)
        base = dict(n_slots=2, max_len=48, block_size=8)
        base.update(kw)
        ws = [mod.cont.PagedPipelineBatcher(
            pipe(mod, [1, cfg.num_layers - 1]), replica_id=i, **base)
            for i in range(n_rep)]
        directory = mod.ck.wire_cluster_prefix(ws) if n_rep > 1 else None
        stats = mod.loop.run_serve_loop(ws, reqs, deadline=1e9,
                                        clock=mod.loop.VirtualClock())
        res[mod] = (reqs, stats, directory)
    (jr, js, jd), (pr, ps, pd) = res[J], res[P]
    for a, b in zip(jr, pr):
        assert list(b.output) == list(a.output), a.rid
        assert (b.start_time, b.first_token_time, b.finish_time) \
            == (a.start_time, a.first_token_time, a.finish_time), a.rid
    for f in dataclasses.fields(ploop.ServeStats):
        assert getattr(ps, f.name) == getattr(js, f.name), f.name
    assert [list(r.output) for r in pr] == cold[kw.get("kv_dtype")]
    if n_rep > 1:
        assert ps.prefix_fetches > 0 and ps.prefix_fetched_bytes > 0
        assert len(pd) == len(jd) > 0 and "fetch=" in ps.summary()
    else:
        assert ps.host_promotions > 0
        if case.startswith("host-tier"):
            assert ps.host_demotions > 0 and ps.host_hit_tokens > 0
            assert "host=" in ps.summary()
