"""Disaggregated prefill/decode in the port against the JAX package's, on
the CPU: the same bridged granite-8b (reduced, fp32) weights and the same
workloads through both packages' PagedPipelineBatchers on a VirtualClock.
Mirrors tests/test_disagg.py's engine-level cases: the page round trip
(pool -> wire -> pool across different stage splits, payload bytes equal
the reference's, int8 and fp8 pages with their scales), disaggregated
serving equal to colocated serving and to the reference's disaggregated
serve (tokens, timestamps and every ServeStats counter), with warm prefixes
and chunks, on int8 pages and under speculation on the decode replica,
the modelled transfer delaying the first token by bytes over bandwidth,
the decode replica's rejection of a migration it can never hold,
``KVLink.from_cluster``'s pair choice, and the engine's and Router's role
gating with the reference's warnings."""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import cluster as jcl
from repro.core.plan import Assignment, PipelinePlan, StagePlan
from repro.models import model as JM
from repro.serving import continuous as jcont
from repro.serving import disagg as jdis
from repro.serving import loop as jloop
from repro.serving import request as jreq
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving.pipeline import AsymmetricPipeline as JPipe
from repro.serving.spec import SpecConfig as JSpec
from repro_torch import bridge
from repro_torch.configs import get_config as port_config
from repro_torch.core import cluster as pcl
from repro_torch.core import plan as pplan
from repro_torch.serving import continuous as pcont
from repro_torch.serving import disagg as pdis
from repro_torch.serving import loop as ploop
from repro_torch.serving import request as preq
from repro_torch.serving.block_manager import BlockPool, BlockTable
from repro_torch.serving.engine import InferenceEngine as PEngine
from repro_torch.serving.pipeline import AsymmetricPipeline as PPipe
from repro_torch.serving.spec import SpecConfig as PSpec

BLOCK = 8
MAX_LEN = 48

class _Pkg:
    """One package's serving entry points, by role."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


J = _Pkg(Batcher=jcont.PagedPipelineBatcher, dis=jdis, loop=jloop,
         req=jreq, Spec=JSpec)
P = _Pkg(Batcher=pcont.PagedPipelineBatcher, dis=pdis, loop=ploop,
         req=preq, Spec=PSpec)


@pytest.fixture(scope="module")
def setup():
    """granite-8b reduced (2 layers, fp32): reference weights bridged into
    the port; pipes(split) -> {J: reference pipeline, P: port pipeline}."""
    cfg = get_config("granite-8b").reduced()
    tree = jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(0)))
    jparams = jax.tree.map(jnp.asarray, tree)
    pcfg = port_config("granite-8b").reduced()
    pparams = bridge.params_from_numpy(tree, device="cpu")
    dev = jax.devices()[0]
    L = cfg.num_layers

    def pipes(split=None):
        split = split if split is not None else [1, L - 1]
        return {J: JPipe(cfg, jparams, split, [[dev]] * len(split)),
                P: PPipe(pcfg, pparams, split, device="cpu")}
    return cfg, pipes, L


def _mk_reqs(mod, cfg, *, out_len=5, seed=3, n=6):
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        plen = 8 + int(rng.randint(0, 12))
        reqs.append(mod.req.Request(
            rid=i, prompt=rng.randint(0, cfg.vocab_size,
                                      size=plen).astype(np.int32),
            max_new_tokens=out_len, arrival=0.4 * i))
    return reqs


def _serve(mod, workers, reqs, roles=None, link=None):
    if roles is not None:
        mod.dis.wire_disaggregation(workers, roles, link)
    return mod.loop.run_serve_loop(workers, reqs, deadline=1e9,
                                   clock=mod.loop.VirtualClock())


def _same(jreqs, preqs, jstats, pstats):
    """Tokens, lifecycle timestamps and every ServeStats field equal."""
    assert len(jreqs) == len(preqs) > 0
    for a, b in zip(jreqs, preqs):
        assert a.output is not None
        assert list(b.output) == list(a.output), a.rid
        for t in ("start_time", "first_token_time", "prefill_finish_time",
                  "finish_time"):
            assert getattr(b, t) == getattr(a, t), (a.rid, t)
    for f in dataclasses.fields(ploop.ServeStats):
        assert getattr(pstats, f.name) == getattr(jstats, f.name), f.name


def _both(setup, run):
    """run(mod, pipes) on the reference and on the port."""
    _, pipes, _ = setup
    return run(J, lambda *a: pipes(*a)[J]), run(P, lambda *a: pipes(*a)[P])


# ---------------------------------------------------------------------------
# Wire round trip: pool -> extract -> scatter -> pool
# ---------------------------------------------------------------------------

def _bits(t):
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def _np_bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint8) if a.dtype.itemsize == 1 \
        and a.dtype != np.int8 else a


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
def test_kv_page_roundtrip_across_stage_splits(setup, kv_dtype):
    """Pages extracted from a [1, L-1] pipeline land bit-identically in a
    [L-1, 1] one (the wire format is per GLOBAL layer), quantized pools
    ship their one-byte payloads with their scale leaves, and the payload
    holds the reference's bytes: the same values poked into both packages'
    pools extract to the same arrays and the same byte count."""
    cfg, pipes, L = setup
    src, dst = pipes([1, L - 1]), pipes([L - 1, 1])
    for mod in (J, P):
        for p in (src[mod], dst[mod]):
            p.init_paged_caches(2, MAX_LEN, block_size=BLOCK,
                                kv_dtype=kv_dtype)
    rng = np.random.RandomState(0)
    src_blocks = [3, 1, 4]
    for si in range(len(src[P].stages)):
        for k, (jc, pc) in enumerate(zip(src[J].paged_caches[si],
                                         src[P].paged_caches[si])):
            for n in jc:
                arr = np.array(jc[n])
                shape = (3,) + arr.shape[1:]
                if kv_dtype == "int8" and n in ("k", "v"):
                    vals = rng.randint(-127, 128, size=shape)
                else:
                    vals = rng.standard_normal(shape)
                arr[src_blocks] = vals.astype(arr.dtype)
                jc[n] = jnp.asarray(arr)
                _bits(pc[n]).copy_(torch.from_numpy(_np_bits(arr)))
    jpay = src[J].extract_kv_pages([src_blocks] * len(src[J].stages))
    ppay = src[P].extract_kv_pages([src_blocks] * len(src[P].stages))
    assert len(ppay) == L
    assert pdis.KVMigration.payload_bytes(ppay) \
        == jdis.KVMigration.payload_bytes(jpay)
    for jl, pl in zip(jpay, ppay):
        assert sorted(pl) == sorted(jl)
        for n in jl:
            np.testing.assert_array_equal(_bits(pl[n]).numpy(),
                                          _np_bits(jl[n]))
    dst_blocks = [5, 2, 1]
    dst[P].scatter_kv_pages([dst_blocks] * len(dst[P].stages), ppay)
    back = dst[P].extract_kv_pages([dst_blocks] * len(dst[P].stages))
    for want, got in zip(ppay, back):
        for n in want:
            assert got[n].dtype == want[n].dtype
            assert torch.equal(_bits(got[n]), _bits(want[n]))
    # a payload of another precision than the pool's is refused: pages
    # land verbatim, never requantized
    if kv_dtype is not None:
        wide = [{n: t.float() for n, t in lkv.items()} for lkv in ppay]
        with pytest.raises(ValueError, match="verbatim"):
            dst[P].scatter_kv_pages([dst_blocks] * len(dst[P].stages), wide)


def test_block_table_adopt_takes_over_references():
    pool = BlockPool(6, block_size=4)
    donor = pool.alloc(2)
    t = BlockTable(pool)
    t.adopt(donor)
    assert t.blocks == donor and pool.n_free == 3
    t.release()
    assert pool.n_free == 5


# ---------------------------------------------------------------------------
# End-to-end: disaggregated == colocated == the reference
# ---------------------------------------------------------------------------

def test_disagg_identical_to_colocated_and_reference(setup):
    """Prefill on a [1, L-1] replica, decode on a [L-1, 1] replica (the
    stage splits differ): the port's tokens equal its colocated serve's
    and, with every counter and timestamp, the reference's disaggregated
    serve; every request migrates once."""
    cfg, pipes, L = setup
    col = _mk_reqs(P, cfg)
    _serve(P, [P.Batcher(pipes()[P], n_slots=4, max_len=MAX_LEN,
                         block_size=BLOCK)], col)

    def run(mod, pipe):
        reqs = _mk_reqs(mod, cfg)
        p = mod.Batcher(pipe([1, L - 1]), n_slots=4, max_len=MAX_LEN,
                        block_size=BLOCK, role="prefill")
        d = mod.Batcher(pipe([L - 1, 1]), n_slots=4, max_len=MAX_LEN,
                        block_size=BLOCK, role="decode")
        return reqs, _serve(mod, [p, d], reqs, ["prefill", "decode"],
                            mod.dis.KVLink())
    (jr, js), (pr, ps) = _both(setup, run)
    _same(jr, pr, js, ps)
    for rc, rd in zip(col, pr):
        assert list(rc.output) == list(rd.output), rc.rid
    assert ps.migrations == len(pr) and ps.migrated_kv_bytes > 0
    assert ps.rejected == 0 and ps.dropped == 0
    assert all(r.first_token_time >= r.prefill_finish_time for r in pr)
    assert "mig=" in ps.summary()


@pytest.mark.parametrize("case", ["prefix-chunks", "int8", "spec-decode"])
def test_disagg_features_equal_reference(setup, case):
    """The handoff composes with warm prefixes and mid-prefill chunking on
    the prefill replica, with int8 pages (the one-byte payload and its
    scales cross the link), and with speculative decoding on the decode
    replica, as in the reference: the same tokens and counters."""
    cfg, pipes, L = setup

    def run(mod, pipe):
        if case == "prefix-chunks":
            reqs = mod.req.shared_prefix_workload(
                rate=2.0, duration=4.0, vocab=cfg.vocab_size,
                shared_len=24, unique_len=6, out_len=5, seed=11)
            pkw = dict(prefix_caching=True, prefill_chunk=BLOCK)
            dkw = {}
        elif case == "int8":
            reqs = _mk_reqs(mod, cfg)
            pkw = dkw = dict(kv_dtype="int8")
        else:
            reqs = _mk_reqs(mod, cfg, out_len=8)
            pkw, dkw = {}, dict(spec=mod.Spec(k=2))
        p = mod.Batcher(pipe(), n_slots=4, max_len=MAX_LEN, block_size=BLOCK,
                        role="prefill", **pkw)
        d = mod.Batcher(pipe([L - 1, 1]), n_slots=4, max_len=MAX_LEN,
                        block_size=BLOCK, role="decode", **dkw)
        return reqs, _serve(mod, [p, d], reqs, ["prefill", "decode"],
                            mod.dis.KVLink(gbps=1e-3))
    (jr, js), (pr, ps) = _both(setup, run)
    _same(jr, pr, js, ps)
    assert ps.migrations == len(pr)
    if case == "prefix-chunks":
        assert ps.prefix_hits > 0
    if case == "spec-decode":
        assert ps.spec_steps > 0


# ---------------------------------------------------------------------------
# Transfer cost on the virtual clock
# ---------------------------------------------------------------------------

def test_transfer_cost_delays_first_token_by_bytes_over_bandwidth(setup):
    cfg, pipes, L = setup

    def one(mod):
        return [mod.req.Request(rid=0, prompt=np.arange(16, dtype=np.int32),
                                max_new_tokens=4, arrival=0.0)]

    ttft, seen = {}, {}
    for gbps in (0.0, 1e-6):      # ideal link vs ~125 B per clock unit
        def run(mod, pipe):
            reqs = one(mod)
            p = mod.Batcher(pipe(), n_slots=2, max_len=32, block_size=BLOCK,
                            role="prefill")
            d = mod.Batcher(pipe(), n_slots=2, max_len=32, block_size=BLOCK,
                            role="decode")
            st = _serve(mod, [p, d], reqs, ["prefill", "decode"],
                        mod.dis.KVLink(gbps=gbps))
            return reqs, st
        (jr, js), (pr, ps) = _both(setup, run)
        _same(jr, pr, js, ps)
        ttft[gbps] = pr[0].first_token_time
        seen[gbps] = ps.migrated_kv_bytes
    # whole blocks of K and V for every layer, fp32
    nb = -(-16 // BLOCK)
    want = nb * BLOCK * cfg.num_kv_heads * cfg.head_dim_ * 4 * 2 * L
    assert seen[0.0] == seen[1e-6] == want
    delay = want / (1e-6 * 1e9 / 8)
    assert ttft[1e-6] - ttft[0.0] == pytest.approx(delay, rel=1e-9)


def test_decode_replica_rejects_impossible_migration(setup):
    cfg, pipes, L = setup

    def run(mod, pipe):
        reqs = [mod.req.Request(rid=0, prompt=np.arange(24, dtype=np.int32),
                                max_new_tokens=8, arrival=0.0)]
        p = mod.Batcher(pipe(), n_slots=2, max_len=MAX_LEN, block_size=BLOCK,
                        role="prefill")
        d = mod.Batcher(pipe(), n_slots=2, max_len=MAX_LEN, block_size=BLOCK,
                        role="decode", stage_blocks=[3, 3])  # 2 usable
        with warnings.catch_warnings(record=True) as ws:
            warnings.simplefilter("always")
            st = _serve(mod, [p, d], reqs, ["prefill", "decode"],
                        mod.dis.KVLink())
        return (reqs, [str(w.message) for w in ws]), st
    ((jr, jw), js), ((pr, pw), ps) = _both(setup, run)
    assert pw == jw and any("cannot fit" in w for w in pw)
    assert ps.rejected == 1 and ps.migrations == 1
    assert not pr[0].served and pr[0].finish_time is not None
    for f in dataclasses.fields(ploop.ServeStats):
        assert getattr(ps, f.name) == getattr(js, f.name), f.name


# ---------------------------------------------------------------------------
# KVLink
# ---------------------------------------------------------------------------

def test_kvlink_from_cluster_picks_the_reference_pairs():
    """The per-pair link is the reference's: the same Pareto candidates per
    (src, dst) pair and the same min(lat + bytes / bw) per payload, on a
    hand-built pool whose two links trade latency against bandwidth and on
    the scheduler's case-study pool."""
    def hand(cl):
        devs = [cl.Device(i, "A6000", i, "r0") for i in range(3)]
        lat = np.zeros((3, 3))
        bw = np.full((3, 3), np.inf)
        lat[0, 1] = lat[1, 0] = 1e-3
        bw[0, 1] = bw[1, 0] = 1e6
        lat[0, 2] = lat[2, 0] = 1e-1
        bw[0, 2] = bw[2, 0] = 1e12
        return cl.Cluster(devs, lat=lat, bw=bw), [[0], [1, 2]]

    cases = [(hand(jcl), hand(pcl))]
    jpool, ppool = jcl.case_study_cluster(), pcl.case_study_cluster()
    groups = [[0, 1, 2, 3], [4, 5], [6, 7]]
    cases.append(((jpool, groups), (ppool, groups)))
    for (jc, jg), (pc, pg) in cases:
        jl = jdis.KVLink.from_cluster(jc, jg)
        pl = pdis.KVLink.from_cluster(pc, pg)
        assert pl._pairs == jl._pairs
        for n in (100, 10 ** 6, 10 ** 9):
            for (s, d) in jl._pairs:
                assert pl.delay(n, s, d) == jl.delay(n, s, d)
    small, big = 100, 10 ** 9
    pl = pdis.KVLink.from_cluster(*hand(pcl))
    assert pl.delay(small, 0, 1) == pytest.approx(1e-3 + small / 1e6)
    assert pl.delay(big, 0, 1) == pytest.approx(1e-1 + big / 1e12)
    flat = pdis.KVLink(gbps=8.0, latency=0.5)
    assert flat.delay(10 ** 9) == jdis.KVLink(gbps=8.0,
                                              latency=0.5).delay(10 ** 9)
    assert pdis.KVLink().delay(10 ** 9) == 0.0


# ---------------------------------------------------------------------------
# Engine / Router gating
# ---------------------------------------------------------------------------

def _asgs(L):
    mk = [(Assignment, PipelinePlan, StagePlan),
          (pplan.Assignment, pplan.PipelinePlan, pplan.StagePlan)]
    return [A([Pp([S([0], 1), S([1], L - 1)], 0.1, 0.1),
               Pp([S([2], L)], 0.1, 0.1)]) for A, Pp, S in mk]


def _engines(setup, **kw):
    """The same engine kwargs through both packages, with their warnings."""
    cfg, _, L = setup
    tree = jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(0)))
    jasg, pasg = _asgs(L)
    out = []
    for build in (lambda: JEngine(cfg, jasg,
                                  params=jax.tree.map(jnp.asarray, tree),
                                  **kw),
                  lambda: PEngine(port_config("granite-8b").reduced(), pasg,
                                  params=bridge.params_from_numpy(
                                      tree, device="cpu"),
                                  device="cpu", **kw)):
        with warnings.catch_warnings(record=True) as ws:
            warnings.simplefilter("always")
            eng = build()
        out.append((eng, [str(w.message) for w in ws]))
    return out


def test_engine_roles_and_gating(setup):
    common = dict(policy="continuous", n_slots=4, max_len=MAX_LEN,
                  block_size=BLOCK)
    (je, jw), (pe, pw) = _engines(setup, cache_layout="paged",
                                  disaggregate=True, **common)
    assert pe.roles == je.roles
    assert pe.roles.count("prefill") == pe.roles.count("decode") == 1
    assert [w.role for w in pe.router.workers] == pe.roles
    assert pe.router.dispatcher is not None
    # the contiguous layout cannot ship pages: colocated, with the
    # reference's warning
    (je, jw), (pe, pw) = _engines(setup, cache_layout="contiguous",
                                  disaggregate=True, **common)
    assert pe.roles == je.roles == ["both", "both"]
    assert pw == jw and any("colocated" in w for w in pw)
    # a disaggregated group shares one pool precision: the narrowest chosen
    (je, jw), (pe, pw) = _engines(setup, cache_layout="paged",
                                  roles=["prefill", "decode"],
                                  kv_dtypes=["int8", None], **common)
    assert pw == jw and any("one KV pool precision" in w for w in pw)
    assert [w.kv_dtype for w in pe.router.workers] \
        == [w.kv_dtype for w in je.router.workers] == ["int8", "int8"]
    # a per-pair link from the pool's matrices when a cluster is given
    (je, _), (pe, _) = _engines(setup, cache_layout="paged",
                                disaggregate=True, cluster=None,
                                kv_link_gbps=2.0, **common)
    assert pe.router.dispatcher.link.bandwidth \
        == je.router.dispatcher.link.bandwidth == 2.0 * 1e9 / 8
