"""Speculative decoding in the port against the JAX package: the two new
kernels' plain versions (contiguous decode, paged verification) against
the Pallas kernels in interpret mode and the ref.py oracles; the
contiguous draft-model cache and the paged verification step against the
reference model; the acceptance rules and proposers; BlockTable.truncate;
and spec-enabled serving, token and counter identical to the reference on
the same bridged weights, and token identical to plain greedy decode.

Inputs come from numpy seeds; weights are bridged from
repro.models.model.init_params (reduced llama2-70b, fp32). Kernel checks
use atol 2e-5 (test_torch_kernels.py), model logits atol = rtol = 1e-4
(test_torch_models.py: float32 sums run in another order). Each test
names the reference test it mirrors."""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.plan import Assignment, PipelinePlan, StagePlan
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.paged_attention import paged_verify_attention_pallas
from repro.models import model as JM
from repro.serving import request as jreq
from repro.serving import spec as jspec
from repro.serving.continuous import PagedPipelineBatcher as JBatcher
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving.loop import VirtualClock as JClock
from repro.serving.loop import run_serve_loop as j_serve_loop
from repro.serving.pipeline import AsymmetricPipeline as JPipeline
from repro_torch import bridge
from repro_torch.configs import get_config as port_config
from repro_torch.core import plan as port_plan
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import model as PM
from repro_torch.serving import block_manager as pbm
from repro_torch.serving import request as preq
from repro_torch.serving import spec as pspec
from repro_torch.serving.continuous import PagedPipelineBatcher as PBatcher
from repro_torch.serving.engine import InferenceEngine as PEngine
from repro_torch.serving.loop import VirtualClock as PClock
from repro_torch.serving.loop import run_serve_loop as p_serve_loop
from repro_torch.serving.pipeline import AsymmetricPipeline as PPipeline

from _torch_threads import one_torch_thread  # noqa: F401

ATOL = 2e-5
TOL = dict(atol=1e-4, rtol=1e-4)
COUNTERS = ("latencies", "iterations", "prefill_tokens", "prefix_lookups",
            "prefix_hits", "prefix_hit_tokens", "cow_copies", "preemptions",
            "spec_steps", "spec_proposed", "spec_accepted", "spec_tokens")


def _rn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(port, want, what):
    err = float(np.abs(port.numpy() - np.asarray(want)).max())
    assert err <= ATOL, f"{what}: max abs err {err}"


@pytest.fixture(scope="module")
def weights():
    cfg = get_config("llama2-70b").reduced()
    tree = jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(0)))
    return cfg, port_config("llama2-70b").reduced(), tree


# --- kernel #8: contiguous decode (mirrors tests/test_kernels.py:101) -------

DECODE_CASES = {
    # S = 100 against a 32-key block: the Pallas kernel pads a ragged tail
    "ragged-S": dict(S=100, kv_block=32, kv_len=[71, 100]),
    # a left kv_start on one row, kv_len on both
    "kv_start": dict(S=64, kv_block=32, kv_len=[50, 64], kv_start=[9, 0]),
    # no kv_len: every cache position is live
    "full": dict(S=96, kv_block=64),
    # row 1 has no live key (kv_start >= kv_len): exact zeros
    "dead-row": dict(S=64, kv_block=32, kv_len=[33, 20], kv_start=[0, 20]),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
@pytest.mark.parametrize("hq,hkv,d", [(4, 2, 32), (8, 2, 64),
                                      (16, 2, 128)])  # g 8, as served
def test_decode_attention_matches_pallas(case, hq, hkv, d):
    rng = np.random.default_rng(3)
    kw = dict(DECODE_CASES[case])
    S, kv_block = kw.pop("S"), kw.pop("kv_block")
    b = 2
    q, k, v = _rn(rng, b, 1, hq, d), _rn(rng, b, S, hkv, d), \
        _rn(rng, b, S, hkv, d)
    jkw = {n: jnp.asarray(np.asarray(x, np.int32)) for n, x in kw.items()}
    tkw = {n: torch.tensor(x, dtype=torch.int32) for n, x in kw.items()}
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    port = ops.decode_attention(*map(torch.from_numpy, (q, k, v)), **tkw)
    _close(port, decode_attention_pallas(jq, jk, jv, kv_block=kv_block,
                                         interpret=True, **jkw),
           "vs Pallas (interpret)")
    _close(port, jref.decode_attention_ref(jq, jk, jv, **jkw),
           "vs repro.kernels.ref")
    if case == "dead-row":
        assert torch.count_nonzero(port[1]) == 0


# kernel #8's split count, (b, hq, hkv, S, sms) -> splits per row: the
# fewest that give each of `sms` SMs ~BLOCKS_PER_SM blocks of (row, kv
# head, group of <= 8 query heads, split), capped by S's 64-key shares and
# by the kernel's 64. How the kernel divides a row's live keys among the
# splits is checked on the card (chip_smoke.py, contiguous_decode_cases).
SPLIT_COUNTS = {
    "timing shape": ((16, 64, 8, 2048, 132), 4),
    "Jamba's width": ((16, 32, 8, 2048, 132), 4),
    "one row on 8 SMs": ((1, 64, 8, 2048, 8), 3),
    "one row on 132 SMs, capped by S": ((1, 64, 8, 2048, 132), 32),
    "g 1 capped by S": ((1, 8, 1, 2048, 1000), 32),
    "capped by the kernel's limit": ((1, 8, 1, 8192, 1000), 64),
    "S 65 takes two": ((1, 8, 1, 65, 132), 2),
    "tiny cache": ((4, 16, 2, 40, 132), 1),
    "one SM": ((16, 64, 8, 2048, 1), 1),
    "g 16, two head groups": ((4, 32, 2, 2048, 132), 25),
}


@pytest.mark.parametrize("case", sorted(SPLIT_COUNTS))
def test_contiguous_decode_splits_fill_the_card(case):
    (b, hq, hkv, S, sms), want = SPLIT_COUNTS[case]
    n = da.contiguous_splits(b, hq, hkv, S, sms)
    assert n == want
    blocks = b * hkv * -(-(hq // hkv) // da.HEADS)
    cap = min(da.MAX_SPLITS, -(-S // da.KEYS_PER_SPLIT))
    assert 1 <= n <= cap
    if n < cap:  # the fewest splits that fill the card
        assert blocks * n >= da.BLOCKS_PER_SM * sms
        assert n == 1 or blocks * (n - 1) < da.BLOCKS_PER_SM * sms


# the paged decode kernel (#2) runs the same body through a block table and
# takes its split count from the table's capacity, max_blocks x block_size:
# (b, hq, hkv, max_blocks, block_size, sms) -> splits
PAGED_SPLIT_COUNTS = {
    "16 rows, 128 pages of 16 (timing shape)": ((16, 64, 8, 128, 16, 132), 4),
    "one row, 128 pages of 16": ((1, 64, 8, 128, 16, 132), 32),
    "16 rows, 128 pages of 2": ((16, 64, 8, 128, 2, 132), 4),
    "one row, 128 pages of 2, capped by the capacity": (
        (1, 64, 8, 128, 2, 132), 4),
    "Jamba's width, 128 pages of 16": ((16, 32, 8, 128, 16, 132), 4),
}


@pytest.mark.parametrize("case", sorted(PAGED_SPLIT_COUNTS))
def test_paged_decode_splits_follow_the_table_capacity(case):
    (b, hq, hkv, nb, bs, sms), want = PAGED_SPLIT_COUNTS[case]
    n = pa.paged_decode_splits(b, hq, hkv, nb, bs, sms)
    assert n == want
    assert n == da.contiguous_splits(b, hq, hkv, nb * bs, sms)


# --- kernel #4: paged verification (mirrors tests/test_spec.py:42-95) -------

def _pool_and_tables(rng, b, nb, n_blocks, bs, hkv, d):
    kp, vp = _rn(rng, n_blocks, bs, hkv, d), _rn(rng, n_blocks, bs, hkv, d)
    perm = rng.permutation(np.arange(1, n_blocks))[:b * nb]
    return kp, vp, perm.reshape(b, nb).astype(np.int32)


VERIFY_CASES = {
    # per-slot starts (page boundary, mid-page), ragged candidate counts
    # (row 1's padding candidates still see its committed keys) and a dead
    # row: a free slot, kv_start == kv_len == 0 on an all-null table
    "ragged+dead": (4, [16, 21, 0], [16 + 4, 21 + 2, 0]),
    # T = 1: the bonus token alone is a decode step
    "T=1": (1, [11, 19, 5], [12, 20, 6]),
}


@pytest.mark.parametrize("case", sorted(VERIFY_CASES))
@pytest.mark.parametrize("hq,hkv,d", [(4, 2, 32), (8, 2, 64)])
def test_paged_verify_matches_pallas(case, hq, hkv, d):
    rng = np.random.default_rng(4)
    T, kv_start, kv_len = VERIFY_CASES[case]
    b, nb, bs = 3, 4, 8
    kp, vp, bt = _pool_and_tables(rng, b, nb, 16, bs, hkv, d)
    kv_start, kv_len = (np.asarray(x, np.int32) for x in (kv_start, kv_len))
    if case.endswith("dead"):
        bt[2] = 0
    q = _rn(rng, b, T, hq, d)
    jargs = tuple(map(jnp.asarray, (q, kp, vp, bt)))
    jkw = dict(kv_start=jnp.asarray(kv_start), kv_len=jnp.asarray(kv_len))
    targs = tuple(map(torch.from_numpy, (q, kp, vp, bt)))
    tkw = dict(kv_start=torch.from_numpy(kv_start),
               kv_len=torch.from_numpy(kv_len))
    port = ops.paged_verify_attention(*targs, **tkw)
    _close(port, paged_verify_attention_pallas(*jargs, interpret=True,
                                               **jkw),
           "vs Pallas (interpret)")
    _close(port, jref.paged_verify_attention_ref(*jargs, **jkw),
           "vs repro.kernels.ref")
    if case.endswith("dead"):
        assert torch.count_nonzero(port[2]) == 0
    else:
        # a one-candidate chunk is exactly a paged decode step
        _close(port, ops.paged_decode_attention(*targs, kv_len=tkw["kv_len"]),
               "vs paged decode")


# Kernel #4's decomposition on the card (csrc/decode.cuh, VERIFY): a verify
# step is T paged decodes, candidate t of row i seeing keys
# [0, min(kv_len, kv_start + t + 1)). Each case: T, kv_start, candidate
# counts (kv_len - kv_start): ragged counts, a dead row (a free slot: kv_len
# 0 on an all-null table) and F2's row, kv_len == kv_start > 0, whose
# candidates all see the committed keys
PER_CANDIDATE_CASES = {
    "T=5": (5, [16, 21, 0, 30], [5, 2, 0, 0]),
    "T=8": (8, [3, 12, 0, 25], [8, 5, 0, 0]),
}


@pytest.mark.parametrize("case", sorted(PER_CANDIDATE_CASES))
@pytest.mark.parametrize("hq,hkv,d", [(2, 2, 32), (4, 2, 32),
                                      (8, 2, 64)])  # g 1, 2, 4
def test_paged_verify_is_per_candidate_decode(case, hq, hkv, d):
    rng = np.random.default_rng(5)
    T, kv_start, count = PER_CANDIDATE_CASES[case]
    b, nb, bs = 4, 6, 8
    kp, vp, bt = _pool_and_tables(rng, b, nb, 32, bs, hkv, d)
    bt[2] = 0
    kv_start = np.asarray(kv_start, np.int32)
    kv_len = kv_start + np.asarray(count, np.int32)
    q = _rn(rng, b, T, hq, d)
    targs = tuple(map(torch.from_numpy, (q, kp, vp, bt)))
    port = ops.paged_verify_attention(*targs,
                                      kv_start=torch.from_numpy(kv_start),
                                      kv_len=torch.from_numpy(kv_len))
    per_t = torch.cat([ops.paged_decode_attention(
        targs[0][:, t:t + 1], *targs[1:],
        kv_len=torch.from_numpy(np.minimum(kv_len, kv_start + t + 1)))
        for t in range(T)], 1)
    _close(port, per_t.numpy(), "vs T per-candidate paged decodes")
    want = paged_verify_attention_pallas(
        *map(jnp.asarray, (q, kp, vp, bt)), kv_start=jnp.asarray(kv_start),
        kv_len=jnp.asarray(kv_len), interpret=True)
    _close(port, want, "verify vs Pallas (interpret)")
    _close(per_t, want, "per-candidate decodes vs Pallas (interpret)")
    assert torch.count_nonzero(port[2]) == 0
    assert torch.count_nonzero(port[3]) > 0       # F2: not a dead row


@pytest.mark.parametrize("T", [1, 5, 8])
@pytest.mark.parametrize("g", [1, 2, 4, 8, 16])
def test_verify_columns_cover_each_candidate_and_head_once(g, T):
    """The verify kernel's column packing (csrc/decode.cuh VCols): column c
    of column group cg and head group grp is candidate cg cp + c // gb and
    head grp HEADS + c % gb (gb = min(g, HEADS)); together the blocks hold
    every (candidate, head) pair of a kv head exactly once, and the merge
    counters they need (b hkv groups cgroups) fit the wrapper's b T hq."""
    cp, cgroups = pa.verify_columns(T, g)
    assert cp == min(T, max(1, da.HEADS // g))
    assert cgroups == -(-T // cp)
    groups, gb = -(-g // da.HEADS), min(g, da.HEADS)
    seen = [(cg * cp + c // gb, grp * da.HEADS + c % gb)
            for cg in range(cgroups) for grp in range(groups)
            for c in range(da.HEADS)
            if c < cp * gb and cg * cp + c // gb < T
            and grp * da.HEADS + c % gb < g]
    assert sorted(seen) == [(t, h) for t in range(T) for h in range(g)]
    b, hkv = 3, 2
    assert b * hkv * groups * cgroups <= b * T * g * hkv


# kernel #4's split count, (b, T, hq, hkv, max_blocks, block_size, sms) ->
# splits: paged decode's rule over the table's capacity, its blocks counted
# with the column groups
VERIFY_SPLIT_COUNTS = {
    "timing shape, g 8 T 5: 5 column groups": ((16, 5, 64, 8, 128, 16, 132),
                                               1),
    "one row, g 8 T 5": ((1, 5, 64, 8, 128, 16, 132), 10),
    "Jamba's width, g 4 T 5: 3 column groups": (
        (16, 5, 32, 8, 128, 16, 132), 2),
    "g 1 T 8: one column group": ((16, 8, 8, 8, 128, 16, 132), 4),
    "g 16 T 5: two head groups": ((4, 5, 32, 2, 128, 16, 132), 5),
}


@pytest.mark.parametrize("case", sorted(VERIFY_SPLIT_COUNTS))
def test_paged_verify_splits_count_column_groups(case):
    (b, T, hq, hkv, nb, bs, sms), want = VERIFY_SPLIT_COUNTS[case]
    n = pa.paged_verify_splits(b, T, hq, hkv, nb, bs, sms)
    assert n == want
    cgroups = pa.verify_columns(T, hq // hkv)[1]
    assert n == da.contiguous_splits(b, hq, hkv, nb * bs, sms,
                                     column_groups=cgroups)
    blocks = b * hkv * -(-(hq // hkv) // da.HEADS) * cgroups
    cap = min(da.MAX_SPLITS, -(-nb * bs // da.KEYS_PER_SPLIT))
    if n < cap:  # the fewest splits that fill the card
        assert blocks * n >= da.BLOCKS_PER_SM * sms
        assert n == 1 or blocks * (n - 1) < da.BLOCKS_PER_SM * sms


def test_quantized_kernels_have_merge_counters_of_their_own(monkeypatch):
    """#5 and #7 merge their splits in the launch (csrc/decode.cuh), as #2
    and #4 do, on a counter buffer of their own: each of the four wrappers
    names its own kernel (its ops.KERNELS key) to the launch, and the four
    buffers are distinct, so a quantized and an unquantized launch in one
    serving step never share counters."""
    named = {}

    def recorder(body):
        def launch(kernel, q, *args):
            named[kernel] = body
            return q.new_zeros(q.shape)
        return launch

    monkeypatch.setattr(pa, "_decode", recorder("decode"))
    monkeypatch.setattr(pa, "_verify", recorder("verify"))
    for fn in ops.KERNELS.values():    # the wrappers count their calls
        monkeypatch.setattr(fn, "launches", fn.launches)
    q, pages = torch.zeros(2, 1, 4, 32), torch.zeros(3, 16, 2, 32)
    scales = torch.zeros(3, 16, 2)
    tbl, lens = torch.zeros(2, 1, dtype=torch.int32), torch.ones(2)
    for fn in (pa.paged_decode_attention_cuda,
               pa.paged_decode_attention_quant_cuda):
        quant = (scales, scales) if "quant" in fn.__name__ else ()
        fn(q, pages, pages, *quant, tbl, kv_len=lens)
    for fn in (pa.paged_verify_attention_cuda,
               pa.paged_verify_attention_quant_cuda):
        quant = (scales, scales) if "quant" in fn.__name__ else ()
        fn(q, pages, pages, *quant, tbl, kv_start=lens, kv_len=lens)
    assert named == {"paged_decode_attention": "decode",
                     "paged_decode_attention_quant": "decode",
                     "paged_verify_attention": "verify",
                     "paged_verify_attention_quant": "verify"}
    assert all(ops.KERNELS[k].__name__ == k + "_cuda" for k in named)
    bufs = [da.merge_counters(k, 64, "cpu") for k in named]
    assert len({b.data_ptr() for b in bufs}) == 4
    assert all(b.numel() >= 64 and not b.any() for b in bufs)


# --- model level -----------------------------------------------------------

def test_contiguous_prefill_and_decode_match_reference(weights):
    """Mirrors the draft model's path in tests/test_spec.py:187: right-padded
    prefill with lens into the contiguous cache, then per-row decode."""
    cfg, pcfg, tree = weights
    rng = np.random.default_rng(5)
    b, S = 3, 32
    lens = np.array([7, 12, 3], np.int32)
    toks = np.zeros((b, 16), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    jparams = jax.tree.map(jnp.asarray, tree)
    pparams = bridge.params_from_numpy(tree, device="cpu")
    jl, jc = JM.prefill(cfg, jparams, {"tokens": jnp.asarray(toks)},
                        JM.init_cache(cfg, b, S), lens=jnp.asarray(lens))
    pc = PM.init_cache(pcfg, b, S, device="cpu")
    pl, _ = PM.prefill(pcfg, pparams, {"tokens": toks}, pc, lens=lens)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(pc["sub0"]["k"].numpy(),
                               np.asarray(jc["sub0"]["k"]), **TOL)
    pos = lens.copy()
    for step in range(3):
        nxt = rng.integers(0, cfg.vocab_size, b).astype(np.int32)
        jl, jc = JM.decode_step(cfg, jparams, jnp.asarray(nxt), jc,
                                jnp.asarray(pos))
        pl, _ = PM.decode_step(pcfg, pparams, torch.from_numpy(nxt), pc,
                               torch.from_numpy(pos))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl),
                                   err_msg=f"decode {step}", **TOL)
        pos += 1
    for n in ("k", "v"):
        np.testing.assert_allclose(pc["sub0"][n].numpy(),
                                   np.asarray(jc["sub0"][n]), **TOL)
    # a decode step that masks each row's first kv_start keys
    kv_start = np.array([0, 2, 1], np.int32)
    nxt = rng.integers(0, cfg.vocab_size, b).astype(np.int32)
    jl, _ = JM.decode_step(cfg, jparams, jnp.asarray(nxt), jc,
                           jnp.asarray(pos), kv_start=jnp.asarray(kv_start))
    pl, _ = PM.decode_step(pcfg, pparams, torch.from_numpy(nxt), pc,
                           torch.from_numpy(pos),
                           kv_start=torch.from_numpy(kv_start))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)


def test_verify_step_paged_matches_reference(weights):
    """Mirrors tests/test_spec.py:98: one multi-token verification step
    through the pages, with ragged candidate counts and a dead row, gives
    the reference's logits at every position and the same page writes."""
    cfg, pcfg, tree = weights
    rng = np.random.default_rng(6)
    n_slots, T, bs, nbmax, n_blocks = 3, 4, 8, 4, 13
    L = cfg.num_layers
    hkv, hd = cfg.num_kv_heads, cfg.head_dim_
    # committed context already in the pages (random K/V)
    pages = {n: _rn(rng, L, n_blocks, bs, hkv, hd) * 0.5 for n in ("k", "v")}
    bt = np.array([[3, 1, 4, 0], [5, 9, 2, 6], [0, 0, 0, 0]], np.int32)
    kv_start = np.array([13, 17, 0], np.int32)
    q_len = np.array([4, 2, 0], np.int32)           # row 2: a dead row
    toks = rng.integers(0, cfg.vocab_size, (n_slots, T)).astype(np.int32)
    jl, jc = JM.verify_step_paged(
        cfg, jax.tree.map(jnp.asarray, tree), jnp.asarray(toks),
        {"sub0": {n: jnp.asarray(a) for n, a in pages.items()}},
        jnp.asarray(kv_start), jnp.asarray(q_len), jnp.asarray(bt))
    caches = [{n: torch.from_numpy(pages[n][i].copy()) for n in pages}
              for i in range(L)]
    pl, _ = PM.verify_step_paged(
        pcfg, bridge.params_from_numpy(tree, device="cpu"), toks, caches,
        kv_start, q_len, bt)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    for i in range(L):
        for n in ("k", "v"):          # block 0 takes the pads' garbage
            np.testing.assert_allclose(caches[i][n][1:].numpy(),
                                       np.asarray(jc["sub0"][n][i, 1:]),
                                       **TOL)


# --- acceptance rules and proposers (tests/test_spec.py:144-252) -------------

def test_acceptance_rules_match_reference():
    rng = np.random.default_rng(7)
    for _ in range(20):
        T, V = int(rng.integers(1, 6)), 8
        logits = rng.standard_normal((T, V)).astype(np.float32)
        chain = logits.argmax(-1)
        n = int(rng.integers(0, T))
        drafts = [int(chain[j]) if rng.random() < 0.7
                  else int(rng.integers(0, V)) for j in range(n)]
        bonus = int(rng.integers(0, V))
        assert pspec.greedy_accept(logits, bonus, drafts) == \
            jspec.greedy_accept(logits, bonus, drafts)
        pt = rng.dirichlet(np.ones(V), size=max(n, 1) + 1)
        pd = rng.dirichlet(np.ones(V), size=max(n, 1))
        u = rng.random(max(n, 1))
        assert pspec.rejection_sample_accept(pt, pd, drafts, u) == \
            jspec.rejection_sample_accept(pt, pd, drafts, u)


def test_ngram_proposer_matches_reference():
    rng = np.random.default_rng(8)
    items = [(i, rng.integers(0, 5, int(rng.integers(2, 30))).astype(
        np.int32), int(rng.integers(0, 5))) for i in range(40)]
    for lo, hi in ((1, 3), (2, 4)):
        got = pspec.NgramProposer(ngram_min=lo, ngram_max=hi).propose(items)
        want = jspec.NgramProposer(ngram_min=lo, ngram_max=hi).propose(items)
        assert sorted(got) == sorted(want)
        for s in want:
            assert list(got[s]) == list(want[s]), s


def test_draft_proposer_matches_reference(weights):
    """Mirrors tests/test_spec.py:187: the torch DraftModelProposer with
    bridged weights proposes the reference's tokens through a fresh sync, a
    full acceptance (no re-prefill), a partial one, and a release."""
    cfg, pcfg, tree = weights
    rng = np.random.default_rng(9)
    kw = dict(n_slots=3, max_len=40)
    jp = jspec.DraftModelProposer(cfg, jax.tree.map(jnp.asarray, tree), **kw)
    pp = pspec.DraftModelProposer(
        pcfg, bridge.params_from_numpy(tree, device="cpu"), device="cpu",
        **kw)
    hist = {0: rng.integers(0, cfg.vocab_size, 7).astype(np.int32),
            2: rng.integers(0, cfg.vocab_size, 12).astype(np.int32)}
    caps = {0: 3, 2: 2}
    for rnd in range(3):
        items = [(s, hist[s], caps[s]) for s in sorted(hist)]
        want = jp.propose(items)
        got = pp.propose(items)
        assert sorted(got) == sorted(want)
        for s in want:
            assert list(got[s]) == list(want[s]), (rnd, s)
        assert pp.draft_steps == jp.draft_steps
        for s in hist:                 # slot 0 accepts all, slot 2 one
            a = caps[s] if s == 0 else 1
            jp.commit(s, a)
            pp.commit(s, a)
            bonus = int(rng.integers(0, cfg.vocab_size))
            hist[s] = np.concatenate([hist[s], got[s][:a],
                                      np.asarray([bonus], np.int32)])
        assert list(pp._pos) == list(jp._pos)
    pp.release(0)
    jp.release(0)
    assert list(pp._pos) == list(jp._pos) and pp._pos[0] == 0


# --- BlockTable.truncate (mirrors tests/test_spec.py:260-299) ---------------

def test_truncate_frees_trailing_blocks():
    pool = pbm.BlockPool(8, block_size=4)
    t = pbm.BlockTable(pool)
    assert t.allocate_tokens(20)             # 5 blocks
    assert t.n_blocks == 5 and pool.n_free == 2
    assert t.truncate(9) == 2                # keep 3 blocks (9 tokens)
    assert t.n_blocks == 3 and pool.n_free == 4
    assert t.truncate(9) == 0                # idempotent
    assert t.truncate(0) == 3
    assert pool.n_free == 7 and t.n_blocks == 0


def test_truncate_shared_block_keeps_other_references():
    pool = pbm.BlockPool(8, block_size=4)
    ix = pbm.PrefixIndex(pool)
    t = pbm.BlockTable(pool)
    assert t.allocate_tokens(12)             # 3 blocks
    hashes = pbm.chunk_hashes(list(range(8)), 4)
    ix.register(hashes, t.blocks[:2])        # the index holds blocks 0..1
    shared = t.blocks[1]
    assert pool.ref(shared) == 2
    t.truncate(4)                            # drop blocks 1 and 2
    assert pool.ref(shared) == 1             # the index's reference lives
    assert ix.n_evictable() >= 1
    t2 = pbm.BlockTable(pool)
    t2.adopt(ix.acquire(hashes[:2]))
    assert t2.blocks[1] == shared and pool.ref(shared) == 2
    t.release()
    t2.release()
    ix.evict(len(ix))
    assert pool.n_free == pool.n_blocks - 1  # nothing stranded


# --- serving ------------------------------------------------------------------

def _synth(mod, vocab):
    return mod.synth_workload(rate=40.0, duration=0.25, vocab=vocab,
                              prompt_len=8, prompt_jitter=5, out_len=6,
                              seed=1)


def _shared(mod, vocab):
    return mod.shared_prefix_workload(rate=4.0, duration=2.0, vocab=vocab,
                                      shared_len=24, unique_len=6,
                                      out_len=6, seed=3)


WORKLOADS = {
    # tests/test_spec.py:335 at engine level: n-gram speculation
    "serving": (_synth, dict(block_size=8)),
    # tests/test_spec.py:365: speculation with prefix caching + chunking
    "prefix": (_shared, dict(block_size=8, prefix_caching=True,
                             prefill_chunk=16)),
}


def _asg(mod):
    return mod.Assignment([mod.PipelinePlan([mod.StagePlan([0], 1),
                                             mod.StagePlan([1], 1)])])


def _same_tokens(want, got):
    assert len(want) == len(got) > 0
    for a, b in zip(want, got):
        assert a.output is not None and len(a.output) == a.max_new_tokens
        first = next((i for i, (x, y) in enumerate(zip(a.output, b.output))
                      if x != y), None)
        assert list(a.output) == list(b.output), \
            f"request {a.rid}: streams part at token {first}"


def _same_counters(want, got):
    for c in COUNTERS:
        assert getattr(got, c) == getattr(want, c), c


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_engine_ngram_spec_matches_reference(weights, name):
    """Engine-level n-gram speculation: the reference's tokens and every
    ServeStats counter (spec_* included), and plain greedy's tokens."""
    cfg, pcfg, tree = weights
    make, kw = WORKLOADS[name]
    common = dict(n_slots=4, max_len=48, spec_decode=True, spec_k=3, **kw)
    jreqs = make(jreq, cfg.vocab_size)
    jstats = JEngine(cfg, Assignment([PipelinePlan([StagePlan([0], 1),
                                                    StagePlan([1], 1)])]),
                     params=jax.tree.map(jnp.asarray, tree),
                     policy="continuous", cache_layout="paged",
                     **common).serve(jreqs, deadline=120.0, clock=JClock())
    pparams = bridge.params_from_numpy(tree, device="cpu")
    preqs = make(preq, pcfg.vocab_size)
    eng = PEngine(pcfg, _asg(port_plan), params=pparams, device="cpu",
                  cache_layout="paged", **common)
    pstats = eng.serve(preqs, deadline=120.0, clock=PClock())
    assert isinstance(eng.router.workers[0]._proposer, pspec.NgramProposer)
    _same_tokens(jreqs, preqs)
    _same_counters(jstats, pstats)
    assert pstats.spec_steps > 0
    assert pstats.spec_tokens == sum(len(r.output) for r in preqs)
    assert "spec=" in pstats.summary()
    plain = make(preq, pcfg.vocab_size)
    common.pop("spec_decode")
    PEngine(pcfg, _asg(port_plan), params=pparams, device="cpu",
            cache_layout="paged", **common).serve(plain, deadline=120.0,
                                                  clock=PClock())
    _same_tokens(plain, preqs)
    if name == "prefix":
        assert pstats.prefix_hits > 0


def _batcher_reqs(mod, cfg, *, n=4, max_new=8, seed=0):
    rng = np.random.RandomState(seed)
    return [mod.Request(rid=i,
                        prompt=rng.randint(0, cfg.vocab_size,
                                           size=5 + 3 * i).astype(np.int32),
                        max_new_tokens=max_new, arrival=0.02 * i)
            for i in range(n)]


@pytest.fixture(scope="module")
def pipes(weights):
    cfg, pcfg, tree = weights
    dev = jax.devices()[0]
    jparams = jax.tree.map(jnp.asarray, tree)
    pparams = bridge.params_from_numpy(tree, device="cpu")
    return (JPipeline(cfg, jparams, [1, 1], [[dev], [dev]]), jparams,
            PPipeline(pcfg, pparams, [1, 1], device="cpu"), pparams)


def test_batcher_self_draft_matches_reference_and_greedy(weights, pipes):
    """Mirrors tests/test_spec.py:348 and :454: the draft model is the
    target itself, its weights bridged into SpecConfig.draft_params; the
    port matches the reference's tokens and counters, plain greedy's
    tokens, and commits well over one token per target step."""
    cfg, pcfg, _ = weights
    jpipe, jparams, ppipe, pparams = pipes
    kw = dict(n_slots=3, max_len=48, block_size=8)
    jreqs = _batcher_reqs(jreq, cfg)
    jstats = j_serve_loop(
        [JBatcher(jpipe, spec=jspec.SpecConfig(
            k=3, proposer="draft", draft_cfg=cfg, draft_params=jparams),
            **kw)], jreqs, deadline=1e9, clock=JClock())
    preqs = _batcher_reqs(preq, pcfg)
    pstats = p_serve_loop(
        [PBatcher(ppipe, spec=pspec.SpecConfig(
            k=3, proposer="draft", draft_cfg=pcfg, draft_params=pparams),
            **kw)], preqs, deadline=1e9, clock=PClock())
    _same_tokens(jreqs, preqs)
    _same_counters(jstats, pstats)
    plain = _batcher_reqs(preq, pcfg)
    p_serve_loop([PBatcher(ppipe, **kw)], plain, deadline=1e9,
                 clock=PClock())
    _same_tokens(plain, preqs)
    assert pstats.spec_tokens == sum(len(r.output) for r in preqs)
    assert pstats.spec_accepted <= pstats.spec_proposed
    assert pstats.spec_tokens / pstats.spec_steps > 1.5


def test_batcher_spec_preemption_matches_reference(weights, pipes):
    """Mirrors tests/test_spec.py:386: pools too small for three 26-token
    generations preempt mid-speculation; the recomputed requests finish
    with the reference's tokens and counters, and plain greedy's tokens."""
    cfg, pcfg, _ = weights
    jpipe, _, ppipe, _ = pipes
    kw = dict(n_slots=3, max_len=32, block_size=8, stage_blocks=[9, 9],
              admit_headroom=2)

    def reqs(mod):
        rng = np.random.RandomState(1)
        return [mod.Request(rid=i, prompt=rng.randint(
                    0, cfg.vocab_size, size=6).astype(np.int32),
                    max_new_tokens=20, arrival=0.0) for i in range(3)]

    jreqs = reqs(jreq)
    jstats = j_serve_loop([JBatcher(jpipe, spec=jspec.SpecConfig(k=3),
                                    **kw)], jreqs, deadline=1e9,
                          clock=JClock())
    preqs = reqs(preq)
    pstats = p_serve_loop([PBatcher(ppipe, spec=pspec.SpecConfig(k=3),
                                    **kw)], preqs, deadline=1e9,
                          clock=PClock())
    assert pstats.preemptions > 0
    _same_tokens(jreqs, preqs)
    _same_counters(jstats, pstats)
    plain = reqs(preq)
    p_serve_loop([PBatcher(ppipe, n_slots=3, max_len=32, block_size=8)],
                 plain, deadline=1e9, clock=PClock())
    _same_tokens(plain, preqs)


def test_spec_virtual_clock_charges_draft_cost(weights, pipes):
    """Mirrors tests/test_spec.py:480 with the self-draft proposer (which
    always proposes): a positive draft_token_cost makes the same workload
    finish later, with the same tokens."""
    _, pcfg, _ = weights
    _, _, ppipe, pparams = pipes
    ends = []
    outs = []
    for cost in (0.0, 0.5):
        reqs = _batcher_reqs(preq, pcfg, n=2, max_new=6, seed=9)
        p_serve_loop([PBatcher(ppipe, n_slots=2, max_len=48, block_size=8,
                               spec=pspec.SpecConfig(
                                   k=3, proposer="draft", draft_cfg=pcfg,
                                   draft_params=pparams,
                                   draft_token_cost=cost))],
                     reqs, deadline=1e9, clock=PClock())
        ends.append(max(r.finish_time for r in reqs))
        outs.append([list(r.output) for r in reqs])
    assert ends[1] > ends[0] and outs[0] == outs[1]


def test_engine_self_draft_serves_greedy_tokens():
    """Mirrors tests/test_spec.py:348 through the engine's draft_model
    path, with its own seeded weights: target and draft both draw seed 0,
    so the draft is the target; tokens equal plain greedy and acceptance
    is near-total."""
    pcfg = port_config("llama2-70b").reduced()
    kw = dict(device="cpu", cache_layout="paged", n_slots=4, max_len=48,
              block_size=8)
    plain = _synth(preq, pcfg.vocab_size)
    PEngine(pcfg, _asg(port_plan), **kw).serve(plain, deadline=120.0,
                                                clock=PClock())
    reqs = _synth(preq, pcfg.vocab_size)
    eng = PEngine(pcfg, _asg(port_plan), spec_decode=True, spec_k=3,
                  draft_model=pcfg, **kw)
    stats = eng.serve(reqs, deadline=120.0, clock=PClock())
    assert isinstance(eng.router.workers[0]._proposer,
                      pspec.DraftModelProposer)
    _same_tokens(plain, reqs)
    assert stats.spec_tokens / stats.spec_steps > 1.5


def test_engine_spec_gating_matches_reference():
    """Mirrors tests/test_spec.py:454-478: spec_k < 1 warns and serves
    plain; a draft of another vocabulary falls back to n-gram with a
    warning; spec_ks gives each replica its depth, 0 = off."""
    pcfg = port_config("llama2-70b").reduced()
    kw = dict(device="cpu", cache_layout="paged", n_slots=2, max_len=32,
              block_size=8)
    with pytest.warns(UserWarning, match="plain decode"):
        eng = PEngine(pcfg, _asg(port_plan), spec_decode=True, spec_k=0,
                      **kw)
    assert eng.router.workers[0].spec is None
    other = dataclasses.replace(pcfg, vocab_size=pcfg.vocab_size + 1)
    with pytest.warns(UserWarning, match="n-gram"):
        eng = PEngine(pcfg, _asg(port_plan), spec_decode=True, spec_k=2,
                      draft_model=other, **kw)
    assert isinstance(eng.router.workers[0]._proposer, pspec.NgramProposer)
    two = port_plan.Assignment([
        port_plan.PipelinePlan([port_plan.StagePlan([2 * r], 1),
                                port_plan.StagePlan([2 * r + 1], 1)])
        for r in range(2)])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        eng = PEngine(pcfg, two, spec_decode=True, spec_k=2, spec_ks=[0, 3],
                      **kw)
    assert [w.spec.k if w.spec else 0 for w in eng.router.workers] == [0, 3]
    with pytest.raises(ValueError):
        pspec.SpecConfig(k=2, proposer="draft")
