"""chip_smoke.py phase 12 (f')'s bf16 gate over tensor-parallel shards of
a model with MoE layers (``_hold_routed``), on the CPU:

  * on hand-made rows: a row whose routing agrees in the TP-1, TP-2 and
    float32 replays is held to TP_BF16_ERR (2x) and fails at 2.5x; a row
    whose routing differs is counted with its first difference, not held,
    and passes at 10x; with fewer than TP_ROUTED_MIN_ROWS rows agreeing
    everywhere, the rows agreeing at the last position are held; a gate
    over fewer rows fails, naming the count;
  * on jamba-v0.1-52b reduced in bf16 with its 8-layer period over two
    shards (cpu:0, cpu:1), the whole path of the phase (``_bf16_tp_logits``
    with the routing recorded by ``_routing``, a float32 replay,
    ``_gate_bf16_tp(moe=True)``): the healthy shards pass, holding the
    rows that route alike everywhere; a mutant that scales each shard's
    partial by 1 + 2^-6 before the sum, and one that scales one shard's
    partial by 1 + 2^-5, fail it.
"""
import dataclasses
import os
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import model as PM
from repro_torch.serving.pipeline import AsymmetricPipeline

from _torch_threads import one_torch_thread  # noqa: F401

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

MOE_LAYERS = [1, 3]


def _rec(ratio, differs_at=None):
    """A hand-made row: TP 1's error 0.1, TP 2's `ratio` times it, no
    parting; routing over two MoE layers and six positions, TP 1's
    another expert at (MoE layer 1, position differs_at) if given."""
    r32 = torch.zeros((2, 6, 2), dtype=torch.long)
    r32[..., 1] = 1
    r1 = r32.clone()
    if differs_at is not None:
        r1[1, differs_at] = torch.tensor([0, 2])
    return dict(a=[5], b=[5], j=0, e1=0.1, e2=0.1 * ratio, diff=None,
                routes=(r1, r32.clone(), r32), replayed=(True, True))


CASES = {
    # (rows, the request that fails or None, held rows, how)
    "agreeing-2.5x-fails": ([_rec(1.1)] * 5 + [_rec(2.5)], "request 5",
                            None, None),
    "differing-10x-counted": ([_rec(1.1)] * 5 + [_rec(10.0, 3)], None,
                              [0, 1, 2, 3, 4], "every position"),
    "last-position-fallback": ([_rec(1.1)] * 3 + [_rec(1.2, 2)] * 3,
                               None, list(range(6)), "the last position"),
    "fallback-2.5x-fails": ([_rec(1.1)] * 3 + [_rec(1.2, 2)] * 2
                            + [_rec(2.5, 2)], "request 5", None, None),
    "too-few-rows-fail": ([_rec(1.1)] * 2 + [_rec(1.1, 5)] * 4,
                          "holds 2 rows", None, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_routed_gate_on_hand_made_rows(case):
    rows, fails, held, how = CASES[case]
    if fails:
        with pytest.raises(AssertionError, match=fails):
            chip_smoke._hold_routed(rows, MOE_LAYERS)
        return
    g = chip_smoke._hold_routed(rows, MOE_LAYERS)
    assert g["held"] == held and g["how"] == how
    if case == "differing-10x-counted":
        assert g["agree"] == held and g["flipped"] == [(5, 3, 3, ["TP 1"])]
        assert g["worst"] == pytest.approx(1.1)


def _healthy(outs):
    return outs


def _each_shard(outs):
    return [o * (1 + 2 ** -6) for o in outs]


def _one_shard(outs):
    return [outs[0], outs[1] * (1 + 2 ** -5)] + list(outs[2:])


@pytest.fixture(scope="module")
def jamba():
    """jamba reduced with its 8-layer period in bf16, seeded weights, its
    float32 copy as a one-device pipeline, and 16 seeded 24-token
    prompts."""
    full = get_config("jamba-v0.1-52b")
    cfg = dataclasses.replace(
        full.reduced(), layer_pattern=full.layer_pattern,
        num_layers=len(full.layer_pattern), dtype="bfloat16")
    params = PM.init_params(cfg, 0, device="cpu")

    def f32(t):
        return ({k: f32(v) for k, v in t.items()} if isinstance(t, dict)
                else t.float())
    ref = AsymmetricPipeline(cfg, f32(params), [cfg.num_layers],
                             device="cpu", dtype=torch.float32)
    rng = np.random.RandomState(0)
    prompts = rng.randint(1, cfg.vocab_size, (16, 24))
    return cfg, params, ref, prompts


@pytest.mark.parametrize("mutant", [_healthy, _each_shard, _one_shard],
                         ids=["healthy", "each-shard-2^-6", "one-shard-2^-5"])
def test_routed_gate_fails_a_mutant_shard_sum(jamba, mutant, monkeypatch):
    cfg, params, ref, prompts = jamba
    real = PM._reduce
    monkeypatch.setattr(PM, "_reduce",
                        lambda outs, *a, **k: real(mutant(outs), *a, **k))
    cpus = [torch.device("cpu", i) for i in range(2)]
    L = cfg.num_layers
    pipes = {1: AsymmetricPipeline(cfg, params, [L], [cpus[:1]]),
             2: AsymmetricPipeline(cfg, params, [L], [cpus])}
    toks = {tp: [list(t) for t in p.generate(prompts, max_new=8)]
            for tp, p in pipes.items()}
    reqs = [types.SimpleNamespace(prompt=list(p)) for p in prompts]
    rows = chip_smoke._bf16_tp_logits(pipes, reqs, toks[1], toks[2],
                                      replay=True)
    assert all(r[6].shape == r[7].shape == (4, len(r[3][0]) + len(r[3][1]),
                                            cfg.top_k) for r in rows)
    if mutant is _healthy:
        g = chip_smoke._gate_bf16_tp(rows, ref, moe=True)
        assert g["how"] == "every position" and len(g["held"]) >= 4
        assert g["worst"] <= chip_smoke.TP_BF16_ERR
        return
    with pytest.raises(AssertionError, match="TP 2's bf16 error"):
        chip_smoke._gate_bf16_tp(rows, ref, moe=True)
