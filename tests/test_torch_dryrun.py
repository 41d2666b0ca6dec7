"""The port's dry run (repro_torch.launch.{specs,roofline,op_analysis,
dryrun}) against the reference's on the CPU: the input shapes, the
resolved configurations, the analytic model FLOPs and active parameters of
every architecture; every meta param and cache leaf's shape and dtype
against the reference's ``jax.eval_shape`` leaf; the whole ``--all``
sweep on the meta device with the reference's skip; and the op counter's
weights per op on hand-built tensors."""
import dataclasses
import re
from functools import partial

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jconfig
from repro.configs import list_archs as jarchs
from repro.configs.base import INPUT_SHAPES as JSHAPES
from repro.launch import roofline as JRoof
from repro.launch import specs as JSpecs
from repro.models import model as JM
from repro_torch.configs import list_archs
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, op_analysis, roofline, specs

PAIRS = [(a, s) for a in sorted(jarchs()) for s in JSHAPES]


def test_input_shapes_and_archs_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    assert sorted(list_archs()) == sorted(jarchs())
    assert specs.SWA_OVERRIDE_WINDOW == JSpecs.SWA_OVERRIDE_WINDOW
    assert specs.LONG_SKIP == JSpecs.LONG_SKIP


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_configs_and_model_flops_equal_the_reference(arch, shape):
    try:
        want = JSpecs.resolve_config(arch, shape)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            specs.resolve_config(arch, shape)
        return
    got = specs.resolve_config(arch, shape)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.active_params == want.active_params
    assert got.total_params == want.total_params
    assert roofline.model_flops_estimate(got, INPUT_SHAPES[shape]) == \
        JRoof.model_flops_estimate(want, JSHAPES[shape])


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tuple(tree.shape), str(tree.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", sorted(jarchs()))
def test_meta_leaves_equal_the_reference_eval_shape(arch):
    """Params, and the cache of every shape that has one, leaf by leaf
    through the bridge's names: shapes and dtypes equal, so the argument
    bytes are equal too."""
    cfg = jconfig(arch)
    want = list(_leaves(jax.eval_shape(partial(JM.init_params, cfg),
                                       jax.random.PRNGKey(0))))
    got = list(_leaves(specs.params_struct(specs.resolve_config(
        arch, "train_4k"))))
    assert got == want
    for name, shape in JSHAPES.items():
        if shape.kind == "train" or (name == "long_500k"
                                     and arch in JSpecs.LONG_SKIP):
            continue
        jcfg = JSpecs.resolve_config(arch, name)
        want = list(_leaves(jax.eval_shape(partial(
            JM.init_cache, jcfg, shape.global_batch, shape.seq_len))))
        got = list(_leaves(specs.cache_struct(
            specs.resolve_config(arch, name), shape.global_batch,
            shape.seq_len)))
        assert got == want, name


def test_all_on_meta_writes_every_record(tmp_path, capsys):
    out = tmp_path / "all.json"
    recs = dryrun.main(["--all", "--json", str(out)])
    assert [(r["arch"], r["shape"]) for r in recs] == [
        (a, s) for a in list_archs() for s in dryrun.SHAPES]
    skipped = [r for r in recs if "skipped" in r]
    assert [(r["arch"], r["shape"]) for r in skipped] == [
        ("whisper-base", "long_500k")]
    assert skipped[0]["skipped"] == "whisper-base skips long_500k (see " \
        "DESIGN.md)"
    assert "SKIP: whisper-base skips long_500k" in capsys.readouterr().out
    for r in recs:
        if "skipped" in r:
            continue
        rl = r["roofline"]
        assert rl["flops_per_chip"] > 0 and rl["hbm_bytes_per_chip"] > 0, r
        assert 0 < rl["useful_flops_frac"] <= 2.0, (r["arch"], r["shape"])
        assert rl["collective_s"] == 0 and rl["chips"] == 1
        assert r["cards_needed"] >= 1 and r["device"] == "meta"
        mem = r["memory_analysis"]
        assert mem["argument_size_in_bytes"] > 0
        assert r["swa_variant"] == (r["shape"] == "long_500k" and
                                    r["arch"] in ("codeqwen1.5-7b",
                                                  "granite-20b", "granite-8b",
                                                  "granite-moe-3b-a800m",
                                                  "llama2-70b",
                                                  "paligemma-3b",
                                                  "phi3.5-moe-42b-a6.6b"))
        if r["shape"] != "long_500k" and r["arch"] != "xlstm-125m":
            assert r["kernels"], r["arch"]           # attention ran as #1/#8
    assert out.exists()


def test_cuda_without_a_card_raises():
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun.run_one("granite-8b", "decode_32k", device="cuda", layers=2,
                       batch=1, verbose=False)


def _count(fn, *args):
    c = op_analysis.OpCounter()
    with c:
        fn(*args)
    return c


def test_op_counter_weights_per_op():
    """The reference's weights (hlo_analysis.py:122-134): one operation a
    result element, 4 for exp / log / tanh / sigmoid / erf / sin / cos, 2
    for rsqrt / sqrt; a reduction one an input element; 2 M N K for a
    matmul, kept apart; bytes: operands plus results, none for a view."""
    x = torch.randn(6, 5)
    n, nb = x.numel(), x.numel() * 4
    for fn, k, reads in ((torch.exp, 4, 1), (torch.log, 4, 1),
                         (torch.tanh, 4, 1), (torch.sigmoid, 4, 1),
                         (torch.erf, 4, 1), (torch.sin, 4, 1),
                         (torch.cos, 4, 1), (torch.rsqrt, 2, 1),
                         (torch.sqrt, 2, 1), (torch.neg, 1, 1),
                         (lambda t: t + t, 1, 2),
                         (lambda t: torch.maximum(t, t), 1, 2)):
        c = _count(fn, x)
        assert (c.flops, c.matmul_flops, c.bytes) == (k * n, 0,
                                                      (reads + 1) * nb), fn
    c = _count(lambda t: t.sum(0), x)
    assert c.flops == n and c.bytes == nb + 5 * 4
    c = _count(lambda t: t.amax(-1), x)
    assert c.flops == n
    a, b = torch.randn(4, 3), torch.randn(3, 7)
    c = _count(torch.matmul, a, b)
    assert c.flops == c.matmul_flops == 2 * 4 * 3 * 7
    assert c.bytes == 4 * (12 + 21 + 28) and c.work == {"fp32": 168}
    c = _count(lambda: torch.einsum("bij,bjk->bik", torch.randn(2, 4, 3),
                                    torch.randn(2, 3, 5)))
    assert c.matmul_flops == 2 * 2 * 4 * 3 * 5
    c = _count(lambda t: t.view(30), x)
    assert (c.flops, c.bytes) == (0, 0)
    c = _count(lambda t: t.to(torch.bfloat16), x)
    assert (c.flops, c.bytes) == (0, nb + 2 * n)
    c = _count(lambda t: t.T.contiguous(), x)
    assert (c.flops, c.bytes) == (0, 2 * nb)
    bf = torch.randn(4, 3).bfloat16(), torch.randn(3, 7).bfloat16()
    assert _count(torch.matmul, *bf).work == {"bf16": 168}


def test_kernel_ops_count_by_formula_and_plain_counts_the_twin():
    q = torch.randn(2, 16, 4, 32)
    k = torch.randn(2, 16, 2, 32)
    c = _count(lambda: ops.flash_attention(q, k, k))
    pairs = 2 * 16 * 17 // 2
    assert c.kernels == {"flash_attention": 1}
    assert c.flops == 4 * 32 * 4 * pairs and c.matmul_flops == 0
    assert c.bytes == 4 * (2 * q.numel() + 2 * k.numel())
    with ops.backend("plain"):
        p = _count(lambda: ops.flash_attention(q, k, k))
    assert not p.kernels
    # the plain version materializes every score: two full products
    assert p.matmul_flops == 2 * 2 * 2 * 2 * 16 * 16 * 32 * 2
    # and the meta device counts what the CPU counts
    qm, km = q.to("meta"), k.to("meta")
    m = _count(lambda: ops.flash_attention(qm, km, km))
    assert (m.flops, m.bytes, dict(m.kernels)) == (c.flops, c.bytes,
                                                   dict(c.kernels))


def test_meta_is_allowed_and_other_devices_are_not():
    assert ops._kernel_for(torch.empty(1, device="meta")) is False
    assert ops._kernel_for(torch.empty(1)) is False
    dev = torch.device("meta")
    assert ops.shapes_only(torch.empty(1, device=dev))
    with ops.backend("plain"):
        assert not ops.shapes_only(torch.empty(1, device=dev))


def test_roofline_terms_use_the_dtype_peaks():
    rl = roofline.Roofline(flops=2e12, hbm_bytes=3.35e12, coll_bytes={},
                           model_flops=1e12, chips=1,
                           work={"bf16": 989e12, "fp32": 67e12})
    assert rl.compute_s == pytest.approx(2.0)
    assert rl.memory_s == pytest.approx(1.0)
    assert rl.collective_s == 0 and rl.dominant == "compute"
    d = rl.as_dict()
    assert d["card"] == "NVIDIA H100 SXM" and d["power_limit_w"] == 700.0
    assert np.isclose(d["useful_flops_frac"], 0.5)
