"""The dry run's per-card counts on a mesh (``launch.mesh``,
``models.parallel_ctx``, ``launch.specs.build_dryrun(mesh=)``,
``launch.dryrun --mesh``) against the reference's, on the meta device.

On the reference test's (2, 2) (data, model) mesh and its four (arch,
shape) pairs (``tests/test_dryrun.py:14-40``):

  * card 0's counts are positive and sane (0 < useful-FLOPs fraction <= 2,
    as the reference asserts), with 4 chips and a nonzero collective term
    on NVLink;
  * its matmul FLOPs agree with the whole step's: counted at (2, 2) and
    (2, 4) they split into the products the rules cut (S, shared by tp)
    and those they replicate (R), and S + R is the whole step's count, so
    cards x per-card = the whole step + each replicated product once per
    extra card (and, where the batch does not split over the data axis,
    long_500k's one row, once per data card);
  * the collective bytes against the reference's compiled (2, 2) counts
    (a subprocess with four virtual XLA devices, ~7 s). Tolerance: equal
    all-reduce bytes where the rules split by heads, d_ff and experts
    (whisper-base, h2o-danube-1.8b, granite-moe-3b), as both sum the
    row-parallel products' float32 outputs; for xlstm-125m GSPMD
    reshards the mLSTM's gate its own way, so the reference's all-reduce
    bytes are the port's plus one (b, d) float32 all-reduce per mLSTM
    layer (the replicated out_proj run on the din-split gate product),
    and its collective-permute moves in float32 the gate z the port
    all-gathers at the model's width: each relation exact;
  * under MoE's "global" dispatch a mesh with a data axis raises (the
    reference's ranks span every data card's rows) and is not reported as
    a skip; a model axis alone counts it; only a head cut is skipped.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro.launch import mesh as JMesh
from repro_torch.configs import get_config
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch import dryrun, mesh, roofline, specs
from repro_torch.models import moe, parallel_ctx, shardings

from _torch_threads import one_torch_thread  # noqa: F401

PAIRS = [("xlstm-125m", "decode_32k"), ("whisper-base", "decode_32k"),
         ("h2o-danube-1.8b", "long_500k"),
         ("granite-moe-3b-a800m", "decode_32k")]

REFERENCE = textwrap.dedent("""
    import json
    import jax
    from repro.launch import specs, roofline
    from repro.configs.base import INPUT_SHAPES

    mesh = jax.make_mesh((2, 2), ("data", "model"))
    out = {}
    for arch, shape in %r:
        fn, structs, shs, jkw, cfg = specs.build_dryrun(arch, shape, mesh,
                                                        False)
        compiled = jax.jit(fn, in_shardings=shs, **jkw).lower(
            *structs).compile()
        rl = roofline.extract(compiled, model_flops=1.0, chips=4)
        out[f"{arch}/{shape}"] = rl.coll_bytes
    print("JSON" + json.dumps(out))
""" % (PAIRS,))


@pytest.fixture(scope="module")
def reference():
    """The reference's per-chip collective bytes by kind, compiled on a
    (2, 2) mesh of four virtual host devices."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count"
               "=4", JAX_PLATFORMS="cpu", PYTHONPATH="src")
    p = subprocess.run([sys.executable, "-c", REFERENCE], capture_output=True,
                       text=True, env=env, cwd=root, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    line = [ln for ln in p.stdout.splitlines() if ln.startswith("JSON")][0]
    return json.loads(line[4:])


def _run(arch, shape, shape_mesh=None):
    m = None if shape_mesh is None else mesh.make_mesh(shape_mesh,
                                                       ("data", "model"))
    return dryrun.run_one(arch, shape, mesh=m, verbose=False)


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_small_mesh_per_card_counts(reference, arch, shape):
    rec = _run(arch, shape, (2, 2))
    r = rec["roofline"]
    assert rec["mesh"] == [2, 2] and r["chips"] == 4
    assert r["flops_per_chip"] > 0 and r["hbm_bytes_per_chip"] > 0
    assert 0 < r["useful_flops_frac"] <= 2.0, r["useful_flops_frac"]
    coll = r["collective_bytes_per_chip"]
    assert r["collective_s"] == sum(coll.values()) / roofline.NVLINK_BW > 0

    # per-card matmul FLOPs against the whole step's
    cfg = specs.resolve_config(arch, shape)
    sh = INPUT_SHAPES[shape]
    m22 = mesh.make_mesh((2, 2), ("data", "model"))
    bspec = specs.batch_axes(sh, False, m22)
    nd_b = 2 if bspec else 1                # the batch's split over data
    whole = _run(arch, shape)["matmul_flops"]
    per2, per4 = rec["matmul_flops"], _run(arch, shape, (2, 4))[
        "matmul_flops"]
    split = 4 * (per2 - per4) * nd_b                # S: cut by tp
    repl = per2 * nd_b - split // 2                 # R: on every card
    assert split > 0 and repl >= 0
    assert split + repl == whole, (split, repl, whole)
    assert 4 * per2 * nd_b == 2 * (whole + repl)     # cards x per-card
    if arch == "h2o-danube-1.8b":
        assert repl == 0                    # heads, d_ff, vocabulary: cut
    else:
        assert repl > 0                     # a replicated head, router, cell

    # collectives against the reference's compiled ones
    want = {k: v for k, v in reference[f"{arch}/{shape}"].items() if v}
    if arch != "xlstm-125m":
        assert coll == want, (coll, want)
        return
    b_loc = sh.global_batch // nd_b
    n_mlstm = sum(cfg.layer_kind(i) == "mlstm"
                  for i in range(cfg.num_layers))
    width = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    assert set(coll) == {"all-reduce", "all-gather"}
    assert want["all-reduce"] == coll["all-reduce"] \
        + n_mlstm * b_loc * cfg.d_model * 4
    assert want["collective-permute"] == coll["all-gather"] * 4 // width


def test_production_mesh_and_the_cli(tmp_path, capsys):
    """The reference's production meshes and axes; ``--mesh 16x16`` on
    llama2-70b's decode_32k prints and records card 0's counts (per-card
    FLOPs, bytes, collectives, chips 256); ``--multi-pod`` takes the
    (2, 16, 16) mesh; without ``--mesh`` nothing is collective."""
    assert mesh.make_production_mesh().shape == (16, 16)   # reference:
    assert mesh.make_production_mesh(multi_pod=True).shape == (2, 16, 16)
    assert mesh.make_production_mesh(multi_pod=True).axis_names == \
        ("pod", "data", "model")
    for mp in (False, True):
        assert mesh.data_axes(mp) == JMesh.data_axes(mp)
    assert (mesh.MODEL_AXIS, mesh.TP) == (JMesh.MODEL_AXIS, JMesh.TP)
    assert dryrun.parse_mesh("16x16", True).shape == (2, 16, 16)
    with pytest.raises(ValueError, match="DATAxMODEL"):
        dryrun.parse_mesh("16")
    assert not parallel_ctx.active()
    m = mesh.make_production_mesh()
    with parallel_ctx.use_mesh(m, ("data",), "model"):
        assert parallel_ctx.active() and parallel_ctx.tp() == 16
    assert not parallel_ctx.active() and parallel_ctx.tp() == 1

    out = tmp_path / "rec.json"
    rec = dryrun.main(["--arch", "llama2-70b", "--shape", "decode_32k",
                       "--mesh", "16x16", "--json", str(out)])[0]
    printed = capsys.readouterr().out
    assert "card 0 of mesh=[16, 16]" in printed and "chips=256" in printed
    r = rec["roofline"]
    assert rec["mesh"] == [16, 16] and r["chips"] == 256
    assert r["collective_bytes_per_chip"]["all-reduce"] > 0
    assert r["collective_s"] > 0
    assert 0 < r["useful_flops_frac"] <= 2.0
    assert json.loads(out.read_text())["mesh"] == [16, 16]
    # a model axis that would cut a query head is skipped, named (the
    # port's shards hold whole heads); an attention-free model is not
    m16 = dryrun.parse_mesh("16x16")
    skip = dryrun.run_or_skip("paligemma-3b", "decode_32k", mesh=m16,
                              verbose=False)
    assert "8 query heads do not split over 16" in skip["skipped"]
    assert dryrun.run_or_skip("xlstm-125m", "decode_32k", mesh=m16,
                              verbose=False)["roofline"]["collective_s"] > 0
    one = dryrun.run_one("llama2-70b", "decode_32k", verbose=False)
    assert one["roofline"]["collective_s"] == 0 and "mesh" not in one
    # a card holds 1/16 of the layers' weights and 1/16 of the batch
    assert r["flops_per_chip"] * 256 > one["roofline"]["flops_per_chip"]
    assert r["flops_per_chip"] * 16 < one["roofline"]["flops_per_chip"]
    cfg = get_config("llama2-70b")
    assert rec["memory_analysis"]["argument_size_in_bytes"] < \
        one["memory_analysis"]["argument_size_in_bytes"] / 16 + \
        2 * cfg.vocab_size * cfg.d_model * 2


def test_global_dispatch_on_a_data_axis_raises_not_skips(monkeypatch):
    monkeypatch.setattr(moe, "MOE_DISPATCH", "global")
    arch, shape = "granite-moe-3b-a800m", "decode_32k"
    m22 = dryrun.parse_mesh("2x2")
    with pytest.raises(NotImplementedError, match="'global' on a mesh "
                       "with a data axis"):
        specs.build_dryrun(arch, shape, mesh=m22)
    with pytest.raises(NotImplementedError, match="data axis") as e:
        dryrun.run_or_skip(arch, shape, mesh=m22, verbose=False)
    assert not isinstance(e.value, shardings.HeadCut)
    # a model axis alone: card 0's expert shard runs the global dispatch
    rec = dryrun.run_or_skip(arch, shape, mesh=dryrun.parse_mesh("1x2"),
                             verbose=False)
    assert "skipped" not in rec
    assert rec["roofline"]["collective_bytes_per_chip"]["all-reduce"] > 0
    # the grouped dispatch still counts on the data axis
    monkeypatch.setattr(moe, "MOE_DISPATCH", "grouped")
    assert "skipped" not in dryrun.run_or_skip(arch, shape, mesh=m22,
                                               verbose=False)
