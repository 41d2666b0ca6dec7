"""The PyTorch port's ground rules: it imports neither jax nor the JAX
package, the weight bridge is exact, and its entry points run on the card
unless the caller asks for the CPU — without a card they raise."""
import dataclasses
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.plan import Assignment, PipelinePlan, StagePlan
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.configs import get_config as port_config
from repro_torch.core import plan as port_plan
from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ssm_scan as ss
from repro_torch.models.mamba import FP32_LEAVES
from repro_torch.models import model as PM
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.pipeline import AsymmetricPipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None            # any `import jax` now raises
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke                    # the card's smoke script, likewise
bad = sorted(k for k in sys.modules if k == "repro" or k.startswith("repro."))
assert not bad, bad
assert "repro_torch.models.xlstm" in names, names
for sub in ("obs.trace", "obs.metrics", "obs.calibration", "obs.report",
            "analysis.kvsan", "serving.disagg", "serving.cluster_kv",
            "core.resched", "serving.resched", "training.data",
            "training.optimizer", "training.train_step", "checkpoint.ckpt",
            "launch.train"):
    assert "repro_torch." + sub in names, (sub, names)
print(len(names))
"""


def test_port_imports_without_jax_or_the_jax_package():
    # conftest.py already imported jax in this process: use a fresh one
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), ROOT]))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20      # every module was visited


def _leaves_with_names(tree, name=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_names(v, k)
    else:
        yield name, tree


def test_bridge_round_trip_is_exact():
    for arch in ("llama2-70b", "jamba-v0.1-52b"):
        cfg = get_config(arch).reduced()
        tree = jax.tree.map(np.asarray,
                            JM.init_params(cfg, jax.random.PRNGKey(0)))
        back = bridge.params_to_numpy(bridge.params_from_numpy(tree,
                                                               device="cpu"))
        flat, treedef = jax.tree.flatten(tree)
        flat_back, treedef_back = jax.tree.flatten(back)
        assert treedef == treedef_back
        for a, b in zip(flat, flat_back):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    # a bf16 cast rounds every float leaf but Mamba's float32 dynamics
    cast = bridge.params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    for (name, a), (_, t) in zip(_leaves_with_names(tree),
                                 _leaves_with_names(cast)):
        want = torch.from_numpy(np.array(a))
        if name in FP32_LEAVES:
            assert t.dtype == torch.float32 and torch.equal(t, want), name
        else:
            assert t.dtype == torch.bfloat16, name
            assert torch.equal(t, want.to(torch.bfloat16)), name


def test_port_params_follow_the_reference_layout():
    for arch in ("llama2-70b", "jamba-v0.1-52b", "granite-20b",
                 "codeqwen1.5-7b", "phi3.5-moe-42b-a6.6b",
                 "granite-moe-3b-a800m", "xlstm-125m"):
        cfg = get_config(arch).reduced()
        ref_tree = jax.tree.map(np.asarray,
                                JM.init_params(cfg, jax.random.PRNGKey(0)))
        port = PM.init_params(port_config(arch).reduced(), 3, device="cpu")
        shapes = jax.tree.map(lambda a: a.shape, ref_tree)
        port_shapes = jax.tree.map(lambda t: tuple(t.shape), port)
        assert shapes == port_shapes
        dtypes = jax.tree.map(lambda a: str(a.dtype), ref_tree)
        port_dtypes = jax.tree.map(
            lambda t: str(t.dtype).removeprefix("torch."), port)
        assert dtypes == port_dtypes
        again = PM.init_params(port_config(arch).reduced(), 3, device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(
            jax.tree.leaves(port), jax.tree.leaves(again)))     # seeded
    # in a bf16 model the Mamba dynamics stay float32, as in the reference
    full = get_config("jamba-v0.1-52b")
    assert full.dtype == "bfloat16"
    small = dataclasses.replace(full.reduced(), dtype="bfloat16")
    ref_tree = jax.eval_shape(lambda: JM.init_params(small,
                                                     jax.random.PRNGKey(0)))
    port = PM.init_params(dataclasses.replace(
        port_config("jamba-v0.1-52b").reduced(), dtype="bfloat16"), 3,
        device="cpu")
    assert jax.tree.map(lambda a: str(a.dtype), ref_tree) == jax.tree.map(
        lambda t: str(t.dtype).removeprefix("torch."), port)
    assert all(t.dtype == torch.float32 for n, t in _leaves_with_names(port)
               if n in FP32_LEAVES)


@pytest.mark.parametrize("entry", ["engine", "pipeline", "init_params"])
def test_entry_points_default_to_cuda_and_raise_without_it(entry):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card; the check is for CPU-only "
                    "machines")
    cfg = port_config("llama2-70b").reduced()
    params = PM.init_params(cfg, 0, device="cpu")
    asg = port_plan.Assignment([port_plan.PipelinePlan(
        [port_plan.StagePlan([0], 1), port_plan.StagePlan([1], 1)])])
    with pytest.raises(RuntimeError, match="cuda"):
        if entry == "engine":
            InferenceEngine(cfg, asg, params=params)
        elif entry == "pipeline":
            AsymmetricPipeline(cfg, params, [1, 1])
        else:
            PM.init_params(cfg, 0)


@pytest.mark.parametrize("name", sorted(ops.KERNELS))
def test_kernel_wrappers_refuse_cpu_tensors(name):
    # a wrapper launches its kernel or raises: it never computes the plain
    # version itself (ops picks the plain version for CPU tensors)
    q = torch.zeros(1, 1, 4, 32)
    k = torch.zeros(1, 8, 2, 32)
    kq = torch.zeros(1, 8, 2, 32, dtype=torch.int8)     # a quantized pool
    ks = torch.zeros(1, 8, 2)
    tbl = torch.zeros(1, 1, dtype=torch.int32)
    x = torch.zeros(1, 3, 8)                            # a selective scan
    A, B, D = torch.zeros(8, 4), torch.zeros(1, 3, 4), torch.zeros(8)
    q64, k64 = torch.zeros(1, 2, 4, 64), torch.zeros(1, 2, 2, 64)
    lse, h_ins = torch.zeros(1, 4, 2), torch.zeros(1, 1, 8, 4)
    args = {"flash_attention": lambda: fa.flash_attention_cuda(q, k, k),
            "paged_decode_attention": lambda: pa.paged_decode_attention_cuda(
                q, k, k, torch.zeros(1, 1, dtype=torch.int32)),
            "paged_context_attention": lambda: pa.paged_context_attention_cuda(
                q, k, k, torch.zeros(1, 1, dtype=torch.int32), q_start=[0],
                kv_len=[1]),
            "decode_attention": lambda: da.decode_attention_cuda(q, k, k),
            "paged_verify_attention": lambda: pa.paged_verify_attention_cuda(
                q, k, k, torch.zeros(1, 1, dtype=torch.int32), kv_start=[0],
                kv_len=[1]),
            "paged_decode_attention_quant":
                lambda: pa.paged_decode_attention_quant_cuda(
                    q, kq, kq, ks, ks, tbl),
            "paged_context_attention_quant":
                lambda: pa.paged_context_attention_quant_cuda(
                    q, kq, kq, ks, ks, tbl, q_start=[0], kv_len=[1]),
            "paged_verify_attention_quant":
                lambda: pa.paged_verify_attention_quant_cuda(
                    q, kq, kq, ks, ks, tbl, kv_start=[0], kv_len=[1]),
            "ssm_scan": lambda: ss.ssm_scan_cuda(x, x, A, B, B, D),
            "flash_attention_bwd": lambda: fa.flash_attention_bwd_cuda(
                q64, k64, k64, q64, lse, q64),
            "ssm_scan_bwd": lambda: ss.ssm_scan_bwd_cuda(x, x, A, B, B, D,
                                                         h_ins, x)}
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        args[name]()
    assert ops.launch_counts() == before


def test_cpu_tensors_take_the_plain_versions_without_launches():
    ops.reset_launch_counts()
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 5, 4, 32), np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 5, 2, 32), np.float32))
    with ops.backend("plain"):
        want = ops.flash_attention(q, k, k)
    assert torch.equal(ops.flash_attention(q, k, k), want)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    with pytest.raises(ValueError):
        with ops.backend("pallas"):
            pass


def test_unported_features_raise_not_implemented():
    cfg = port_config("llama2-70b").reduced()
    asg = port_plan.Assignment([port_plan.PipelinePlan(
        [port_plan.StagePlan([0], 2)])])
    # the reference's devices and key: the port serves on one device and
    # seeds its weights by an integer
    for kw in (dict(devices=["cpu"]), dict(key=0)):
        with pytest.raises(NotImplementedError, match=next(iter(kw))):
            InferenceEngine(cfg, asg, device="cpu", **kw)
    # unquantized pools of another width than the model's: not ported
    with pytest.raises(NotImplementedError, match="kv_dtype"):
        InferenceEngine(cfg, asg, device="cpu", cache_layout="paged",
                        kv_dtype="bf16")
    # the multi-replica features are served: one replica disaggregates
    # colocated with the reference's warning, and the host tier is built
    with pytest.warns(UserWarning, match="serving colocated"):
        eng = InferenceEngine(cfg, asg, device="cpu", disaggregate=True)
    assert eng.roles == ["both"]
    eng = InferenceEngine(cfg, asg, device="cpu", cache_layout="paged",
                          prefix_caching=True, host_blocks=4, kvsan=True)
    w = eng.router.workers[0]
    assert w.host_blocks == 4 and w.kvsan


def test_build_hash_covers_every_source_and_header():
    # build.target hashes a source with build.HEADERS only: a header that a
    # source includes and HEADERS does not list would leave a stale library
    # loaded on the card after an edit; a source SOURCES does not list
    # would never be built
    csrc = build.CSRC
    sources = sorted(p.stem for p in csrc.glob("*.cu"))
    assert sorted(build.SOURCES) == sources
    for path in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")):
        for inc in re.findall(r'^\s*#include\s+"([^"]+)"', path.read_text(),
                              flags=re.M):
            assert inc in build.HEADERS, f"{path.name} includes {inc}"
            assert (csrc / inc).exists(), inc
    assert all((csrc / h).exists() for h in build.HEADERS)
