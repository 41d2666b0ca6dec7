"""The port's kernel registry and linter (repro_torch.analysis.registry,
repro_torch.analysis.lint) against the tree and against the reference's:
every hand-written kernel registered with its twin, the function it
ports, its chip check and CPU test; every reference kernel ported; the
port's tree lint-clean; the reference's seeded-violation corpus giving
the same findings, rule for rule, but for kernel-oracle, which the port
keys on ``*_cuda`` wrappers; and the cost formulas reproducing the kernel
table's bound column from the shapes."""
import os

import pytest

from repro.analysis import lint as JL
from repro.analysis import registry as JR
from repro_torch.analysis import lint as PL
from repro_torch.analysis import registry as PR
from repro_torch.kernels import ops

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CORPUS = os.path.join(HERE, "fixtures", "lint")


def rules_of(findings):
    return [(f.line, f.rule) for f in findings]


def test_registry_sound_on_real_tree():
    assert PR.check_registry() == []
    kernels = PR.cuda_kernels()
    assert set(kernels) == set(PR.KERNEL_ORACLES)
    # the registry's ops are the launch counters' names, wrapper for wrapper
    assert {e["op"]: w for w, e in PR.KERNEL_ORACLES.items()} == {
        op: fn.__name__ for op, fn in ops.KERNELS.items()}


def test_every_reference_kernel_has_a_port():
    ports = {e["ports"] for e in PR.KERNEL_ORACLES.values()}
    assert set(JR.KERNEL_ORACLES) <= ports
    # and the two backward kernels port the reference's custom VJPs
    assert ports - set(JR.KERNEL_ORACLES) == {"_fa_full_bwd",
                                              "_ssm_chunks_bwd"}


def test_registry_flags_synthetic_breakage(tmp_path):
    mod = tmp_path / "src" / "repro_torch" / "kernels" / "ssm_scan.py"
    mod.parent.mkdir(parents=True)
    mod.write_text("def rogue_cuda(q):\n    return q\n")
    problems = "\n".join(PR.check_registry(root=str(tmp_path)))
    assert "rogue_cuda" in problems                    # unregistered
    assert "matches no *_cuda definition" in problems  # stale entries
    assert "not found in src/repro_torch/kernels/ref.py" in problems
    assert "not defined in chip_smoke.py" in problems
    assert "CPU test file" in problems
    # the unregistered wrapper also fires the lint rule on the file itself
    assert [f.rule for f in PL.lint_file(str(mod))] == ["kernel-oracle"]


def test_port_tree_lints_clean():
    findings = PL.lint_paths([os.path.join(ROOT, "src", "repro_torch")])
    assert findings == [], "\n".join(map(str, findings))


def _fixtures():
    out = []
    for dirpath, _, files in os.walk(CORPUS):
        out += [os.path.relpath(os.path.join(dirpath, f), CORPUS)
                for f in sorted(files) if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("fixture", _fixtures())
def test_corpus_gives_the_reference_findings(fixture):
    path = os.path.join(CORPUS, fixture)
    want = [x for x in rules_of(JL.lint_file(path))
            if x[1] != "kernel-oracle"]
    assert rules_of(PL.lint_file(path)) == want


def test_unregistered_cuda_wrapper_trips_kernel_oracle():
    src = ("def mystery_attention_cuda(q, k, v):\n    return q\n\n\n"
           "class W:\n    def bound_cuda(self):\n        return None\n\n\n"
           "def flash_attention_cuda(q):\n    return q\n")
    found = PL.lint_source(src, "x.py")
    assert [(f.line, f.rule) for f in found] == [(1, "kernel-oracle")]
    assert "mystery_attention_cuda" in str(found[0])
    noqa = src.replace("(q, k, v):", "(q, k, v):  # repro: noqa"
                       "[kernel-oracle]")
    assert PL.lint_source(noqa, "x.py") == []


def test_cli_exit_codes(capsys):
    assert PL.main(["--list-rules"]) == 0
    assert "kernel-oracle" in capsys.readouterr().out
    assert PL.main([os.path.join(CORPUS, "fx_clean.py")]) == 0
    assert PL.main([os.path.join(CORPUS, "fx_hygiene.py")]) == 1
    assert "bare-except" in capsys.readouterr().out


def test_costs_reproduce_the_bound_column():
    """The kernel table's bounds at llama2-70b's serving shapes, from the
    shapes alone: #1 on 16 causal 1024-token prompts (64 / 8 heads of 128,
    bf16) 0.2782 ms by operations; its backward at (4, 1024) five products
    0.1739 ms; #1 at h2o-danube-1.8b's window (4 x 4604 tokens, 32 / 8
    heads of 80, kv_start 0, 1, 2, 4) 0.4334 ms; #9 at (16, 1024, 8192,
    16) 2^31 exponentials."""
    def ms(cost):
        return cost["flops"] / 989e12 * 1e3
    c = PR.flash_attention_cost(b=16, sq=1024, skv=1024, hq=64, hkv=8,
                                d=128, es=2, dtype="bf16")
    assert round(ms(c), 4) == 0.2782
    c = PR.flash_attention_bwd_cost(b=4, sq=1024, skv=1024, hq=64, hkv=8,
                                    d=128, es=2, dtype="bf16")
    assert round(ms(c), 4) == 0.1739
    c = PR.flash_attention_cost(b=4, sq=4604, skv=4604, hq=32, hkv=8, d=80,
                                es=2, dtype="bf16", window=4096,
                                kv_start=[0, 1, 2, 4])
    assert round(ms(c), 4) == 0.4334
    c = PR.ssm_scan_cost(b=16, s=1024, din=8192, ds=16, in_bytes=0)
    assert c["exps"] == 2 ** 31 and c["dtype"] == "fp32"
    # pairs: causal, windowed, ranged, and a chunk at an offset
    assert PR.attention_pairs(2, 4, 4, causal=True) == 2 * 10
    assert PR.attention_pairs(1, 4, 4, causal=True, window=2) == 7
    assert PR.attention_pairs(1, 1, 8, causal=False, kv_len=[5]) == 5
    assert PR.attention_pairs(1, 3, 8, causal=True, q_start=[4],
                              kv_len=[7]) == 5 + 6 + 7
