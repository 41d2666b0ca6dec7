"""repro-lint for the port: AST-based static analysis with the repo's
rules (a copy of repro.analysis.lint, whose rule catalog, findings and
``# repro: noqa[rule-id]`` pragmas it keeps, so that one pragma serves
both linters).

Usage::

    PYTHONPATH=src python -m repro_torch.analysis.lint [PATH ...]
    # default: src/repro_torch

Findings print one per line as ``file:line rule-id message``; exit status
is 1 when any finding survives, 0 on a clean tree.  A finding is
suppressed by a ``# repro: noqa[rule-id]`` comment on the same line
(comma-separate several ids; bare ``# repro: noqa`` silences every rule)
— use it only for *intentional* violations and justify it in an adjacent
comment.  Rule catalog with rationale: docs/analysis.md.

Rules
-----
``clock-discipline``   wall-clock calls (``time.time``/``monotonic``/
                       ``sleep``/``datetime.now`` ...) anywhere except
                       ``serving/loop.py``, which owns the Wall/Virtual
                       clock seam.  Guards virtual-clock determinism.
``jit-retrace``        ``jax.jit``/``jax.pmap`` calls outside setup
                       methods, or device-array construction with a
                       ``len(...)``-derived shape, in serving-path files.
                       Guards the fixed compile-shape bucketing
                       discipline (steady-state decode must not retrace);
                       kept as the reference has it, it finds nothing in
                       code that does not call jax.
``kernel-oracle``      a ``*_cuda`` kernel wrapper not present in
                       ``repro_torch.analysis.registry.KERNEL_ORACLES``
                       (and,
                       when kernel modules are in the linted set, any
                       registry staleness from ``check_registry``).
``refcount-pairing``   a class acquires pool references (``.alloc``/
                       ``.incref``) but has no ``free``/``release``/
                       ``truncate``/``decref`` path at all.
``bare-except``        ``except:`` with no exception type.
``mutable-default``    mutable default argument (``[]``/``{}``/``set()``).
``unseeded-rng``       global-state RNG draws (``random.*``,
                       ``np.random.*``) instead of an explicitly seeded
                       ``default_rng``/``RandomState``/``PRNGKey``.
``span-pairing``       a ``tracer.begin(...)`` in a function with no
                       ``tracer.end(...)`` anywhere in the same function.
                       An unclosed span corrupts the Chrome-trace export
                       (``openSpans`` validation fails); prefer the
                       ``with tracer.span(...)`` context manager.
"""
from __future__ import annotations

import ast
import os
import re
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set

from repro_torch.analysis import registry as _registry

RULES: Dict[str, str] = {
    "clock-discipline": "wall-clock use outside serving/loop.py",
    "jit-retrace": "jit/retrace hazard on a per-iteration serving path",
    "kernel-oracle": "*_cuda kernel missing from the oracle registry",
    "refcount-pairing": "pool references acquired with no release path",
    "bare-except": "bare except: swallows every exception",
    "mutable-default": "mutable default argument",
    "unseeded-rng": "unseeded global-state RNG",
    "span-pairing": "tracer.begin() with no tracer.end() in the function",
}

# one-time-setup functions where jax.jit construction is the sanctioned
# pattern (compile once in __init__, reuse per iteration)
_SETUP_FUNCS = {"__init__", "__post_init__", "build", "setup"}

_TIME_ATTRS = {"time", "time_ns", "monotonic", "monotonic_ns",
               "perf_counter", "perf_counter_ns", "process_time", "sleep"}
_DATETIME_ATTRS = {"now", "utcnow", "today"}

_RANDOM_FUNCS = {"random", "randint", "randrange", "choice", "choices",
                 "shuffle", "sample", "uniform", "gauss", "betavariate",
                 "expovariate", "normalvariate", "getrandbits"}
# np.random.<attr> calls that are fine: constructing an explicitly seeded
# generator object (the repo-wide pattern)
_NP_RANDOM_OK = {"RandomState", "default_rng", "Generator", "SeedSequence",
                 "PCG64", "Philox"}

_ACQUIRE_ATTRS = {"alloc", "incref"}
_RELEASE_ATTRS = {"free", "release", "truncate", "decref"}

_NOQA_RE = re.compile(r"#\s*repro:\s*noqa(?:\[([A-Za-z0-9_,\s-]*)\])?")


@dataclass(frozen=True)
class Finding:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line} {self.rule} {self.message}"


def _noqa_map(source: str) -> Dict[int, Optional[Set[str]]]:
    """line -> suppressed rule ids (None = all rules)."""
    out: Dict[int, Optional[Set[str]]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _NOQA_RE.search(text)
        if not m:
            continue
        if m.group(1) is None:
            out[i] = None
        else:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


def _is_serving_path(rel: str) -> bool:
    parts = rel.replace(os.sep, "/").split("/")
    stem = os.path.splitext(parts[-1])[0]
    return any(p == "serving" for p in parts[:-1]) or "serving" in stem


def _is_clock_exempt(rel: str) -> bool:
    return rel.replace(os.sep, "/").endswith("serving/loop.py")


def _contains_len_call(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name)
                and sub.func.id == "len"):
            return True
    return False


def _dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


class _Visitor(ast.NodeVisitor):
    def __init__(self, rel: str) -> None:
        self.rel = rel
        self.serving = _is_serving_path(rel)
        self.clock_exempt = _is_clock_exempt(rel)
        self.findings: List[Finding] = []
        self._func_stack: List[str] = []
        self._class_stack: List[ast.ClassDef] = []
        # per-class acquire sites, resolved when the class closes
        self._acquires: Dict[int, List[ast.Call]] = {}
        self._releases: Dict[int, bool] = {}
        # per-function tracer.begin sites / tracer.end presence, resolved
        # when the function closes (span-pairing)
        self._span_begins: List[List[ast.Call]] = []
        self._span_ends: List[bool] = []

    def _add(self, node: ast.AST, rule: str, message: str) -> None:
        self.findings.append(
            Finding(self.rel, getattr(node, "lineno", 1), rule, message))

    # -- defs --------------------------------------------------------

    def _visit_func(self, node) -> None:
        self._span_begins.append([])
        self._span_ends.append(False)
        if node.name.endswith("_cuda") and not self._func_stack \
                and not self._class_stack:
            if node.name not in _registry.KERNEL_ORACLES:
                self._add(node, "kernel-oracle",
                          f"kernel '{node.name}' has no entry in "
                          "repro_torch.analysis.registry.KERNEL_ORACLES "
                          "(register its ref.py oracle, the reference "
                          "function it ports, its chip_smoke.py check, "
                          "its CPU test and its cost)")
        for d in node.args.defaults + node.args.kw_defaults:
            if d is None:
                continue
            mutable = isinstance(d, (ast.List, ast.Dict, ast.Set)) or (
                isinstance(d, ast.Call) and isinstance(d.func, ast.Name)
                and d.func.id in ("list", "dict", "set") and not d.args
                and not d.keywords)
            if mutable:
                self._add(d, "mutable-default",
                          f"mutable default argument in '{node.name}' "
                          "is shared across calls; default to None")
        self._func_stack.append(node.name)
        self.generic_visit(node)
        self._func_stack.pop()
        begins = self._span_begins.pop()
        ended = self._span_ends.pop()
        if begins and not ended:
            for call in begins:
                self._add(call, "span-pairing",
                          f"tracer.begin() in '{node.name}' has no "
                          "matching tracer.end(); an unclosed span "
                          "corrupts the trace export — prefer "
                          "'with tracer.span(...)'")

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._class_stack.append(node)
        self._acquires[id(node)] = []
        self._releases[id(node)] = False
        self.generic_visit(node)
        self._class_stack.pop()
        if self._acquires[id(node)] and not self._releases[id(node)]:
            for call in self._acquires[id(node)]:
                attr = call.func.attr  # type: ignore[union-attr]
                self._add(call, "refcount-pairing",
                          f"class '{node.name}' acquires pool references "
                          f"via .{attr}() but defines no free/release/"
                          "truncate/decref path")

    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        if node.type is None:
            self._add(node, "bare-except",
                      "bare 'except:' hides KeyboardInterrupt and real "
                      "bugs; catch a concrete exception")
        self.generic_visit(node)

    # -- calls -------------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        if isinstance(node.func, ast.Attribute):
            self._check_attr_call(node, node.func)
        self.generic_visit(node)

    def _in_setup(self) -> bool:
        return any(f in _SETUP_FUNCS or f.startswith("_init")
                   for f in self._func_stack)

    def _check_attr_call(self, node: ast.Call,
                         func: ast.Attribute) -> None:
        dotted = _dotted(func)
        attr = func.attr

        # clock-discipline
        if not self.clock_exempt:
            if dotted in {f"time.{a}" for a in _TIME_ATTRS}:
                self._add(node, "clock-discipline",
                          f"'{dotted}()' outside serving/loop.py breaks "
                          "virtual-clock determinism; take a Clock")
            elif attr in _DATETIME_ATTRS and dotted is not None and (
                    dotted.startswith("datetime.")
                    or dotted.startswith("date.")):
                self._add(node, "clock-discipline",
                          f"'{dotted}()' outside serving/loop.py breaks "
                          "virtual-clock determinism; take a Clock")

        # jit-retrace (serving-path files only)
        if self.serving and self._func_stack and not self._in_setup():
            if dotted in ("jax.jit", "jax.pmap"):
                self._add(node, "jit-retrace",
                          f"'{dotted}' inside '{self._func_stack[-1]}' "
                          "re-traces per call; compile once in __init__ "
                          "and reuse")
            elif dotted is not None and dotted.startswith("jnp.") and \
                    attr in ("zeros", "ones", "empty", "full", "arange"):
                if any(_contains_len_call(a) for a in
                       list(node.args) + [k.value for k in node.keywords]):
                    self._add(node, "jit-retrace",
                              f"'jnp.{attr}' shape derived from 'len(...)'"
                              " defeats compile-shape bucketing; pad to a "
                              "fixed bucket")

        # span-pairing bookkeeping: begin/end on a receiver named
        # *tracer (self.tracer, tracer, w.tracer, ...)
        if self._span_begins:
            recv = _dotted(func.value)
            if recv is not None and \
                    recv.split(".")[-1].lower().endswith("tracer"):
                if attr == "begin":
                    self._span_begins[-1].append(node)
                elif attr == "end":
                    self._span_ends[-1] = True

        # refcount-pairing bookkeeping
        if self._class_stack:
            cid = id(self._class_stack[-1])
            if attr in _ACQUIRE_ATTRS:
                self._acquires[cid].append(node)
            if attr in _RELEASE_ATTRS:
                self._releases[cid] = True

        # unseeded-rng
        if dotted is not None:
            if dotted in {f"random.{f}" for f in _RANDOM_FUNCS}:
                self._add(node, "unseeded-rng",
                          f"'{dotted}()' draws from the global RNG; use "
                          "np.random.default_rng(seed) or "
                          "jax.random.PRNGKey")
            elif (dotted.startswith(("np.random.", "numpy.random."))
                  and attr not in _NP_RANDOM_OK):
                self._add(node, "unseeded-rng",
                          f"'{dotted}()' draws from numpy's global RNG; "
                          "construct np.random.default_rng(seed)")


def lint_source(source: str, rel: str) -> List[Finding]:
    """Lint one file's source; ``rel`` is the path used for reporting
    and rule scoping."""
    try:
        tree = ast.parse(source, filename=rel)
    except SyntaxError as e:
        return [Finding(rel, e.lineno or 1, "parse-error", str(e.msg))]
    v = _Visitor(rel)
    v.visit(tree)
    noqa = _noqa_map(source)
    out = []
    for f in v.findings:
        rules = noqa.get(f.line, ())
        if rules is None or (rules and f.rule in rules):
            continue
        out.append(f)
    return sorted(out, key=lambda f: (f.path, f.line, f.rule))


def lint_file(path: str, rel: Optional[str] = None) -> List[Finding]:
    with open(path, encoding="utf-8") as f:
        return lint_source(f.read(), rel or path)


def _iter_py(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(d for d in dirnames
                                     if d not in ("__pycache__", ".git"))
                out.extend(os.path.join(dirpath, fn)
                           for fn in sorted(filenames)
                           if fn.endswith(".py"))
        elif p.endswith(".py"):
            out.append(p)
    return out


def lint_paths(paths: Sequence[str],
               registry_check: bool = True) -> List[Finding]:
    """Lint every .py under ``paths``.  When the linted set includes a
    kernel module, also cross-check the oracle registry itself."""
    findings: List[Finding] = []
    files = _iter_py(paths)
    for path in files:
        findings.extend(lint_file(path))
    if registry_check:
        kernel_basenames = {os.path.basename(m)
                            for m in _registry.KERNEL_MODULES}
        if any(os.path.basename(p) in kernel_basenames for p in files):
            for problem in _registry.check_registry():
                m = re.match(r"(\S+?):(\d+)\s+(.*)", problem)
                if m:
                    findings.append(Finding(m.group(1), int(m.group(2)),
                                            "kernel-oracle", m.group(3)))
                else:
                    findings.append(Finding(
                        "src/repro_torch/analysis/registry.py", 1,
                        "kernel-oracle", problem))
    return sorted(set(findings), key=lambda f: (f.path, f.line, f.rule))


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="repo-specific static analysis (rule catalog: "
                    "docs/analysis.md)")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories to lint (default: "
                         "src/repro_torch)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--no-registry-check", action="store_true",
                    help="skip the kernel/oracle registry cross-check")
    args = ap.parse_args(argv)
    if args.list_rules:
        for rule, desc in RULES.items():
            print(f"{rule:18s} {desc}")
        return 0
    findings = lint_paths(args.paths,
                          registry_check=not args.no_registry_check)
    for f in findings:
        print(f)
    n_files = len(_iter_py(args.paths))
    if findings:
        print(f"repro-lint: {len(findings)} finding(s) in "
              f"{n_files} file(s)", file=sys.stderr)
        return 1
    print(f"repro-lint: {n_files} file(s) clean", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
