"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use into a shared library with a
plain C interface under ``build/repro_torch/`` at the repository root
(listed in .gitignore), named by a hash of the sources and flags so an
edited kernel never loads a stale build. ``build()`` starts one nvcc per
missing source at once (``csrc`` / ``build_dir`` name another tree's
sources, such as a parent commit's, built with the same flags;
``defines`` adds ``-D`` macros, part of the library's name);
``library(name)`` builds if needed and loads.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("flash_attention", "paged_attention", "decode_attention",
           "ssm_scan", "flash_attention_bwd", "ssm_scan_bwd")
HEADERS = ("attention.cuh", "decode.cuh", "flash.cuh", "hopper.cuh")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's "
                           "kernels build only where the CUDA toolkit is")
    return found


def _flags(defines: Sequence[str]) -> tuple:
    return FLAGS + tuple(f"-D{d}" for d in defines)


def target(name: str, csrc: Path = CSRC, build_dir: Path = BUILD_DIR,
           defines: Sequence[str] = ()) -> Path:
    h = hashlib.sha256()
    for f in (f"{name}.cu",) + HEADERS:
        h.update((csrc / f).read_bytes())
    h.update(" ".join(_flags(defines)).encode())
    return build_dir / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = SOURCES, csrc: Path = CSRC,
          build_dir: Path = BUILD_DIR,
          defines: Sequence[str] = ()) -> Dict[str, Path]:
    """Compile every source in `names` whose library is missing, all at
    once. nvcc's ptxas report (registers, spills) lands in
    ``<library>.log``. Raises with nvcc's output on any failure."""
    build_dir.mkdir(parents=True, exist_ok=True)
    out = {n: target(n, csrc, build_dir, defines) for n in names}
    procs = {}
    for n, so in out.items():
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *_flags(defines), "-o", str(tmp),
               str(csrc / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    errors = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        out[n].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc {n}.cu failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built on first use."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build([name])[name]))
    return _LIBS[name]
