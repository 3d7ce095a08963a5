"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``: that builds in
seconds, where a source that includes PyTorch's headers takes minutes.
Only the sources in this repository are compiled.  The output goes to
``fmov_pose_torch/_build/`` under a name keyed by a hash of the sources and
flags, so a changed source rebuilds and an unchanged one loads at once.
A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}
# name -> {"seconds": build time (0.0 when loaded from _build), "log": nvcc's output}
BUILD_INFO: dict = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources(name: str):
    return [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _so(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def build_all(names) -> None:
    """Compile the sources of ``names`` that are not built yet, one nvcc
    process each, all started together; raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        so = _so(name)
        if name in _LIBS or name in procs or so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (so, tmp, cmd, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (so, tmp, cmd, t0, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) building {name}:\n"
                          f"{' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, so)
        BUILD_INFO[name] = {"seconds": time.perf_counter() - t0, "log": log.strip()}
    if failed:
        raise RuntimeError("\n".join(failed))


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built if needed)."""
    if name in _LIBS:
        return _LIBS[name]
    so = _so(name)
    if not so.exists():
        build_all([name])
    BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": "(cached)"})
    _LIBS[name] = ctypes.CDLL(str(so))
    return _LIBS[name]
