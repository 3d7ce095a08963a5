"""Native (C++) host-side components and their ctypes bindings (a copy of
``fmov_pose_tpu/native/__init__.py``'s loader).

A library is built at first use with ``g++ -O3 -march=native -shared -fPIC
-std=c++17`` into ``fmov_pose_torch/_build/``, under a name keyed by a
hash of its sources, the flags and the host's CPU (``-march=native``
code must not run on another CPU), so a changed source or another machine
rebuilds.  The build writes a temporary file and renames it into place,
so processes that build at once never load a half-written library.  A
failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(os.path.dirname(_HERE), "_build")
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
_LOCK = threading.Lock()
_LIBS = {}


def _cpu_id() -> bytes:
    """The host CPU's model and feature lines (what -march=native reads)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = [l for l in f.read().splitlines()
                     if l.startswith((b"model name", b"flags"))]
        return b"\n".join(sorted(set(lines)))
    except OSError:
        return b""


def _build_lib(name: str, sources, extra_flags=()) -> str:
    srcs = [os.path.join(_HERE, s) for s in sources]
    flags = (*_FLAGS, *extra_flags)
    h = hashlib.sha256(" ".join(flags).encode() + _cpu_id())
    for src in srcs:
        with open(src, "rb") as f:
            h.update(f.read())
    out = os.path.join(_BUILD, f"lib{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", *flags, *srcs, "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}) building {name}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str, sources, extra_flags=()) -> ctypes.CDLL:
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(_build_lib(name, sources, extra_flags))
        return _LIBS[name]
