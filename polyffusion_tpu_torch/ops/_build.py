"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, ``build/lib<name>-<hash>.so``, where the hash
is that of the source and of the headers in ``csrc/``: a library is never
loaded for a source it was not built from. Nothing here runs at import time,
so the package imports on machines without ``nvcc`` or a GPU. Building and
loading hold one lock, so threads that reach a kernel first together (a
server's warmup and its request handlers) build it once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
SOURCES = ("packed_attention", "packed_attention_bwd", "gn_bwd", "repaint_epilogue",
           "gn_silu_conv", "gn_fwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.RLock()


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in (f"{name}.cu", *headers):
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile the named sources that have no library yet, one ``nvcc`` per
    source, all started together. Returns the compiler's output per source
    (``-Xptxas -v`` register and shared-memory use); raises if one fails."""
    with _LOCK:
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = {}
        for name in names:
            lib = _lib_path(name)
            if os.path.exists(lib):
                continue
            tmp = f"{lib}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
            procs[name] = (
                subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp,
                lib,
            )
        logs = {}
        for name, (proc, tmp, lib) in procs.items():
            out, _ = proc.communicate()
            logs[name] = out
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
            os.replace(tmp, lib)
        return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        if name not in _LIBS:
            lib = _lib_path(name)
            if not os.path.exists(lib):
                build([name])
            _LIBS[name] = ctypes.CDLL(lib)
        return _LIBS[name]


def build_all() -> Dict[str, str]:
    """Build every source in parallel and load it; returns the compiler logs."""
    logs = build(SOURCES)
    for name in SOURCES:
        load(name)
    return logs
