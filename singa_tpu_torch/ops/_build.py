"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` is compiled on first use by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  Libraries
go to ``build/singa_tpu_torch/`` at the repository root, named by a hash
of the source, every ``csrc/`` header it includes (``#include "..."``,
followed transitively) and the flags, so an edited source or header is
rebuilt and an unchanged one is loaded as it is.  Several sources build in parallel:
one ``nvcc`` per source, all started together.

Nothing here runs at import time; a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

__all__ = ["SOURCES", "BUILD_DIR", "build", "load", "nvcc_path",
           "ptxas_report"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "singa_tpu_torch")

# kernel library name -> source file under csrc/
SOURCES = {
    "flash_attention_fwd": "flash_attention_fwd.cu",
    "flash_attention_bwd": "flash_attention_bwd.cu",
    "paged_decode": "paged_decode.cu",
    "lstm_cell": "lstm_cell.cu",
    "elementwise": "elementwise.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``CUDA_HOME``, the standard toolkit location, or
    ``PATH``; raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's "
                           "CUDA kernels are built from source at first use")
    return found


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def _inputs(name: str) -> list[str]:
    """The source of library ``name`` and every file under ``CSRC`` that
    it includes with ``#include "..."``, directly or transitively, in
    the order first reached (paths relative to ``CSRC``)."""
    seen, todo = [], [SOURCES[name]]
    while todo:
        rel = todo.pop(0)
        if rel in seen or not os.path.isfile(os.path.join(CSRC, rel)):
            continue
        seen.append(rel)
        with open(os.path.join(CSRC, rel), "rb") as f:
            text = f.read()
        base = os.path.dirname(rel)
        todo += [os.path.normpath(os.path.join(base, inc.decode()))
                 for inc in _INCLUDE.findall(text)]
    return seen


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    for rel in _inputs(name):
        with open(os.path.join(CSRC, rel), "rb") as f:
            h.update(rel.encode() + b"\0" + f.read() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def ptxas_report(name: str) -> str:
    """What ``ptxas -v`` said about the library's kernels (registers,
    shared memory, spills) when it was built; empty if never built."""
    path = _lib_path(name) + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def build(names=None) -> dict:
    """Compile every named library (default: all) that is not built
    yet, one ``nvcc`` process per source, all at once.  Returns
    ``{name: seconds}`` for the libraries it compiled."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not os.path.exists(_lib_path(n))]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = _lib_path(n)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    done = {}
    errors = []
    for n, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[n]} "
                          f"(exit {p.returncode}):\n{log}")
            continue
        with open(out + ".log", "w") as f:
            f.write(log)
        os.replace(tmp, out)      # atomic: a reader never sees half a file
        done[n] = time.perf_counter() - t0
    if errors:
        raise RuntimeError("\n".join(errors))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(_lib_path(name))
    return lib
