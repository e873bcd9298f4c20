"""Builds the package's native code, at first use, from the sources in the tree.

Two kinds of library, both with a plain C interface and loaded with ``ctypes``:

  * CUDA kernels: one shared library per ``csrc/<stem>.cu``, compiled by ``nvcc``
    for ``sm_90a``. Reached only from a kernel wrapper that was handed a CUDA
    tensor, so importing the package needs neither ``nvcc`` nor a card.
  * host code: C (the Keccak sponge) compiled by ``gcc``, C++ (the field
    oracle) by ``g++``.

Outputs go to ``zktpu_torch/_build/`` (ignored by git) under a name that carries
a hash of the sources, so an edit rebuilds and a stale library is never loaded.
A library is written under a temporary name and renamed into place, so
concurrent processes (test workers) never load a half-written file.

A failed build raises ``CompileError`` with the compiler's output. Nothing here
catches it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "--resource-usage",  # registers, spills and shared memory per kernel, kept in build_log
]

#: stem -> loaded CDLL (one load per process)
_cuda_libs: dict[str, ctypes.CDLL] = {}
#: stem -> seconds the last build in this process took (0.0 when it was cached)
build_seconds: dict[str, float] = {}
#: stem -> what the compiler printed during that build ("" when it was cached)
build_log: dict[str, str] = {}


class CompileError(RuntimeError):
    """A compiler was missing or refused the source."""


def _sources_hash(paths: list[str], flags: list[str]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sorted(paths):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _compile(cmd: list[str], out_path: str) -> str:
    """Run ``cmd + [-o tmp]`` and rename tmp to ``out_path``; returns what the
    compiler printed."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.part", dir=BUILD_DIR)
    os.close(fd)
    try:
        try:
            res = subprocess.run(cmd + ["-o", tmp], capture_output=True, text=True)
        except OSError as e:
            raise CompileError(f"cannot run {cmd[0]}: {e}") from e
        if res.returncode != 0:
            raise CompileError(
                f"{' '.join(cmd)} failed ({res.returncode}):\n{res.stdout}\n{res.stderr}"
            )
        os.replace(tmp, out_path)
        return res.stdout + res.stderr
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise CompileError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")


def cuda_library_path(stem: str) -> str:
    """Build ``csrc/<stem>.cu`` if its library is missing; return the path."""
    source = os.path.join(CSRC_DIR, stem + ".cu")
    headers = [
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR) if f.endswith(".cuh")
    ]
    tag = _sources_hash([source] + headers, NVCC_FLAGS)
    out_path = os.path.join(BUILD_DIR, f"lib{stem}_{tag}.so")
    if os.path.exists(out_path):
        build_seconds.setdefault(stem, 0.0)
        build_log.setdefault(stem, "")
        return out_path
    t0 = time.time()
    build_log[stem] = _compile([find_nvcc()] + NVCC_FLAGS + ["-I", CSRC_DIR, source], out_path)
    build_seconds[stem] = time.time() - t0
    return out_path


def build_cuda_libraries(stems) -> None:
    """Build the libraries of several ``csrc/<stem>.cu`` at once, one ``nvcc``
    each, all started together (a thread a compiler: the threads only wait)."""
    threads = [threading.Thread(target=cuda_library_path, args=(stem,)) for stem in stems]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for stem in stems:
        cuda_library_path(stem)  # built now: returns at once, or raises what the thread met


def cuda_library(stem: str) -> ctypes.CDLL:
    """The loaded kernel library of ``csrc/<stem>.cu`` (built at first use).

    The caller sets ``argtypes``/``restype`` on the functions it uses.
    """
    lib = _cuda_libs.get(stem)
    if lib is None:
        lib = ctypes.CDLL(cuda_library_path(stem))
        _cuda_libs[stem] = lib
    return lib


def host_library_path(stem: str, source: str, flags: list[str], compiler: str = "gcc") -> str:
    """Build one host source with ``compiler`` (``gcc`` for C, ``g++`` for C++)
    if its library is missing."""
    tag = _sources_hash([source], [compiler] + flags)
    out_path = os.path.join(BUILD_DIR, f"lib{stem}_{tag}.so")
    if not os.path.exists(out_path):
        _compile([compiler] + flags + ["-shared", "-fPIC", source], out_path)
    return out_path
