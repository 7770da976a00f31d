"""Build the port's native code at first use and load it with ctypes.

Two kinds of shared library, both with a plain C interface:

- CUDA kernels (``csrc/*.cu``), compiled by ``nvcc`` for ``sm_90a``
  (Hopper), one library per kernel so each keeps its own flags; headers
  they share (``csrc/*.cuh``) are found through ``-I csrc`` and hashed
  with the source that includes them;
- the host C++ entropy runtime (``runtime/native/jpegtpu.cpp``, the port's
  copy of the JAX package's), compiled by ``g++`` without the JAX package's
  profile-guided step (its training script imports jax), and the C++
  entropy encoder (``runtime/native/jpegtpu_enc.cpp``), compiled by ``g++``
  as a library of its own.

Every source and header lies inside this package: nothing is read from the
JAX package's tree.

Libraries land in ``jpeg_tpu_torch/build/`` (listed in ``.gitignore``) under
a name that carries a hash of the sources, the command and the host name,
so an edited source is rebuilt and a stale library is never loaded. Builds are
serialized across threads and processes with a file lock and published
with an atomic rename. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import shutil
import subprocess
import threading

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PACKAGE_DIR, "build")
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
GXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-pthread",
             "-shared"]

_loaded: dict[str, ctypes.CDLL] = {}
_locks: dict[str, threading.Lock] = {}  # one per library: builds run in parallel
_lock = threading.Lock()


class LaunchCounter:
    """Number of launches of one kernel. A wrapper adds one where it launches
    its kernel and nowhere else, so a run can show the kernel was used."""

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        return self._n


class BuildError(RuntimeError):
    """A compiler run failed; the message carries its output."""


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin/nvcc`` (as PyTorch resolves
    CUDA_HOME), else the one on ``PATH``."""
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cands.append(shutil.which("nvcc") or "")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise BuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _digest(cmd: list[str], sources: list[str]) -> str:
    """Hash of the command and of every file in ``sources`` (the compiled
    sources and the headers they include)."""
    # The host name is part of the key: g++ builds with -march=native, so a
    # library built on one machine must not be loaded on another.
    h = hashlib.sha256(" ".join([platform.node(), *cmd]).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build_library(name: str, compiler: list[str], sources: list[str],
                  headers: tuple[str, ...] = ()) -> str:
    """Compile ``sources`` with ``compiler`` (the command without ``-o`` and
    the sources) into ``build/lib<name>-<hash>.so``; returns the path. The
    hash covers ``headers`` too (files the sources include), so editing one
    rebuilds. A library that already exists under the same hash is reused."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    digest = _digest(compiler, [*sources, *headers])
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    if os.path.exists(out):
        return out
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if os.path.exists(out):  # another process built it meanwhile
            return out
        tmp = f"{out}.tmp{os.getpid()}"
        proc = subprocess.run([*compiler, "-o", tmp, *sources],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise BuildError(
                f"building {name} failed ({compiler[0]} exit "
                f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def load_library(name: str, compiler: list[str], sources: list[str],
                 configure, headers: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build (if needed) and load a library once per process;
    ``configure(lib)`` declares its ctypes signatures. Different libraries
    may be built from different threads at once."""
    with _lock:
        lk = _locks.setdefault(name, threading.Lock())
    with lk:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_library(name, compiler, sources, headers))
            configure(lib)
            _loaded[name] = lib
        return lib


def load_cuda_kernel(name: str, extra_flags: tuple[str, ...],
                     configure, headers: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` with nvcc for sm_90a and load it.
    ``headers`` names the files of ``csrc/`` it includes: they are found
    through ``-I csrc`` and hashed with the source. Every launch calls
    this: once loaded, the library is returned before anything else
    (finding nvcc re-imports ``torch.utils.cpp_extension``, which took
    0.6 ms a call on the H100's host)."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    return load_library(
        name, [find_nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR, *extra_flags],
        [os.path.join(CSRC_DIR, f"{name}.cu")], configure,
        tuple(os.path.join(CSRC_DIR, h) for h in headers))
