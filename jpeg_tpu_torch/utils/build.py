"""Build the port's native code at first use and load it with ctypes.

Two kinds of shared library, both with a plain C interface:

- CUDA kernels (``csrc/*.cu``), compiled by ``nvcc`` for ``sm_90a``
  (Hopper), one library per kernel so each keeps its own flags; headers
  they share (``csrc/*.cuh``) are found through ``-I csrc`` and hashed
  with the source that includes them;
- the host C++ entropy runtime (``runtime/native/jpegtpu.cpp``, the port's
  copy of the JAX package's), compiled by ``g++`` profile-guided as the JAX
  package's Makefile builds it (:class:`PGO`), and the C++ entropy encoder
  (``runtime/native/jpegtpu_enc.cpp``), compiled by ``g++`` as a plain
  library of its own.

A profile-guided build runs three steps under the library's lock: an
instrumented compile (``-fprofile-generate``, atomic counter updates, each
source compiled to an object of a fixed name in a work directory, so that
the profile is found again by name), a training child process that drives
the instrumented library and exits normally (its counters are written at
exit), and the ``-fprofile-use -fprofile-correction`` rebuild of the same
objects. The rebuild must report no missing profile, else the build
raises. When the training cannot run (its child exits non-zero, times out
or writes no profile) the library is built plain and says so: beside each
profile-guided library lies ``lib<name>-<hash>.pgo.json`` with its status
(``on`` or ``off``) and the seconds of each step (:func:`build_info`). A
plain library built so is kept as ``lib<name>-<hash>.off.so``, never under
the profile-guided name, so the next process that loads it trains again.

Every source and header lies inside this package: nothing is read from the
JAX package's tree.

Libraries land in ``jpeg_tpu_torch/build/`` (listed in ``.gitignore``) under
a name that carries a hash of the sources, the command and the host name
(and, for a profile-guided build, of the training script and the streams it
reads), so an edited source is rebuilt and a stale library is never loaded. Builds are
serialized across threads and processes with a file lock and published
with an atomic rename. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses
import fcntl
import hashlib
import json
import os
import platform
import shutil
import subprocess
import threading
import time

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PACKAGE_DIR, "build")
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
GXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-pthread",
             "-shared"]

# Seconds a profile-guided build's training child may take.
TRAIN_TIMEOUT_S = 600

_loaded: dict[str, ctypes.CDLL] = {}
_paths: dict[str, str] = {}  # library name -> the file it was loaded from
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


@dataclasses.dataclass(frozen=True)
class PGO:
    """How to train a profile-guided build: ``command`` is run with the
    instrumented library's path appended, from the directory that holds
    the package; ``inputs`` are the files it reads (the training script
    and its streams), hashed into the library's name."""

    command: tuple[str, ...]
    inputs: tuple[str, ...]


def _run(cmd: list[str], what: str) -> subprocess.CompletedProcess:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise BuildError(f"building {what} failed ({cmd[0]} exit "
                         f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    return proc


def _compile_pgo(name: str, compiler: list[str], sources: list[str],
                 out: str, pgo: PGO) -> dict:
    """The three steps of a profile-guided build of ``sources`` into the
    file ``out``; returns the build's record (status and seconds)."""
    work = f"{out}.work"
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        objs = [os.path.join(work, f"src{i}.o") for i in range(len(sources))]
        instr = os.path.join(work, f"lib{name}-instrumented.so")
        gen = ["-fprofile-generate", "-fprofile-update=atomic"]
        t0 = time.perf_counter()
        for src, obj in zip(sources, objs):
            _run([*compiler, *gen, "-c", "-o", obj, src], f"{name} (instrumented)")
        _run([*compiler, *gen, "-o", instr, *objs], f"{name} (instrumented)")
        t1 = time.perf_counter()
        root = os.path.dirname(PACKAGE_DIR)
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            p for p in (root, os.environ.get("PYTHONPATH")) if p)}
        try:
            train = subprocess.run([*pgo.command, instr], cwd=root, env=env,
                                   capture_output=True, text=True,
                                   timeout=TRAIN_TIMEOUT_S)
            rc, said = train.returncode, train.stdout + train.stderr
        except subprocess.TimeoutExpired as e:
            rc, said = None, f"timed out after {e.timeout} s"
        t2 = time.perf_counter()
        profiled = rc == 0 and all(
            os.path.exists(obj[:-2] + ".gcda") for obj in objs)
        if profiled:
            use = ["-fprofile-use", "-fprofile-correction"]
            for src, obj in zip(sources, objs):
                proc = _run([*compiler, *use, "-c", "-o", obj, src],
                            f"{name} (profile-guided)")
                if "missing-profile" in proc.stderr:
                    raise BuildError(f"building {name}: the rebuild found no "
                                     f"profile for {src}:\n{proc.stderr}")
            _run([*compiler, "-o", out, *objs], f"{name} (profile-guided)")
        else:
            _run([*compiler, "-o", out, *sources], f"{name} (plain)")
        return {"pgo": "on" if profiled else "off",
                "instrumented_s": t1 - t0, "train_s": t2 - t1,
                "final_s": time.perf_counter() - t2, "train_rc": rc,
                "train_output": "" if profiled else said[-2000:]}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _info_path(lib_path: str) -> str:
    return lib_path[: -len(".so")] + ".pgo.json"


def build_library(name: str, compiler: list[str], sources: list[str],
                  headers: tuple[str, ...] = (), pgo: PGO | None = None
                  ) -> str:
    """Compile ``sources`` with ``compiler`` (the command without ``-o`` and
    the sources) into ``build/lib<name>-<hash>.so``; returns the path. The
    hash covers ``headers`` too (files the sources include), so editing one
    rebuilds. With ``pgo`` the build is profile-guided (module docstring)
    and the hash also covers ``pgo.inputs``. A library that already exists
    under the same hash is reused."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    key = compiler if pgo is None else [*compiler, "[pgo]"]
    digest = _digest(key, [*sources, *headers,
                           *(pgo.inputs if pgo is not None else ())])
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")

    def make(tmp):
        if pgo is None:
            _run([*compiler, "-o", tmp, *sources], name)
            return None
        record = _compile_pgo(name, compiler, sources, tmp, pgo)
        # A plain build is not published under the profile-guided name.
        kept = out if record["pgo"] == "on" else out[:-len(".so")] + ".off.so"
        # The record lands first: a library on disk always has one.
        with open(_info_path(kept), "w") as f:
            json.dump(record, f)
        if kept == out:
            return None
        os.replace(tmp, kept)
        return kept

    return _build_once(name, out, make)


def build_executable(name: str, compiler: list[str], sources: list[str],
                     headers: tuple[str, ...] = (),
                     libs: tuple[str, ...] = ()) -> str:
    """Compile ``sources`` (``libs`` linked after them) into the program
    ``build/<name>-<hash>``, as :func:`build_library` builds a library;
    returns its path."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"{name}-"
                       + _digest([*compiler, *libs], [*sources, *headers]))

    def make(tmp):
        _run([*compiler, "-o", tmp, *sources, *libs], name)

    return _build_once(name, out, make)


def _build_once(name: str, out: str, make) -> str:
    """``out`` if it exists; else ``make(tmp)`` under ``name``'s file lock
    and ``tmp`` renamed to ``out`` (another process may have built it
    meanwhile: then that one is kept). Where ``make`` returns a path, it
    kept its result there, unpublished: that path is returned."""
    if os.path.exists(out):
        return out
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if not os.path.exists(out):
            tmp = f"{out}.tmp{os.getpid()}"
            kept = make(tmp)
            if kept is not None:
                return kept
            os.replace(tmp, out)
    return out


def build_info(name: str) -> dict | None:
    """The build record of the library ``name`` as loaded in this process
    (status and step seconds of a profile-guided build), or None: not
    loaded, or not built profile-guided."""
    path = _paths.get(name)
    if path is None:
        return None
    try:
        with open(_info_path(path)) as f:
            return json.load(f)
    except OSError:
        return None


def loaded(name: str) -> tuple[ctypes.CDLL, str] | None:
    """(handle, file) of the library ``name`` if this process loaded it."""
    lib = _loaded.get(name)
    return None if lib is None else (lib, _paths.get(name))


def use_library(name: str, path: str, configure) -> ctypes.CDLL:
    """Load the file ``path`` and make it the library ``name`` of this
    process, in place of any loaded before: later calls of
    :func:`load_library` return it and build nothing. The seam through which
    a training child drives an instrumented build and an A/B swaps builds."""
    lib = ctypes.CDLL(os.path.abspath(path))
    configure(lib)
    with _lock:
        _loaded[name] = lib
        _paths[name] = os.path.abspath(path)
    return lib


def load_library(name: str, compiler: list[str], sources: list[str],
                 configure, headers: tuple[str, ...] = (),
                 pgo: PGO | None = None) -> ctypes.CDLL:
    """Build (if needed) and load a library once per process;
    ``configure(lib)`` declares its ctypes signatures. Different libraries
    may be built from different threads at once."""
    with _lock:
        lk = _locks.setdefault(name, threading.Lock())
    with lk:
        lib = _loaded.get(name)
        if lib is None:
            kw = {} if pgo is None else {"pgo": pgo}
            path = build_library(name, compiler, sources, headers, **kw)
            lib = ctypes.CDLL(path)
            configure(lib)
            _paths[name] = path
            _loaded[name] = lib
        return lib


def load_cuda_kernel(name: str, extra_flags: tuple[str, ...],
                     configure, headers: tuple[str, ...] = (),
                     variant: str = "", source: str | None = None
                     ) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` (or ``source``, a ``.cu`` elsewhere in the
    package) with nvcc for sm_90a and load it. ``headers`` names the files
    of ``csrc/`` it includes: they are found through ``-I csrc`` and hashed
    with the source. ``variant`` names a build of the same source under
    other ``extra_flags`` (``-D`` overrides): the library's name and cache
    key become ``<name>.<variant>``, and its hash covers those flags, so
    each variant is a library of its own and a plain call (no variant)
    keeps its command line and its library. Every launch calls this: once
    loaded, the library is returned before anything else (finding nvcc
    re-imports ``torch.utils.cpp_extension``, which took 0.6 ms a call on
    the H100's host)."""
    key = f"{name}.{variant}" if variant else name
    lib = _loaded.get(key)
    if lib is not None:
        return lib
    return load_library(
        key, [find_nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR, *extra_flags],
        [source or os.path.join(CSRC_DIR, f"{name}.cu")], configure,
        tuple(os.path.join(CSRC_DIR, h) for h in headers))
