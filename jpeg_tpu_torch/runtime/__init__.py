"""Host C++ entropy runtime and entropy encoder, bound with ctypes.

Binds entry points of the port's copy of the JAX package's C++ decode
library (``jpeg_tpu_torch/runtime/native/jpegtpu.cpp``, a verbatim copy of
``jpeg_tpu/runtime/native/jpegtpu.cpp``, built through ``jpegtpu_port.cpp``,
which includes it and adds the port's own entry points) without importing
``jpeg_tpu``:

- ``jt_decode_scan``: restart-segment-parallel Huffman decode into
  ``[total_blocks, 64]`` int32 zigzag blocks (the compat decode's input);
- ``jt_decode_scan_planes``: restart-segment-parallel Huffman decode into
  per-component natural-order int16 planes (the layout K1 reads);
- ``jt_decode_scan_planes_spec``: the speculative self-synchronising decode
  of a single-segment scan, used for multi-threaded single-image decode;
- ``jt_decode_gap``: sequential MCU decode from any bit position up to a
  recorded stop, the gap recovery of ``entropy/device_spec.py``;
- ``jt_unstuff_scan``: byte unstuffing and restart split for large scans;
- progressive scans (``jt_decode_prog_dc`` / ``_ac``, arithmetic
  ``jt_decode_arith_prog_dc`` / ``_ac``) into per-component coefficient
  grids, assembled into the block stream (``jt_prog_assemble_stream``) or
  into K1's planes (``jt_prog_assemble_planes``);
- sequential arithmetic (SOF9) scans into blocks (``jt_decode_arith_scan``)
  or planes (``jt_decode_arith_scan_planes``);
- lossless (SOF3) scans into samples (``jt_decode_lossless``), or into
  their prediction differences only (``jt_decode_lossless_diffs``, the
  port's own, for the reconstruction on the card);

and of its C++ entropy encoder (``jpeg_tpu_torch/runtime/native/
jpegtpu_enc.cpp``, a copy of the JAX package's): restart-segment-parallel
Huffman (``jt_encode_scan``) and QM arithmetic (``jt_encode_arith_scan``)
packing of natural-order int16 planes (the layout K2 writes), and the
progressive scans' DC and AC passes (``jt_encode_prog_dc`` / ``_ac``).

Each library is compiled with g++ into ``jpeg_tpu_torch/build/`` at first
use. The decode runtime is built profile-guided, as the JAX package's
Makefile builds it: an instrumented build, trained by the child process
``python -m jpeg_tpu_torch.tools.pgo_train``, then the ``-fprofile-use``
rebuild; a build whose training could not run is plain, and
:func:`pgo_status` says which loaded. The encoder is a plain build.
``JPEG_TPU_ASAN=1`` loads AddressSanitizer builds of both instead (plain,
under their own names; the process must preload libasan, as
``jpeg_tpu_torch.tools.asan_sweep`` does). A missing compiler or a failed
build raises; there is no numpy fallback on this path.

Speculative decode of a scan without restart markers splits it into a
number of chunks that :class:`SpecTuner` picks by measurement, per frame
geometry, and persists to ``jpeg_tpu_torch/build/spec_tuner.json``
(:func:`spec_tuner_snapshot`).
"""

from __future__ import annotations

import ctypes
import json
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from jpeg_tpu_torch.entropy.tables import SharedCache, frozen, table_key
from jpeg_tpu_torch.utils import build
from jpeg_tpu_torch.utils.build import GXX_FLAGS, BuildError, load_library

NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")
SOURCE = os.path.join(NATIVE_DIR, "jpegtpu.cpp")
PORT_SOURCE = os.path.join(NATIVE_DIR, "jpegtpu_port.cpp")  # includes SOURCE
ENC_SOURCE = os.path.join(NATIVE_DIR, "jpegtpu_enc.cpp")
ASAN_FLAGS = ["-fsanitize=address", "-fno-omit-frame-pointer"]
# (name, compiler, sources, headers) of the AddressSanitizer builds of the
# runtime and of the encoder.
ASAN_BUILDS = (
    ("jpegtpu_asan", ["g++", *GXX_FLAGS, *ASAN_FLAGS], [PORT_SOURCE], (SOURCE,)),
    ("jpegtpu_enc_asan", ["g++", *GXX_FLAGS, *ASAN_FLAGS], [ENC_SOURCE], ()),
)
SPEC_TUNER_PATH = os.path.join(build.BUILD_DIR, "spec_tuner.json")

# Output buffers reused per thread (see native_decode_planes,
# native_decode_coefficients and the progressive scan grids).
_tls = threading.local()


class NativeDecodeError(ValueError):
    """Entropy decode failed (invalid Huffman prefix) in a segment."""

    def __init__(self, segment: int):
        super().__init__(
            f"native entropy decode failed in restart segment {segment} "
            "(invalid Huffman prefix; reference panics here, "
            "src/jpeg/huffman.rs:151-156)")
        self.segment = segment


def _configure(lib: ctypes.CDLL) -> None:
    """ctypes signatures, as ``jpeg_tpu/runtime/__init__.py`` declares them."""
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    i16p = ctypes.POINTER(ctypes.c_int16)
    lib.jt_decode_lossless.restype = ctypes.c_int64
    lib.jt_decode_lossless.argtypes = [
        u8p, i64p, i64p, i64p, i64p, ctypes.c_int64,  # data, segs
        ctypes.c_int32, u16p, ctypes.POINTER(ctypes.c_int32),  # ncomp, luts, dc ids
        ctypes.c_int64, ctypes.c_int64,  # width, height
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # pred, pt, prec
        u16p, ctypes.c_int32,  # out, n_threads
    ]
    lib.jt_decode_lossless_diffs.restype = ctypes.c_int64
    lib.jt_decode_lossless_diffs.argtypes = [
        u8p, i64p, i64p, i64p, i64p, ctypes.c_int64,  # data, segs
        ctypes.c_int32, u16p, ctypes.POINTER(ctypes.c_int32),  # ncomp, luts, dc ids
        u16p, ctypes.c_int32,  # out, n_threads
    ]
    lib.jt_decode_scan.restype = ctypes.c_int64
    lib.jt_decode_scan.argtypes = [
        u8p, ctypes.c_int64,  # data, n_bytes
        i64p, i64p, i64p, i64p, ctypes.c_int64,  # seg arrays, n_segs
        u8p, ctypes.c_int32,  # slot_comp, blocks_per_mcu
        u8p, u8p, ctypes.c_int32,  # comp dc/ac ids, n_comp
        u16p, u16p,  # packed dc/ac LUTs
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,  # out, n_threads
    ]
    lib.jt_decode_gap.restype = ctypes.c_int64
    lib.jt_decode_gap.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64,  # data, start_bit, end_byte
        i64p, ctypes.c_int64, ctypes.c_int64,  # stop_bits, n_stop, max_mcus
        u8p, ctypes.c_int32,  # slot_comp, blocks_per_mcu
        u8p, u8p, ctypes.c_int32,  # comp dc/ac ids, n_comp
        u16p, u16p,  # packed dc/ac LUTs
        ctypes.POINTER(ctypes.c_int32), i64p,  # out blocks, out positions
    ]
    lib.jt_decode_scan_planes.restype = ctypes.c_int64
    lib.jt_decode_scan_planes.argtypes = [
        u8p, ctypes.c_int64,  # data, n_bytes
        i64p, i64p, i64p, i64p, ctypes.c_int64,  # seg arrays, n_segs
        u8p, u8p, u8p, ctypes.c_int32,  # slot comp/vi/hi, blocks_per_mcu
        u8p, u8p, u8p, u8p, ctypes.c_int32,  # comp dc/ac/h/v ids, n_comp
        ctypes.c_int32,  # mcus_x
        u16p, u16p,  # packed dc/ac LUTs
        ctypes.POINTER(i16p), i64p,  # plane ptrs, strides
        i64p, ctypes.c_int32,  # plane rows, prezero mode
        ctypes.c_int32,  # n_threads
    ]
    lib.jt_decode_scan_planes_spec.restype = ctypes.c_int64
    lib.jt_decode_scan_planes_spec.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64,  # data, n_bytes, n_mcus
        u8p, u8p, u8p, ctypes.c_int32,  # slot comp/vi/hi, blocks_per_mcu
        u8p, u8p, u8p, u8p, ctypes.c_int32,  # comp dc/ac/h/v, n_comp
        ctypes.c_int32,  # mcus_x
        u16p, u16p,  # packed LUTs
        ctypes.POINTER(i16p), i64p,  # plane ptrs, strides
        i64p, ctypes.c_int32,  # plane rows, prezero mode
        ctypes.c_int32, ctypes.c_int32,  # n_chunks, n_threads
    ]
    lib.jt_unstuff_scan.restype = ctypes.c_int64
    lib.jt_unstuff_scan.argtypes = [
        u8p, ctypes.c_int64, u8p, i64p, i64p, i64p, ctypes.c_int64, i64p,
    ]
    # Sequential arithmetic (SOF9) and progressive (SOF2/SOF10) entry
    # points, copied from jpeg_tpu/runtime/__init__.py::_configure.
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.jt_decode_arith_scan_planes.restype = ctypes.c_int64
    lib.jt_decode_arith_scan_planes.argtypes = [
        u8p, ctypes.c_int64,
        i64p, i64p, i64p, i64p, ctypes.c_int64,
        u8p, u8p, u8p, ctypes.c_int32,
        u8p, u8p, u8p, u8p, ctypes.c_int32,
        ctypes.c_int32,
        u8p, u8p, u8p,  # conditioning L/U/Kx
        ctypes.POINTER(i16p), i64p, i64p, ctypes.c_int32,
        ctypes.c_int32,
    ]
    lib.jt_decode_arith_scan.restype = ctypes.c_int64
    lib.jt_decode_arith_scan.argtypes = [
        u8p, ctypes.c_int64,
        i64p, i64p, i64p, i64p, ctypes.c_int64,
        u8p, ctypes.c_int32,
        u8p, u8p, ctypes.c_int32,
        u8p, u8p, u8p,
        i32p, ctypes.c_int32,
    ]
    lib.jt_decode_prog_dc.restype = ctypes.c_int64
    lib.jt_decode_prog_dc.argtypes = [
        u8p, i64p, i64p, ctypes.c_int64,  # data, seg bounds, n_segs
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,  # ri, ah, al
        ctypes.c_int32, i32p, i32p,  # n_scan_comps, comp h, comp v
        ctypes.POINTER(i32p), i64p,  # state ptrs, state cols
        u16p, i32p,  # dc LUTs, scan dc ids
        ctypes.c_int32, ctypes.c_int64,  # mcus_x, n_units
        ctypes.c_int32, i64p, ctypes.c_int64,  # interleaved, comp_bw, unit_base
    ]
    i32pp = ctypes.POINTER(i32p)
    lib.jt_prog_assemble_stream.restype = None
    lib.jt_prog_assemble_stream.argtypes = [
        i32pp, i32pp, i64p,  # ac grids, dc grids, state cols
        u8p, u8p, u8p, ctypes.c_int32,  # slot comp/vi/hi, bpm
        u8p, u8p, ctypes.c_int32, ctypes.c_int32,  # comp h/v, n_comp, mcus_x
        ctypes.c_int64, i32p, ctypes.c_int32,  # n_mcus, out, n_threads
        i64p, ctypes.c_int64,  # straggler-scan row gate (+scale), or NULL
    ]
    lib.jt_prog_assemble_planes.restype = None
    lib.jt_prog_assemble_planes.argtypes = [
        i32pp, i32pp, i64p,
        u8p, u8p, u8p, ctypes.c_int32,
        u8p, u8p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, ctypes.POINTER(i16p), i64p, ctypes.c_int32,
    ]
    lib.jt_decode_arith_prog_dc.restype = ctypes.c_int64
    lib.jt_decode_arith_prog_dc.argtypes = [
        u8p, i64p, i64p, ctypes.c_int64,  # data, seg bounds, n_segs
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,  # ri, ah, al
        ctypes.c_int32, i32p, i32p,  # n_scan_comps, comp h, comp v
        i32pp, i64p,  # dc state ptrs, state cols
        i32p, u8p, u8p,  # scan dc ids, dc_L, dc_U
        ctypes.c_int32, ctypes.c_int64,  # mcus_x, n_units
        ctypes.c_int32, i64p,  # interleaved, comp_bw
    ]
    lib.jt_decode_arith_prog_ac.restype = ctypes.c_int64
    lib.jt_decode_arith_prog_ac.argtypes = [
        u8p, i64p, i64p, ctypes.c_int64,
        ctypes.c_int64,  # restart blocks
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32,  # kx
        i32p, ctypes.c_int64,  # state, state cols
        ctypes.c_int64, ctypes.c_int64,  # bw, n_blocks
    ]
    lib.jt_decode_prog_ac.restype = ctypes.c_int64
    lib.jt_decode_prog_ac.argtypes = [
        u8p, i64p, i64p, ctypes.c_int64,  # data, seg bounds, n_segs
        ctypes.c_int64,  # restart blocks
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # ss se ah al
        i32p, ctypes.c_int64,  # state, state cols
        u16p, ctypes.c_int32,  # ac LUTs, ac id
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # bw, n_blocks, unit_base
        i64p, i64p,  # done_rows (published progress), gate_rows (producer)
    ]


def asan() -> bool:
    """Whether this process loads the AddressSanitizer builds."""
    return os.environ.get("JPEG_TPU_ASAN") == "1"


def library_name() -> str:
    """The name the C++ runtime loads under in this process."""
    return "jpegtpu_asan" if asan() else "jpegtpu"


def pgo() -> build.PGO:
    """The runtime's profile-guided training: the port's training child on
    the instrumented library, hashed with the streams it reads."""
    from jpeg_tpu_torch.tools import pgo_train

    return build.PGO((sys.executable, "-m", "jpeg_tpu_torch.tools.pgo_train"),
                     (pgo_train.__file__, *pgo_train.STREAMS))


def load() -> ctypes.CDLL:
    """Build (at first use) and load the C++ runtime: profile-guided, or
    with AddressSanitizer under ``JPEG_TPU_ASAN=1``."""
    name = library_name()
    got = build.loaded(name)
    if got is not None:
        return got[0]
    if asan():
        name, cmd, sources, headers = ASAN_BUILDS[0]
        return load_library(name, cmd, sources, _configure, headers=headers)
    return load_library(name, ["g++", *GXX_FLAGS], [PORT_SOURCE], _configure,
                        headers=(SOURCE,), pgo=pgo())


def pgo_status() -> str:
    """'on' if the loaded C++ runtime was built profile-guided, 'off' if it
    is a plain build (its training could not run, or an ASan build),
    'unknown' before this process loads it."""
    got = build.loaded(library_name())
    if got is None:
        return "unknown"
    info = build.build_info(library_name())
    return info["pgo"] if info is not None else "off"


def build_info() -> dict | None:
    """The loaded runtime's build record: ``pgo`` and the seconds of the
    instrumented build, the training and the rebuild (None before it is
    loaded, or for a build that was not profile-guided)."""
    return build.build_info(library_name())


def native_available() -> bool:
    """Whether the C++ runtime builds and loads here (it is built at the
    first call)."""
    try:
        load()
        return True
    except (OSError, BuildError):
        return False


def _p(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


# 32 packed slot sets of 512 KiB each ([4, 65536] u16): 16 MiB at most.
PACKED_CACHE_SIZE = 32
_PACKED = SharedCache(PACKED_CACHE_SIZE)


def _pack(tables) -> np.ndarray:
    return np.ascontiguousarray(np.stack(
        [(t.lut_value.astype(np.uint16) << 8) | t.lut_length for t in tables]))


def _packed_luts(tables) -> np.ndarray:
    """[4, 65536] u16 packed (value << 8) | length per table slot.

    Shared and read-only where every slot's table is one the table cache
    handed out (``entropy.tables.table_key``): kept per the slots' DHT
    contents, at most :data:`PACKED_CACHE_SIZE` = 32 sets, 16 MiB, least
    recently used dropped. Any other table set is packed afresh."""
    keys = tuple(table_key(t) for t in tables)
    if None in keys:
        return _pack(tables)
    return _PACKED.get(keys, lambda: frozen(_pack(tables)))[0]


def _plane_args(plan):
    """Plan-derived ctypes arguments, cached on the plan (corpus workers
    call once per frame; rebuilding them serializes on the GIL)."""
    cached = getattr(plan, "_native_plane_args", None)
    if cached is not None:
        return cached
    segs = plan.segments
    slots = plan.component_block_slots()
    comps = plan.components
    shapes = plane_shapes(plan)
    cached = dict(
        data=np.ascontiguousarray(plan.scan_data, dtype=np.uint8),
        seg_start=np.array([s.byte_start for s in segs], np.int64),
        seg_end=np.array([s.byte_end for s in segs], np.int64),
        seg_mcu_start=np.array([s.mcu_start for s in segs], np.int64),
        seg_mcu_count=np.array([s.mcu_count for s in segs], np.int64),
        slot_comp=np.array([ci for ci, _ in slots], np.uint8),
        slot_vi=np.array([sub // comps[ci].h for ci, sub in slots], np.uint8),
        slot_hi=np.array([sub % comps[ci].h for ci, sub in slots], np.uint8),
        comp_dc=np.array([c.dc_id for c in comps], np.uint8),
        comp_ac=np.array([c.ac_id for c in comps], np.uint8),
        comp_h=np.array([c.h for c in comps], np.uint8),
        comp_v=np.array([c.v for c in comps], np.uint8),
        dc_luts=_packed_luts(plan.dc_tables),
        ac_luts=_packed_luts(plan.ac_tables),
        shapes=shapes,
        strides=np.array([s[1] for s in shapes], np.int64),
        rows=np.array([s[0] for s in shapes], np.int64),
    )
    plan._native_plane_args = cached
    return cached


class SpecTuner:
    """Measured chunk count of the speculative decode of scans without
    restart markers: the JAX runtime's tuner (``_spec_chunks``,
    ``_spec_feedback``, ``spec_tuner_snapshot``), the same rules.

    Per (geometry, scan-size) class, the first calls trial the candidates
    ``{4, 6, 8} x n_threads`` round-robin, two timed trials each (the
    caller reports each call's wall time through :meth:`feedback`), then
    lock in the fastest by its best trial. The pick persists to ``path``
    keyed on the class, the host's core count and the loaded runtime's
    file name, which carries its build hash: a rebuilt library invalidates
    the picks of the old one. A pick loaded from the file is in force at
    once, but the next calls still hand out one confirmation trial per
    candidate, so that a snapshot carries this process's timings. A broken
    or unwritable file degrades to trialling; it never raises."""

    def __init__(self, path: str, library_key):
        self.path = path
        self._library_key = library_key  # () -> the loaded runtime's name
        self._state: dict = {}
        self._lock = threading.Lock()

    @staticmethod
    def key(plan) -> tuple:
        return (plan.width, plan.height, len(plan.components),
                int(len(plan.scan_data)) >> 18)

    def persist_key(self, key) -> str:
        return f"{key}|cores={os.cpu_count()}|so={self._library_key()}"

    def load(self, key):
        try:
            with open(self.path) as f:
                return json.load(f).get(self.persist_key(key))
        except (OSError, ValueError, AttributeError):
            return None

    def store(self, key, chosen: int) -> None:
        try:
            try:
                with open(self.path) as f:
                    d = json.load(f)
                if not isinstance(d, dict):
                    d = {}
            except (OSError, ValueError):
                d = {}
            d[self.persist_key(key)] = chosen
            tmp = f"{self.path}.tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(d, f)
            os.replace(tmp, self.path)
        except OSError:
            pass  # persistence is best-effort, as in the JAX runtime

    def chunks(self, plan, n_threads: int) -> int:
        """The chunk count for this call of ``plan``'s class."""
        with self._lock:
            key = self.key(plan)
            st = self._state.get(key)
            if st is None:
                cands = sorted({4 * n_threads, 6 * n_threads, 8 * n_threads})
                persisted = self.load(key)
                st = {"cands": cands, "times": {k: [] for k in cands},
                      "chosen": persisted, "i": 0,
                      "confirm": len(cands) if persisted is not None else 0}
                self._state[key] = st
            if st["chosen"] is not None:
                if st["confirm"] > 0:
                    st["confirm"] -= 1
                    return st["cands"][st["confirm"] % len(st["cands"])]
                return st["chosen"]
            cands = st["cands"]
            if all(len(st["times"][k]) >= 2 for k in cands):
                st["chosen"] = min(cands, key=lambda k: min(st["times"][k]))
                self.store(key, st["chosen"])
                return st["chosen"]
            k = cands[st["i"] % len(cands)]
            st["i"] += 1
            return k

    def feedback(self, plan, k: int, dt: float) -> None:
        """Record a call's wall time ``dt`` (s) at chunk count ``k``."""
        with self._lock:
            st = self._state.get(self.key(plan))
            if st is not None and k in st["times"]:
                st["times"][k].append(dt)

    def snapshot(self) -> dict:
        """Per class key: the chosen count and each candidate's best trial
        (ms, None before its first)."""
        with self._lock:
            return {
                str(key): {
                    "chosen": st["chosen"],
                    "best_ms": {str(k): (round(min(v) * 1e3, 3) if v else None)
                                for k, v in st["times"].items()},
                }
                for key, st in self._state.items()
            }


def _library_file() -> str:
    got = build.loaded(library_name())
    return os.path.basename(got[1]) if got is not None else "unloaded"


_TUNER = SpecTuner(SPEC_TUNER_PATH, _library_file)


def spec_tuner_snapshot() -> dict:
    """The chunk tuner's state (:meth:`SpecTuner.snapshot`), for benchmark
    records."""
    return _TUNER.snapshot()


def native_decode_planes(plan, n_threads: int | None = None,
                         reuse_buffer: bool = True,
                         speculative: bool | None = None,
                         n_chunks: int | None = None) -> list[np.ndarray]:
    """Threaded entropy decode into per-component natural-order int16 planes
    in the padded layout of :func:`plane_shapes` (pad regions zero).

    Restart-segmented scans decode segment-parallel. A single-segment scan
    decodes speculatively (bit-identical: a broken sync link falls back to
    sequential decode inside the library) when ``speculative`` is true, or,
    with ``speculative=None``, when the scan holds at least 64 KB and
    ``n_threads > 1``; in as many chunks as ``n_chunks`` says or, when it
    is None, as :class:`SpecTuner` picks, each such call's wall time fed
    back to the tuner (as ``jpeg_tpu.runtime.native_decode_planes`` does).

    With ``reuse_buffer`` (default) the planes are this thread's scratch
    buffers, overwritten by its next same-geometry call: consume or copy
    them first. Raises :class:`NativeDecodeError` on an invalid prefix.
    """
    lib = load()
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    a = _plane_args(plan)
    planes, ptrs, fresh = _thread_planes(a["shapes"], reuse_buffer)
    # Fresh np.zeros planes are already zero (mode 0: sparse writes only);
    # a reused buffer holds the previous frame (mode 2: bulk zero first).
    prezero = 0 if fresh else 2
    common = (
        _p(a["slot_comp"], ctypes.c_uint8), _p(a["slot_vi"], ctypes.c_uint8),
        _p(a["slot_hi"], ctypes.c_uint8), plan.blocks_per_mcu,
        _p(a["comp_dc"], ctypes.c_uint8), _p(a["comp_ac"], ctypes.c_uint8),
        _p(a["comp_h"], ctypes.c_uint8), _p(a["comp_v"], ctypes.c_uint8),
        len(plan.components), plan.mcus_x,
        _p(a["dc_luts"], ctypes.c_uint16), _p(a["ac_luts"], ctypes.c_uint16),
        ptrs, _p(a["strides"], ctypes.c_int64),
        _p(a["rows"], ctypes.c_int64), prezero,
    )
    data = a["data"]
    if speculative is None:
        speculative = (len(plan.segments) == 1 and data.size >= 65536
                       and n_threads > 1)
    if speculative and len(plan.segments) == 1:
        k = n_chunks if n_chunks else _TUNER.chunks(plan, n_threads)
        t0 = time.perf_counter()
        err = lib.jt_decode_scan_planes_spec(
            _p(data, ctypes.c_uint8), data.size, plan.n_mcus, *common,
            k, n_threads)
        if n_chunks is None:
            _TUNER.feedback(plan, k, time.perf_counter() - t0)
    else:
        err = lib.jt_decode_scan_planes(
            _p(data, ctypes.c_uint8), data.size,
            _p(a["seg_start"], ctypes.c_int64), _p(a["seg_end"], ctypes.c_int64),
            _p(a["seg_mcu_start"], ctypes.c_int64),
            _p(a["seg_mcu_count"], ctypes.c_int64), len(plan.segments),
            *common, n_threads)
    if err >= 0:
        raise NativeDecodeError(int(err))
    return planes


def native_decode_coefficients(plan, n_threads: int | None = None,
                               reuse_buffer: bool = True) -> np.ndarray:
    """Threaded entropy decode -> ``[total_blocks, 64]`` int32 zigzag
    blocks, DC prediction applied, MCU stream order (the contract of
    ``jpeg_tpu.runtime.native_decode_coefficients``). Restart segments
    decode in parallel across ``n_threads`` (default: cpu count).

    With ``reuse_buffer`` (default) the array is this thread's scratch
    buffer, overwritten by its next call for the same block count: consume
    or copy it first. Raises :class:`NativeDecodeError` on an invalid
    prefix."""
    lib = load()
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    a = _plane_args(plan)
    bufs = getattr(_tls, "coeffs", None)
    if bufs is None:
        bufs = _tls.coeffs = {}
    out = bufs.get(plan.total_blocks) if reuse_buffer else None
    if out is None:
        # The C++ side zeroes each block as it decodes it.
        out = np.empty((plan.total_blocks, 64), dtype=np.int32)
        if reuse_buffer:
            bufs[plan.total_blocks] = out
    data = a["data"]
    err = lib.jt_decode_scan(
        _p(data, ctypes.c_uint8), data.size,
        _p(a["seg_start"], ctypes.c_int64), _p(a["seg_end"], ctypes.c_int64),
        _p(a["seg_mcu_start"], ctypes.c_int64),
        _p(a["seg_mcu_count"], ctypes.c_int64), len(plan.segments),
        _p(a["slot_comp"], ctypes.c_uint8), plan.blocks_per_mcu,
        _p(a["comp_dc"], ctypes.c_uint8), _p(a["comp_ac"], ctypes.c_uint8),
        len(plan.components),
        _p(a["dc_luts"], ctypes.c_uint16), _p(a["ac_luts"], ctypes.c_uint16),
        _p(out, ctypes.c_int32), n_threads)
    if err >= 0:
        raise NativeDecodeError(int(err))
    # A truncated stream can declare fewer restart segments than the frame
    # holds; the C++ side writes only blocks inside declared segments, so
    # zero the tail (the reference's oracle fills it with zeros too).
    covered = int(a["seg_mcu_count"].sum()) * plan.blocks_per_mcu
    if covered < plan.total_blocks:
        out[covered:] = 0
    return out


def native_decode_gap(plan, start_bit: int, end_byte: int,
                      stop_bits: np.ndarray, max_mcus: int):
    """Sequential MCU decode from bit ``start_bit`` of the scan, stopping
    before an MCU that starts at a position in ``stop_bits`` (sorted i64)
    or after ``max_mcus`` MCUs; the scan reads as 0xAA from ``end_byte``
    on. The gap recovery of :mod:`jpeg_tpu_torch.entropy.device_spec`.
    Returns (blocks ``[n, bpm, 64]`` int32 zigzag with RAW DC deltas, pos
    ``[n]`` int64 bit position after each MCU), or None at an invalid
    prefix."""
    lib = load()
    a = _plane_args(plan)
    bpm = plan.blocks_per_mcu
    stops = np.ascontiguousarray(stop_bits, dtype=np.int64)
    out = np.empty((max_mcus * bpm, 64), dtype=np.int32)
    pos = np.empty(max_mcus, dtype=np.int64)
    n = lib.jt_decode_gap(
        _p(a["data"], ctypes.c_uint8), start_bit, end_byte,
        _p(stops, ctypes.c_int64), len(stops), max_mcus,
        _p(a["slot_comp"], ctypes.c_uint8), bpm,
        _p(a["comp_dc"], ctypes.c_uint8), _p(a["comp_ac"], ctypes.c_uint8),
        len(plan.components),
        _p(a["dc_luts"], ctypes.c_uint16), _p(a["ac_luts"], ctypes.c_uint16),
        _p(out, ctypes.c_int32), _p(pos, ctypes.c_int64))
    if n < 0:
        return None
    return out[: n * bpm].reshape(n, bpm, 64), pos[:n]


def _lossless_args(plan, n_threads):
    data = np.ascontiguousarray(plan.scan_data, dtype=np.uint8)
    segs = [np.array([getattr(s, f) for s in plan.segments], np.int64)
            for f in ("byte_start", "byte_end", "mcu_start", "mcu_count")]
    comp_dc = np.array([c.dc_id for c in plan.components], np.int32)
    dc_luts = _packed_luts(plan.dc_tables)
    keep = (data, segs, comp_dc, dc_luts)  # alive until the call returns
    args = (_p(data, ctypes.c_uint8), *(_p(a, ctypes.c_int64) for a in segs),
            len(plan.segments), len(plan.components),
            _p(dc_luts, ctypes.c_uint16), _p(comp_dc, ctypes.c_int32))
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    return keep, args, n_threads


def native_decode_lossless(plan, n_threads: int | None = None) -> np.ndarray:
    """Lossless (SOF3) decode -> ``[H, W, ncomp]`` uint16 samples, the
    contract of :func:`jpeg_tpu_torch.entropy.lossless.decode_lossless`:
    differences decode in parallel over restart segments, the prediction
    pass runs in order. Raises :class:`NativeDecodeError` on an invalid
    prefix."""
    _keep, args, n_threads = _lossless_args(plan, n_threads)
    out = np.zeros((plan.height, plan.width, len(plan.components)), np.uint16)
    err = load().jt_decode_lossless(
        *args, plan.width, plan.height,
        plan.predictor, plan.point_transform, plan.precision,
        _p(out, ctypes.c_uint16), n_threads)
    if err >= 0:
        raise NativeDecodeError(int(err))
    return out


def native_decode_lossless_diffs(plan,
                                 n_threads: int | None = None) -> np.ndarray:
    """Lossless (SOF3) prediction differences -> ``[H, W, ncomp]`` uint16,
    :func:`jpeg_tpu_torch.entropy.lossless.decode_diffs` mod 2^16 (the
    first phase of ``jt_decode_lossless``, parallel over restart segments).
    Raises :class:`NativeDecodeError` on an invalid prefix."""
    _keep, args, n_threads = _lossless_args(plan, n_threads)
    out = np.zeros((plan.height, plan.width, len(plan.components)), np.uint16)
    err = load().jt_decode_lossless_diffs(*args, _p(out, ctypes.c_uint16),
                                          n_threads)
    if err >= 0:
        raise NativeDecodeError(int(err))
    return out


def plane_shapes(plan) -> list[tuple[int, int]]:
    """K1's padded [rows, stride] per component (the layout every plane
    decoder here writes)."""
    from jpeg_tpu_torch.models.decoder import PipelineGeometry
    from jpeg_tpu_torch.ops.fused_plane import padded_plane_shapes

    return padded_plane_shapes(PipelineGeometry.of(plan))


def _thread_planes(shapes, reuse_buffer: bool = True):
    """(planes, ctypes pointer array, fresh) for ``shapes``: this thread's
    scratch planes (shared by every plane decoder here, as in the JAX
    package) or, without ``reuse_buffer``, new zeroed ones."""
    shapes = tuple(shapes)
    bufs = getattr(_tls, "planes", None)
    if bufs is None:
        bufs = _tls.planes = {}
    cached = bufs.get(shapes) if reuse_buffer else None
    if cached is not None:
        return (*cached, False)
    planes = [np.zeros(s, dtype=np.int16) for s in shapes]
    i16p = ctypes.POINTER(ctypes.c_int16)
    ptrs = (i16p * len(planes))(*[_p(p, ctypes.c_int16) for p in planes])
    if reuse_buffer:
        bufs[shapes] = (planes, ptrs)
    return planes, ptrs, True


def _run_segment_slices(fn, n_segs, max_workers=4):
    """Run fn(s0, s1) over restart-segment slices, in parallel when there
    are enough segments (each restart segment is independent)."""
    if n_segs <= 1:
        return [fn(0, n_segs)]
    nt = min(max_workers, os.cpu_count() or 1, n_segs)
    if nt <= 1:
        return [fn(0, n_segs)]
    slices = [(n_segs * t // nt, n_segs * (t + 1) // nt) for t in range(nt)]
    with ThreadPoolExecutor(max_workers=nt) as ex:
        return list(ex.map(lambda ab: fn(*ab), slices))


def _prog_grids(plan):
    """This thread's progressive scan grids for the plan's geometry:
    per component an AC grid [bh, bw, 64] and a compact DC grid [bh, bw]
    of int32. The chains zero them before decoding (a fresh 100+ MB
    np.zeros per 4K frame costs more in page faults than the scans)."""
    gshapes = tuple(
        (plan.mcus_y * c.v, plan.mcus_x * c.h) for c in plan.components)
    bufs = getattr(_tls, "prog_state", None)
    if bufs is None:
        bufs = _tls.prog_state = {}
    cached = bufs.get(gshapes)
    if cached is None:
        cached = bufs[gshapes] = (
            [np.empty(sh + (64,), np.int32) for sh in gshapes],
            [np.empty(sh, np.int32) for sh in gshapes])
    return cached


def _comp_block_dims(plan, ci):
    """(block rows, block cols) of component ``ci``'s own (non-interleaved)
    scans."""
    c = plan.components[ci]
    cw = -(-plan.width * c.h // plan.h_max)
    ch = -(-plan.height * c.v // plan.v_max)
    return -(-ch // 8), -(-cw // 8)


def _prog_chains(plan):
    """Ordered scan chains: the DC scans of every component, then one AC
    chain per component. Chains touch disjoint coefficients."""
    chains: dict = {"dc": []}
    for scan in plan.prog_scans:
        if scan.ss == 0:
            chains["dc"].append(("dc", scan))
        else:
            chains.setdefault(scan.comp_indices[0], []).append(("ac", scan))
    return [c for c in chains.values() if c]


def _zero_uncovered(plan, state, dc_state):
    """Reused grids are zeroed by the chain that decodes into them; a
    component with no AC (or DC) scan at all (legal DC-only progressive)
    is zeroed here, or assembly would read a stale frame."""
    ac_covered = {ci for sc in plan.prog_scans if sc.ss > 0
                  for ci in sc.comp_indices}
    dc_covered = {ci for sc in plan.prog_scans if sc.ss == 0
                  for ci in sc.comp_indices}
    for ci in range(len(plan.components)):
        if ci not in ac_covered:
            state[ci][...] = 0
        if ci not in dc_covered:
            dc_state[ci][...] = 0


def _run_chain(items, state, dc_state, run_dc, run_ac):
    zeroed = set()
    for kind, scan in items:
        for ci in scan.comp_indices:
            if kind == "dc" and ("dc", ci) not in zeroed:
                dc_state[ci][...] = 0
                zeroed.add(("dc", ci))
            elif kind != "dc" and ("ac", ci) not in zeroed:
                state[ci][...] = 0
                zeroed.add(("ac", ci))
        (run_dc if kind == "dc" else run_ac)(scan)


def _check_decoded(err) -> None:
    if err >= 0:
        raise NativeDecodeError(int(err))


def _prog_run_scans(plan, n_threads, defer_straggler=False):
    """Run all progressive Huffman scans in C++ -> (ac_state, dc_state,
    straggler).

    ac_state: per-component [bh, bw, 64] int32 zigzag grids (AC coeffs);
    dc_state: per-component compact [bh, bw] int32 DC grids. The DC chain
    and each component's AC chain run concurrently; scans within a chain
    stay ordered. The heaviest chain, when it is all single-segment AC
    scans, runs row-pipelined: every scan on its own thread, gated row by
    row on the previous scan's published progress. With
    ``defer_straggler`` its last scan is left running and ``straggler``
    holds ``join``, its progress ``gate`` and the row ``scale`` for an
    assembly that overlaps it; otherwise ``straggler`` is None.
    """
    from jpeg_tpu_torch.io.container import JPEGError

    lib = load()
    state, dc_state = _prog_grids(plan)
    i32p = ctypes.POINTER(ctypes.c_int32)

    def run_dc(scan):
        if scan.se != 0:
            raise JPEGError("progressive DC scan must have se == 0")
        interleaved = len(scan.comp_indices) > 1
        if interleaved:
            n_units = plan.n_mcus
            bw0 = 0
        else:
            bh, bw0 = _comp_block_dims(plan, scan.comp_indices[0])
            n_units = bh * bw0
        ri = scan.restart_interval or n_units
        data = np.ascontiguousarray(scan.scan_data)
        seg_s = np.array([b[0] for b in scan.bounds], np.int64)
        seg_e = np.array([b[1] for b in scan.bounds], np.int64)
        comp_h = np.array(
            [plan.components[ci].h for ci in scan.comp_indices], np.int32)
        comp_v = np.array(
            [plan.components[ci].v for ci in scan.comp_indices], np.int32)
        ptrs = (i32p * len(scan.comp_indices))(
            *[_p(dc_state[ci], ctypes.c_int32) for ci in scan.comp_indices])
        cols = np.array(
            [dc_state[ci].shape[1] for ci in scan.comp_indices], np.int64)
        dc_luts = _packed_luts(scan.dc_tables)
        dc_ids = np.array(scan.dc_ids, np.int32)
        bws = np.array([bw0], np.int64)

        def dc_slice(s0, s1):
            return lib.jt_decode_prog_dc(
                _p(data, ctypes.c_uint8),
                _p(seg_s[s0:].copy(), ctypes.c_int64),
                _p(seg_e[s0:].copy(), ctypes.c_int64),
                s1 - s0, ri, scan.ah, scan.al,
                len(scan.comp_indices), _p(comp_h, ctypes.c_int32),
                _p(comp_v, ctypes.c_int32), ptrs, _p(cols, ctypes.c_int64),
                _p(dc_luts, ctypes.c_uint16), _p(dc_ids, ctypes.c_int32),
                plan.mcus_x, min(n_units, s1 * ri), int(interleaved),
                _p(bws, ctypes.c_int64), s0 * ri,
            )

        for err in _run_segment_slices(dc_slice, len(scan.bounds)):
            _check_decoded(err)

    def run_ac(scan, done=None, gate=None):
        if len(scan.comp_indices) != 1:
            raise JPEGError("progressive AC scan must have one component")
        ci = scan.comp_indices[0]
        bh, bw = _comp_block_dims(plan, ci)
        n_blocks = bh * bw
        ri = scan.restart_interval or n_blocks
        data = np.ascontiguousarray(scan.scan_data)
        seg_s = np.array([b[0] for b in scan.bounds], np.int64)
        seg_e = np.array([b[1] for b in scan.bounds], np.int64)
        ac_luts = _packed_luts(scan.ac_tables)
        done_p = _p(done, ctypes.c_int64) if done is not None else None
        gate_p = _p(gate, ctypes.c_int64) if gate is not None else None

        def ac_slice(s0, s1):
            return lib.jt_decode_prog_ac(
                _p(data, ctypes.c_uint8),
                _p(seg_s[s0:].copy(), ctypes.c_int64),
                _p(seg_e[s0:].copy(), ctypes.c_int64),
                s1 - s0, ri, scan.ss, scan.se, scan.ah, scan.al,
                _p(state[ci], ctypes.c_int32), state[ci].shape[1],
                _p(ac_luts, ctypes.c_uint16), scan.ac_ids[0], bw,
                min(n_blocks, s1 * ri), s0 * ri, done_p, gate_p,
            )

        for err in _run_segment_slices(ac_slice, len(scan.bounds)):
            _check_decoded(err)

    if n_threads is None:
        n_threads = os.cpu_count() or 1
    _zero_uncovered(plan, state, dc_state)
    chain_lists = _prog_chains(plan)
    if n_threads <= 1 or len(chain_lists) <= 1:
        for c in chain_lists:
            _run_chain(c, state, dc_state, run_dc, run_ac)
        return state, dc_state, None

    # Pipeline only the heaviest chain (one thread per scan, row-gated):
    # its slowest scan is the critical path and must own a core. Every
    # other chain runs in one sequential task; pipelining small chroma
    # scans would only take cores from the critical scan.
    def chain_bytes(items):
        return sum(len(scan.scan_data) for _kind, scan in items)

    big = max(chain_lists, key=chain_bytes)
    tasks, small = [], []
    straggler_idx = straggler_gate = None
    straggler_scale = 1
    for items in chain_lists:
        if not (items is big and len(items) > 1
                and all(kind == "ac" and len(scan.bounds) == 1
                        for kind, scan in items)):
            small.append(items)
            continue
        progress = [np.zeros(1, np.int64) for _ in items]
        ci = items[0][1].comp_indices[0]

        def make_task(j, scan, ci=ci, progress=progress):
            def task():
                if j == 0:
                    state[ci][...] = 0
                run_ac(scan, done=progress[j],
                       gate=progress[j - 1] if j > 0 else None)
            return task

        for j, (_kind, scan) in enumerate(items):
            if j == len(items) - 1:
                straggler_idx = len(tasks)
                straggler_gate = progress[j]
                straggler_scale = plan.components[ci].v
            tasks.append(make_task(j, scan))
    if small:
        def run_small(chains=tuple(small)):
            for items in chains:
                _run_chain(items, state, dc_state, run_dc, run_ac)
        tasks.append(run_small)
    if len(tasks) == 1:
        tasks[0]()
        return state, dc_state, None
    # One worker per task: a gated consumer must never keep a queued
    # producer from starting (deadlock), so every task gets a thread and
    # the consumers' spin loops yield the core.
    ex = ThreadPoolExecutor(max_workers=len(tasks))
    futs = [ex.submit(fn) for fn in tasks]
    if defer_straggler and straggler_idx is not None:
        try:
            for i, f in enumerate(futs):
                if i != straggler_idx:
                    f.result()
        except BaseException:
            ex.shutdown(wait=True, cancel_futures=True)
            raise
        fut = futs[straggler_idx]

        def join(fut=fut, ex=ex):
            try:
                fut.result()
            finally:
                ex.shutdown(wait=True, cancel_futures=True)

        return state, dc_state, {"join": join, "gate": straggler_gate,
                                  "scale": straggler_scale}
    try:
        for f in futs:
            f.result()
    finally:
        ex.shutdown(wait=True, cancel_futures=True)
    return state, dc_state, None


def _prog_run_scans_arith(plan, n_threads, defer_straggler=False):
    """Arithmetic (SOF10) twin of :func:`_prog_run_scans`: C++ per-scan
    decoders, chain-parallel across components, the same grid layouts.
    Never defers a scan (``straggler`` is None)."""
    from jpeg_tpu_torch.io.container import JPEGError

    del defer_straggler
    lib = load()
    state, dc_state = _prog_grids(plan)
    i32p = ctypes.POINTER(ctypes.c_int32)

    def run_dc(scan):
        if scan.se != 0:
            raise JPEGError("progressive DC scan must have se == 0")
        interleaved = len(scan.comp_indices) > 1
        if interleaved:
            n_units = plan.n_mcus
            bw0 = 0
        else:
            bh, bw0 = _comp_block_dims(plan, scan.comp_indices[0])
            n_units = bh * bw0
        ri = scan.restart_interval or n_units
        data = np.ascontiguousarray(scan.scan_data)
        seg_s = np.array([b[0] for b in scan.bounds], np.int64)
        seg_e = np.array([b[1] for b in scan.bounds], np.int64)
        comp_h = np.array(
            [plan.components[ci].h for ci in scan.comp_indices], np.int32)
        comp_v = np.array(
            [plan.components[ci].v for ci in scan.comp_indices], np.int32)
        ptrs = (i32p * len(scan.comp_indices))(
            *[_p(dc_state[ci], ctypes.c_int32) for ci in scan.comp_indices])
        cols = np.array(
            [dc_state[ci].shape[1] for ci in scan.comp_indices], np.int64)
        dc_ids = np.array(scan.dc_ids, np.int32)
        dc_L = np.array(scan.arith_dc_L, np.uint8)
        dc_U = np.array(scan.arith_dc_U, np.uint8)
        bws = np.array([bw0], np.int64)
        _check_decoded(lib.jt_decode_arith_prog_dc(
            _p(data, ctypes.c_uint8), _p(seg_s, ctypes.c_int64),
            _p(seg_e, ctypes.c_int64), len(scan.bounds), ri, scan.ah, scan.al,
            len(scan.comp_indices), _p(comp_h, ctypes.c_int32),
            _p(comp_v, ctypes.c_int32), ptrs, _p(cols, ctypes.c_int64),
            _p(dc_ids, ctypes.c_int32), _p(dc_L, ctypes.c_uint8),
            _p(dc_U, ctypes.c_uint8), plan.mcus_x, n_units, int(interleaved),
            _p(bws, ctypes.c_int64)))

    def run_ac(scan):
        if len(scan.comp_indices) != 1:
            raise JPEGError("progressive AC scan must have one component")
        ci = scan.comp_indices[0]
        bh, bw = _comp_block_dims(plan, ci)
        n_blocks = bh * bw
        ri = scan.restart_interval or n_blocks
        data = np.ascontiguousarray(scan.scan_data)
        seg_s = np.array([b[0] for b in scan.bounds], np.int64)
        seg_e = np.array([b[1] for b in scan.bounds], np.int64)
        kx = scan.arith_ac_K[scan.ac_ids[0]]
        _check_decoded(lib.jt_decode_arith_prog_ac(
            _p(data, ctypes.c_uint8), _p(seg_s, ctypes.c_int64),
            _p(seg_e, ctypes.c_int64), len(scan.bounds), ri,
            scan.ss, scan.se, scan.ah, scan.al, kx,
            _p(state[ci], ctypes.c_int32), state[ci].shape[1], bw, n_blocks))

    if n_threads is None:
        n_threads = os.cpu_count() or 1
    _zero_uncovered(plan, state, dc_state)
    chain_lists = _prog_chains(plan)
    if n_threads > 1 and len(chain_lists) > 1:
        with ThreadPoolExecutor(max_workers=min(n_threads,
                                                len(chain_lists))) as ex:
            list(ex.map(lambda c: _run_chain(c, state, dc_state, run_dc,
                                             run_ac), chain_lists))
    else:
        for c in chain_lists:
            _run_chain(c, state, dc_state, run_dc, run_ac)
    return state, dc_state, None


def _prog_slot_arrays(plan):
    slots = plan.component_block_slots()
    slot_comp = np.array([ci for ci, _ in slots], np.uint8)
    slot_vi = np.array(
        [sub // plan.components[ci].h for ci, sub in slots], np.uint8)
    slot_hi = np.array(
        [sub % plan.components[ci].h for ci, sub in slots], np.uint8)
    comp_h = np.array([c.h for c in plan.components], np.uint8)
    comp_v = np.array([c.v for c in plan.components], np.uint8)
    return slot_comp, slot_vi, slot_hi, comp_h, comp_v


def _prog_runner(plan):
    return (_prog_run_scans_arith if plan.arith_code else _prog_run_scans)


def _grid_ptrs(state, dc_state):
    i32p = ctypes.POINTER(ctypes.c_int32)
    ac_ptrs = (i32p * len(state))(*[_p(g, ctypes.c_int32) for g in state])
    dc_ptrs = (i32p * len(dc_state))(*[_p(g, ctypes.c_int32) for g in dc_state])
    cols = np.array([g.shape[1] for g in dc_state], np.int64)
    return ac_ptrs, dc_ptrs, cols


def native_decode_progressive(plan, n_threads: int | None = None,
                              reuse_buffer: bool = False) -> np.ndarray:
    """Progressive (SOF2, or arithmetic SOF10) entropy decode in C++ ->
    ``[total_blocks, 64]`` int32 zigzag blocks, MCU stream order (the
    contract of ``jpeg_tpu.runtime.native_decode_progressive``).

    The array is new and the caller's unless ``reuse_buffer=True``: then it
    is this thread's scratch buffer, overwritten by its next call for the
    same block count. Raises :class:`NativeDecodeError` on an invalid
    prefix."""
    lib = load()
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    state, dc_state, straggler = _prog_runner(plan)(plan, n_threads,
                                                    defer_straggler=True)
    slot_comp, slot_vi, slot_hi, comp_h, comp_v = _prog_slot_arrays(plan)
    out = None
    if reuse_buffer:
        bufs = getattr(_tls, "prog_out", None)
        if bufs is None:
            bufs = _tls.prog_out = {}
        out = bufs.get(plan.total_blocks)
    if out is None:
        out = np.empty((plan.total_blocks, 64), np.int32)
        if reuse_buffer:
            bufs[plan.total_blocks] = out
    ac_ptrs, dc_ptrs, cols = _grid_ptrs(state, dc_state)
    # The assembly overlaps the straggler scan (the heavy luma refinement),
    # row-gated on the progress counter the pipelined scans publish.
    gate_p = (_p(straggler["gate"], ctypes.c_int64)
              if straggler is not None else None)
    gate_scale = straggler["scale"] if straggler is not None else 0
    try:
        lib.jt_prog_assemble_stream(
            ac_ptrs, dc_ptrs, _p(cols, ctypes.c_int64),
            _p(slot_comp, ctypes.c_uint8), _p(slot_vi, ctypes.c_uint8),
            _p(slot_hi, ctypes.c_uint8), plan.blocks_per_mcu,
            _p(comp_h, ctypes.c_uint8), _p(comp_v, ctypes.c_uint8),
            len(plan.components), plan.mcus_x, plan.n_mcus,
            _p(out, ctypes.c_int32), n_threads, gate_p, gate_scale)
    finally:
        if straggler is not None:
            straggler["join"]()
    return out


def native_decode_progressive_planes(plan, n_threads: int | None = None
                                     ) -> list[np.ndarray]:
    """Progressive (SOF2 or SOF10) entropy decode -> natural-order int16
    planes in K1's padded layout (:func:`native_decode_planes`'s, pad
    regions zero), without the ``[total_blocks, 64]`` stream in between. The planes are this
    thread's scratch buffers, shared with :func:`native_decode_planes`:
    consume or copy them before the thread decodes another image of the
    same geometry."""
    lib = load()
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    state, dc_state, straggler = _prog_runner(plan)(plan, n_threads)
    if straggler is not None:
        straggler["join"]()
    slot_comp, slot_vi, slot_hi, comp_h, comp_v = _prog_slot_arrays(plan)
    shapes = plane_shapes(plan)
    planes, pptrs, fresh = _thread_planes(shapes)
    if not fresh:
        # The assembly writes every block of the MCU area; a reused buffer
        # may hold another geometry's samples beyond it, so zero the pad
        # (the JAX package leaves them there).
        for p, c in zip(planes, plan.components):
            rows, cols_used = plan.mcus_y * c.v * 8, plan.mcus_x * c.h * 8
            p[rows:] = 0
            p[:rows, cols_used:] = 0
    ac_ptrs, dc_ptrs, cols = _grid_ptrs(state, dc_state)
    strides = np.array([sh[1] for sh in shapes], np.int64)
    lib.jt_prog_assemble_planes(
        ac_ptrs, dc_ptrs, _p(cols, ctypes.c_int64),
        _p(slot_comp, ctypes.c_uint8), _p(slot_vi, ctypes.c_uint8),
        _p(slot_hi, ctypes.c_uint8), plan.blocks_per_mcu,
        _p(comp_h, ctypes.c_uint8), _p(comp_v, ctypes.c_uint8),
        len(plan.components), plan.mcus_x, plan.n_mcus,
        pptrs, _p(strides, ctypes.c_int64), n_threads)
    return planes


def _arith_args(plan):
    """Plan-derived arrays for the SOF9 entry points, cached on the plan."""
    cached = getattr(plan, "_arith_native_args", None)
    if cached is not None:
        return cached
    slots = plan.component_block_slots()
    comps = plan.components
    plan._arith_native_args = (
        np.ascontiguousarray(plan.scan_data, dtype=np.uint8),
        np.array([s.byte_start for s in plan.segments], np.int64),
        np.array([s.byte_end for s in plan.segments], np.int64),
        np.array([s.mcu_start for s in plan.segments], np.int64),
        np.array([s.mcu_count for s in plan.segments], np.int64),
        np.array([ci for ci, _ in slots], np.uint8),
        np.array([sub // comps[ci].h for ci, sub in slots], np.uint8),
        np.array([sub % comps[ci].h for ci, sub in slots], np.uint8),
        np.array([c.dc_id for c in comps], np.uint8),
        np.array([c.ac_id for c in comps], np.uint8),
        np.array([c.h for c in comps], np.uint8),
        np.array([c.v for c in comps], np.uint8),
        np.array(plan.arith_dc_L, np.uint8),
        np.array(plan.arith_dc_U, np.uint8),
        np.array(plan.arith_ac_K, np.uint8))
    return plan._arith_native_args


def _require_sof9(plan, what: str) -> None:
    if not plan.arith_code or plan.progressive:
        raise ValueError(f"{what} requires a sequential arithmetic (SOF9) plan")


def native_decode_arith_planes(plan, n_threads: int | None = None,
                               reuse_buffer: bool = True) -> list[np.ndarray]:
    """Sequential arithmetic (SOF9) entropy decode into natural-order int16
    planes in K1's padded layout, thread-parallel over restart segments.
    Same buffer and prezero contract as :func:`native_decode_planes`."""
    _require_sof9(plan, "native_decode_arith_planes")
    lib = load()
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    (data, seg_start, seg_end, seg_mcu_start, seg_mcu_count, slot_comp,
     slot_vi, slot_hi, comp_dc, comp_ac, comp_h, comp_v,
     dc_L, dc_U, ac_K) = _arith_args(plan)
    shapes = plane_shapes(plan)
    planes, ptrs, fresh = _thread_planes(shapes, reuse_buffer)
    strides = np.array([sh[1] for sh in shapes], np.int64)
    rows = np.array([sh[0] for sh in shapes], np.int64)
    _check_decoded(lib.jt_decode_arith_scan_planes(
        _p(data, ctypes.c_uint8), data.size,
        _p(seg_start, ctypes.c_int64), _p(seg_end, ctypes.c_int64),
        _p(seg_mcu_start, ctypes.c_int64), _p(seg_mcu_count, ctypes.c_int64),
        len(plan.segments),
        _p(slot_comp, ctypes.c_uint8), _p(slot_vi, ctypes.c_uint8),
        _p(slot_hi, ctypes.c_uint8), plan.blocks_per_mcu,
        _p(comp_dc, ctypes.c_uint8), _p(comp_ac, ctypes.c_uint8),
        _p(comp_h, ctypes.c_uint8), _p(comp_v, ctypes.c_uint8),
        len(plan.components), plan.mcus_x,
        _p(dc_L, ctypes.c_uint8), _p(dc_U, ctypes.c_uint8),
        _p(ac_K, ctypes.c_uint8),
        ptrs, _p(strides, ctypes.c_int64), _p(rows, ctypes.c_int64),
        0 if fresh else 2, n_threads))
    return planes


def native_decode_arith_coefficients(plan, n_threads: int | None = None
                                     ) -> np.ndarray:
    """Sequential arithmetic (SOF9) decode -> a new ``[total_blocks, 64]``
    int32 array of zigzag blocks, DC prediction applied, MCU stream order."""
    _require_sof9(plan, "native_decode_arith_coefficients")
    lib = load()
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    (data, seg_start, seg_end, seg_mcu_start, seg_mcu_count, slot_comp,
     _vi, _hi, comp_dc, comp_ac, _h, _v, dc_L, dc_U, ac_K) = _arith_args(plan)
    out = np.zeros((plan.total_blocks, 64), np.int32)
    _check_decoded(lib.jt_decode_arith_scan(
        _p(data, ctypes.c_uint8), data.size,
        _p(seg_start, ctypes.c_int64), _p(seg_end, ctypes.c_int64),
        _p(seg_mcu_start, ctypes.c_int64), _p(seg_mcu_count, ctypes.c_int64),
        len(plan.segments),
        _p(slot_comp, ctypes.c_uint8), plan.blocks_per_mcu,
        _p(comp_dc, ctypes.c_uint8), _p(comp_ac, ctypes.c_uint8),
        len(plan.components),
        _p(dc_L, ctypes.c_uint8), _p(dc_U, ctypes.c_uint8),
        _p(ac_K, ctypes.c_uint8),
        _p(out, ctypes.c_int32), n_threads))
    return out


def native_unstuff_scan(data: np.ndarray, start: int):
    """C++ byte unstuff + restart-segment scan. Same return contract as
    ``jpeg_tpu_torch.io.container._unstuff_and_segment``: (unstuffed bytes,
    [(start, end)] per segment, index of the terminating marker)."""
    lib = load()
    src = np.ascontiguousarray(data[start:], dtype=np.uint8)
    out = np.empty(src.size, dtype=np.uint8)
    max_segs = src.size // 2 + 2
    seg_s = np.zeros(max_segs, dtype=np.int64)
    seg_e = np.zeros(max_segs, dtype=np.int64)
    out_len = np.zeros(1, dtype=np.int64)
    consumed = np.zeros(1, dtype=np.int64)
    n = lib.jt_unstuff_scan(
        _p(src, ctypes.c_uint8), src.size,
        _p(out, ctypes.c_uint8), _p(out_len, ctypes.c_int64),
        _p(seg_s, ctypes.c_int64), _p(seg_e, ctypes.c_int64), max_segs,
        _p(consumed, ctypes.c_int64),
    )
    bounds = [(int(seg_s[i]), int(seg_e[i])) for i in range(int(n))]
    return out[: int(out_len[0])], bounds, start + int(consumed[0])


def _configure_enc(lib: ctypes.CDLL) -> None:
    """ctypes signatures of the encoder's entry points, as ``jpeg_tpu/
    runtime/__init__.py`` declares them (``_load_enc``, ``_load_prog_enc``)."""
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i16p = ctypes.POINTER(ctypes.c_int16)
    lib.jt_encode_arith_scan.restype = ctypes.c_int32
    lib.jt_encode_arith_scan.argtypes = [
        ctypes.POINTER(i16p), i64p,  # planes, strides
        u8p, u8p, u8p, ctypes.c_int32,  # slot comp/vi/hi, bpm
        u8p, u8p, ctypes.c_int32, ctypes.c_int32,  # comp h/v, n_comp, mcus_x
        ctypes.c_int64, ctypes.c_int32,  # n_mcus, restart_interval
        u8p, u8p, u8p, u8p,  # comp_tid, dc_L, dc_U, ac_K
        u8p, ctypes.c_int64, i64p,  # out, seg_capacity, seg_bytes
        ctypes.c_int32,  # n_threads
    ]
    lib.jt_encode_prog_ac.restype = ctypes.c_int64
    lib.jt_encode_prog_ac.argtypes = [
        i32p, ctypes.c_int64, ctypes.c_int64,  # state, cols, bw
        ctypes.c_int64, ctypes.c_int64,  # unit range [u0, u1)
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # ss se ah al
        ctypes.c_int32,  # mode: 0 count symbols, 1 emit
        i64p, u32p, u8p, u8p,  # freq, code, len, out
    ]
    lib.jt_encode_prog_dc.restype = ctypes.c_int64
    lib.jt_encode_prog_dc.argtypes = [
        ctypes.POINTER(i32p), i64p,  # state ptrs, cols
        ctypes.c_int32, i32p, i32p,  # n comps, h, v
        ctypes.c_int32, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        i64p,  # mcus_x, u0, u1, interleaved, bw
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # ah, al, mode
        ctypes.POINTER(i64p), ctypes.POINTER(u32p), ctypes.POINTER(u8p),
        u8p,  # out
    ]
    lib.jt_encode_scan.restype = ctypes.c_int32
    lib.jt_encode_scan.argtypes = [
        ctypes.POINTER(i16p), i64p,  # planes, strides
        u8p, u8p, u8p, ctypes.c_int32,  # slot comp/vi/hi, bpm
        u8p, u8p, ctypes.c_int32, ctypes.c_int32,  # comp h/v, n_comp, mcus_x
        ctypes.c_int64, ctypes.c_int32,  # n_mcus, restart_interval
        u32p, u8p, u32p, u8p,  # dc/ac code+len tables [2][256]
        u8p,  # comp_tid
        u8p, ctypes.c_int64, i64p,  # out, seg_capacity, seg_bytes
        ctypes.c_int32,  # n_threads
    ]


def load_encoder() -> ctypes.CDLL:
    """Build (at first use) and load the C++ entropy encoder (with
    AddressSanitizer under ``JPEG_TPU_ASAN=1``)."""
    if asan():
        name, cmd, sources, headers = ASAN_BUILDS[1]
        return load_library(name, cmd, sources, _configure_enc, headers=headers)
    return load_library("jpegtpu_enc", ["g++", *GXX_FLAGS], [ENC_SOURCE],
                        _configure_enc)


def _encode_segments(entry, planes, slots, comp_h, comp_v, mcus_x, n_mcus,
                     restart_interval, tables, bytes_per_coeff, n_threads):
    """Run a per-segment plane encoder (``jt_encode_scan`` or
    ``jt_encode_arith_scan``, whose argument lists differ only in
    ``tables``) into per-restart-segment byte strings, growing the output
    buffer up to twice if a segment overflows it."""
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    planes = [np.ascontiguousarray(p, dtype=np.int16) for p in planes]
    i16p = ctypes.POINTER(ctypes.c_int16)
    ptrs = (i16p * len(planes))(*[_p(p, ctypes.c_int16) for p in planes])
    strides = np.array([p.shape[1] for p in planes], dtype=np.int64)
    slot_arrays = [np.array([s[k] for s in slots], dtype=np.uint8)
                   for k in range(3)]
    bpm = len(slots)
    ri = restart_interval or n_mcus
    n_segs = -(-n_mcus // ri)
    seg_capacity = int(ri * bpm * 64 * bytes_per_coeff + 64)
    for _ in range(3):
        out = np.empty(n_segs * seg_capacity, dtype=np.uint8)
        seg_bytes = np.zeros(n_segs, dtype=np.int64)
        rc = entry(
            ptrs, _p(strides, ctypes.c_int64),
            *(_p(a, ctypes.c_uint8) for a in slot_arrays), bpm,
            _p(np.asarray(comp_h, np.uint8), ctypes.c_uint8),
            _p(np.asarray(comp_v, np.uint8), ctypes.c_uint8),
            len(planes), mcus_x, n_mcus, restart_interval, *tables,
            _p(out, ctypes.c_uint8), seg_capacity,
            _p(seg_bytes, ctypes.c_int64), n_threads,
        )
        if rc == 0:
            return [
                out[s * seg_capacity : s * seg_capacity + seg_bytes[s]].tobytes()
                for s in range(n_segs)
            ]
        seg_capacity *= 4
    raise RuntimeError("encode scan capacity overflow")


def native_encode_scan(planes, slots, comp_h, comp_v, mcus_x, n_mcus,
                       restart_interval, dc_code, dc_len, ac_code, ac_len,
                       comp_tid, n_threads: int | None = None) -> list[bytes]:
    """Entropy-encode quantized natural-order int16 planes -> per-restart-
    segment byte strings (each byte-aligned; caller interleaves RST markers).

    Parallel across segments. ``dc_code``/... are [2, 256] symbol tables
    (uint32 codes / uint8 lengths), ``comp_tid`` the 0/1 selector per
    component. Same contract as ``jpeg_tpu.runtime.native_encode_scan``.
    """
    # Worst case ~ stuffing-doubled 27 bits/coefficient.
    tables = (
        _p(np.ascontiguousarray(dc_code, np.uint32), ctypes.c_uint32),
        _p(np.ascontiguousarray(dc_len, np.uint8), ctypes.c_uint8),
        _p(np.ascontiguousarray(ac_code, np.uint32), ctypes.c_uint32),
        _p(np.ascontiguousarray(ac_len, np.uint8), ctypes.c_uint8),
        _p(np.asarray(comp_tid, np.uint8), ctypes.c_uint8))
    return _encode_segments(load_encoder().jt_encode_scan, planes, slots,
                            comp_h, comp_v, mcus_x, n_mcus, restart_interval,
                            tables, 8, n_threads)


def native_encode_arith_scan(planes, slots, comp_h, comp_v, mcus_x, n_mcus,
                             restart_interval, comp_tid,
                             n_threads: int | None = None) -> list[bytes]:
    """Arithmetic (SOF9) entropy encode of natural-order int16 planes ->
    per-restart-segment byte strings (QM coder, default conditioning L=0,
    U=1, Kx=5; parallel across segments). Same contract as
    ``jpeg_tpu.runtime.native_encode_arith_scan``."""
    tables = (_p(np.asarray(comp_tid, np.uint8), ctypes.c_uint8),
              _p(np.zeros(4, np.uint8), ctypes.c_uint8),
              _p(np.ones(4, np.uint8), ctypes.c_uint8),
              _p(np.full(4, 5, np.uint8), ctypes.c_uint8))
    return _encode_segments(load_encoder().jt_encode_arith_scan, planes, slots,
                            comp_h, comp_v, mcus_x, n_mcus, restart_interval,
                            tables, 4, n_threads)


def join_segments(chunks) -> bytes:
    """Restart segments joined into a scan, RST0..7 markers between them."""
    out = bytearray(chunks[0])
    for i, c in enumerate(chunks[1:]):
        out += bytes([0xFF, 0xD0 + (i % 8)])
        out += c
    return bytes(out)


def native_encode_progressive_scans(comp_blocks_zz, samplings, mcus_x, mcus_y,
                                    width, height, scan_script=None,
                                    restart_interval=0) -> list[dict]:
    """C++ twin of :func:`jpeg_tpu_torch.entropy.progressive_encode.
    encode_progressive_scans` (byte-identical output): per scan a dict of
    ``comps, ss, se, ah, al``, its optimal Huffman ``tables`` and its
    entropy-coded ``data``. Each scan counts its symbols in one C++ pass
    and emits in a second, segment by segment. Same contract as
    ``jpeg_tpu.runtime.native_encode_progressive_scans``."""
    from jpeg_tpu_torch.entropy.optimize import build_optimal_table
    from jpeg_tpu_torch.entropy.progressive_encode import standard_scan_script

    lib = load_encoder()
    ct = ctypes
    i64p, u32p = ct.POINTER(ct.c_int64), ct.POINTER(ct.c_uint32)
    u8p, i32p = ct.POINTER(ct.c_uint8), ct.POINTER(ct.c_int32)
    h_max = max(h for h, _ in samplings)
    v_max = max(v for _, v in samplings)
    states = [np.ascontiguousarray(b, dtype=np.int32) for b in comp_blocks_zz]

    def comp_block_dims(ci):
        h, v = samplings[ci]
        cw = -(-width * h // h_max)
        ch = -(-height * v // v_max)
        return -(-ch // 8), -(-cw // 8)

    def table_maps(table):
        code = np.zeros(256, dtype=np.uint32)
        length = np.zeros(256, dtype=np.uint8)
        code[table.values] = table.codes.astype(np.uint32)
        length[table.values] = table.lengths
        return code, length

    def segments(n_units):
        ri = restart_interval or n_units
        return [(u, min(u + ri, n_units)) for u in range(0, n_units, ri)]

    scans = []
    for comps, ss, se, ah, al in scan_script or standard_scan_script(
            len(samplings)):
        if ah and ah != al + 1:
            raise ValueError(
                f"refinement scan must step al by 1 (ah={ah}, al={al})")
        if ss == 0:
            interleaved = len(comps) > 1
            if interleaved:
                n_units, bw0 = mcus_x * mcus_y, 0
            else:
                bh, bw0 = comp_block_dims(comps[0])
                n_units = bh * bw0
            ptrs = (i32p * len(comps))(
                *[_p(states[ci], ct.c_int32) for ci in comps])
            # Columns in blocks (a row's stride is cols * 64 int32s).
            cols = np.array([states[ci].shape[1] for ci in comps], np.int64)
            ch = np.array([samplings[ci][0] for ci in comps], np.int32)
            cv = np.array([samplings[ci][1] for ci in comps], np.int32)
            bws = np.array([bw0], np.int64)
            n_blocks_total = sum(
                samplings[ci][0] * samplings[ci][1] for ci in comps
            ) * (mcus_x * mcus_y)
            cap = int(n_blocks_total * 6 + 64)
            segs = segments(n_units)
            tables = []
            cptrs = ct.cast(None, ct.POINTER(u32p))
            lptrs = ct.cast(None, ct.POINTER(u8p))
            if ah == 0:
                freqs = [np.zeros(256, np.int64) for _ in comps]
                fptrs = (i64p * len(comps))(
                    *[_p(f, ct.c_int64) for f in freqs])
                for u0, u1 in segs:
                    lib.jt_encode_prog_dc(
                        ptrs, _p(cols, ct.c_int64), len(comps),
                        _p(ch, ct.c_int32), _p(cv, ct.c_int32),
                        mcus_x, u0, u1, int(interleaved), _p(bws, ct.c_int64),
                        ah, al, 0, fptrs, cptrs, lptrs, ct.cast(None, u8p))
                tables = [build_optimal_table(f) for f in freqs]
                maps = [table_maps(t) for t in tables]
                cptrs = (u32p * len(comps))(
                    *[_p(m[0], ct.c_uint32) for m in maps])
                lptrs = (u8p * len(comps))(
                    *[_p(m[1], ct.c_uint8) for m in maps])
            chunks = []
            for u0, u1 in segs:
                out = np.zeros(cap, np.uint8)
                n = lib.jt_encode_prog_dc(
                    ptrs, _p(cols, ct.c_int64), len(comps),
                    _p(ch, ct.c_int32), _p(cv, ct.c_int32),
                    mcus_x, u0, u1, int(interleaved), _p(bws, ct.c_int64),
                    ah, al, 1, ct.cast(None, ct.POINTER(i64p)),
                    cptrs, lptrs, _p(out, ct.c_uint8))
                chunks.append(out[:n].tobytes())
            scans.append(dict(
                comps=comps, ss=ss, se=se, ah=ah, al=al,
                tables=[("dc", si, t) for si, t in enumerate(tables)],
                data=join_segments(chunks)))
        else:
            ci = comps[0]
            bh, bw = comp_block_dims(ci)
            segs = segments(bh * bw)
            freq = np.zeros(256, np.int64)
            for u0, u1 in segs:
                lib.jt_encode_prog_ac(
                    _p(states[ci], ct.c_int32), states[ci].shape[1], bw,
                    u0, u1, ss, se, ah, al, 0, _p(freq, ct.c_int64),
                    ct.cast(None, u32p), ct.cast(None, u8p),
                    ct.cast(None, u8p))
            table = build_optimal_table(freq)
            code, length = table_maps(table)
            cap = int(bh * bw * 64 * 6 + 64)
            chunks = []
            for u0, u1 in segs:
                out = np.zeros(cap, np.uint8)
                n = lib.jt_encode_prog_ac(
                    _p(states[ci], ct.c_int32), states[ci].shape[1], bw,
                    u0, u1, ss, se, ah, al, 1, ct.cast(None, i64p),
                    _p(code, ct.c_uint32), _p(length, ct.c_uint8),
                    _p(out, ct.c_uint8))
                chunks.append(out[:n].tobytes())
            scans.append(dict(comps=comps, ss=ss, se=se, ah=ah, al=al,
                              tables=[("ac", 0, table)],
                              data=join_segments(chunks)))
    return scans
