"""Host C++ entropy runtime and entropy encoder, bound with ctypes.

Binds four entry points of the JAX package's C++ decode library
(``jpeg_tpu/runtime/native/jpegtpu.cpp``) without importing ``jpeg_tpu``:

- ``jt_decode_scan``: restart-segment-parallel Huffman decode into
  ``[total_blocks, 64]`` int32 zigzag blocks (the compat decode's input);
- ``jt_decode_scan_planes``: restart-segment-parallel Huffman decode into
  per-component natural-order int16 planes (the layout K1 reads);
- ``jt_decode_scan_planes_spec``: the speculative self-synchronising decode
  of a single-segment scan, used for multi-threaded single-image decode;
- ``jt_unstuff_scan``: byte unstuffing and restart split for large scans.

and ``jt_encode_scan`` of its C++ entropy encoder
(``jpeg_tpu/runtime/native/jpegtpu_enc.cpp``): restart-segment-parallel
Huffman packing of natural-order int16 planes (the layout K2 writes).

Each library is compiled with g++ into ``jpeg_tpu_torch/build/`` at first use
(no profile-guided step: its training script imports jax). A missing
compiler or a failed build raises; there is no numpy fallback on this path.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from jpeg_tpu_torch.utils.build import GXX_FLAGS, REPO_DIR, load_library

NATIVE_DIR = os.path.join(REPO_DIR, "jpeg_tpu", "runtime", "native")
SOURCE = os.path.join(NATIVE_DIR, "jpegtpu.cpp")
ENC_SOURCE = os.path.join(NATIVE_DIR, "jpegtpu_enc.cpp")

# Output buffers reused per thread (see native_decode_planes and
# native_decode_coefficients).
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
    lib.jt_decode_scan.restype = ctypes.c_int64
    lib.jt_decode_scan.argtypes = [
        u8p, ctypes.c_int64,  # data, n_bytes
        i64p, i64p, i64p, i64p, ctypes.c_int64,  # seg arrays, n_segs
        u8p, ctypes.c_int32,  # slot_comp, blocks_per_mcu
        u8p, u8p, ctypes.c_int32,  # comp dc/ac ids, n_comp
        u16p, u16p,  # packed dc/ac LUTs
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,  # out, n_threads
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


def load() -> ctypes.CDLL:
    """Build (at first use) and load the C++ runtime."""
    return load_library("jpegtpu", ["g++", *GXX_FLAGS], [SOURCE], _configure)


def _p(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _packed_luts(tables) -> np.ndarray:
    """[4, 65536] u16 packed (value << 8) | length per table slot."""
    return np.ascontiguousarray(np.stack(
        [(t.lut_value.astype(np.uint16) << 8) | t.lut_length for t in tables]))


def _plane_args(plan):
    """Plan-derived ctypes arguments, cached on the plan (corpus workers
    call once per frame; rebuilding them serializes on the GIL)."""
    from jpeg_tpu_torch.models.decoder import PipelineGeometry
    from jpeg_tpu_torch.ops.fused_plane import padded_plane_shapes

    cached = getattr(plan, "_native_plane_args", None)
    if cached is not None:
        return cached
    segs = plan.segments
    slots = plan.component_block_slots()
    comps = plan.components
    shapes = padded_plane_shapes(PipelineGeometry.of(plan))
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


def native_decode_planes(plan, n_threads: int | None = None,
                         reuse_buffer: bool = True) -> list[np.ndarray]:
    """Threaded entropy decode into per-component natural-order int16 planes
    in the padded layout of :func:`jpeg_tpu_torch.ops.fused_plane.
    padded_plane_shapes` (pad regions zero).

    Restart-segmented scans decode segment-parallel. A single-segment scan
    of at least 64 KB with ``n_threads > 1`` decodes speculatively in
    ``4 * n_threads`` chunks (bit-identical: a broken sync link falls back
    to sequential decode inside the library).

    With ``reuse_buffer`` (default) the planes are this thread's scratch
    buffers, overwritten by its next same-geometry call: consume or copy
    them first. Raises :class:`NativeDecodeError` on an invalid prefix.
    """
    lib = load()
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    a = _plane_args(plan)
    shapes = tuple(a["shapes"])
    bufs = getattr(_tls, "planes", None)
    if bufs is None:
        bufs = _tls.planes = {}
    cached = bufs.get(shapes) if reuse_buffer else None
    fresh = cached is None
    if fresh:
        planes = [np.zeros(s, dtype=np.int16) for s in shapes]
        i16p = ctypes.POINTER(ctypes.c_int16)
        ptrs = (i16p * len(planes))(*[_p(p, ctypes.c_int16) for p in planes])
        if reuse_buffer:
            bufs[shapes] = (planes, ptrs)
    else:
        planes, ptrs = cached
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
    if len(plan.segments) == 1 and data.size >= 65536 and n_threads > 1:
        err = lib.jt_decode_scan_planes_spec(
            _p(data, ctypes.c_uint8), data.size, plan.n_mcus, *common,
            4 * n_threads, n_threads)
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
    """ctypes signature of ``jt_encode_scan``, as ``jpeg_tpu/runtime/
    __init__.py`` declares it."""
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i16p = ctypes.POINTER(ctypes.c_int16)
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
    """Build (at first use) and load the C++ entropy encoder."""
    return load_library("jpegtpu_enc", ["g++", *GXX_FLAGS], [ENC_SOURCE],
                        _configure_enc)


def native_encode_scan(planes, slots, comp_h, comp_v, mcus_x, n_mcus,
                       restart_interval, dc_code, dc_len, ac_code, ac_len,
                       comp_tid, n_threads: int | None = None) -> list[bytes]:
    """Entropy-encode quantized natural-order int16 planes -> per-restart-
    segment byte strings (each byte-aligned; caller interleaves RST markers).

    Parallel across segments. ``dc_code``/... are [2, 256] symbol tables
    (uint32 codes / uint8 lengths), ``comp_tid`` the 0/1 selector per
    component. Same contract as ``jpeg_tpu.runtime.native_encode_scan``.
    """
    lib = load_encoder()
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    planes = [np.ascontiguousarray(p, dtype=np.int16) for p in planes]
    i16p = ctypes.POINTER(ctypes.c_int16)
    ptrs = (i16p * len(planes))(*[_p(p, ctypes.c_int16) for p in planes])
    strides = np.array([p.shape[1] for p in planes], dtype=np.int64)
    slot_comp = np.array([s[0] for s in slots], dtype=np.uint8)
    slot_vi = np.array([s[1] for s in slots], dtype=np.uint8)
    slot_hi = np.array([s[2] for s in slots], dtype=np.uint8)
    bpm = len(slots)
    ri = restart_interval or n_mcus
    n_segs = -(-n_mcus // ri)
    # Worst case ~ stuffing-doubled 27 bits/coefficient.
    seg_capacity = int(ri * bpm * 64 * 8 + 64)
    for _ in range(3):
        out = np.empty(n_segs * seg_capacity, dtype=np.uint8)
        seg_bytes = np.zeros(n_segs, dtype=np.int64)
        rc = lib.jt_encode_scan(
            ptrs, _p(strides, ctypes.c_int64),
            _p(slot_comp, ctypes.c_uint8), _p(slot_vi, ctypes.c_uint8),
            _p(slot_hi, ctypes.c_uint8), bpm,
            _p(np.asarray(comp_h, np.uint8), ctypes.c_uint8),
            _p(np.asarray(comp_v, np.uint8), ctypes.c_uint8),
            len(planes), mcus_x, n_mcus, restart_interval,
            _p(np.ascontiguousarray(dc_code, np.uint32), ctypes.c_uint32),
            _p(np.ascontiguousarray(dc_len, np.uint8), ctypes.c_uint8),
            _p(np.ascontiguousarray(ac_code, np.uint32), ctypes.c_uint32),
            _p(np.ascontiguousarray(ac_len, np.uint8), ctypes.c_uint8),
            _p(np.asarray(comp_tid, np.uint8), ctypes.c_uint8),
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
