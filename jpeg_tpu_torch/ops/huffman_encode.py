"""The encoder's Huffman pack on the card: quantized int16 coefficient planes
-> the entropy-coded bytes of one baseline scan, RST markers included.

The JAX package packs on the host (``runtime.native_encode_scan``), so this
replaces no TPU kernel; it is the encoder's counterpart of K3. The CUDA
kernels are ``csrc/huffman_encode.cu``; :func:`huffman_encode_plain` is
their plain PyTorch twin, computing the same four phases vectorised:

1. count: each block's bits (DC difference, AC run/size symbols, ZRLs,
   EOB), read in zigzag order from the planes;
2. offsets: every block's bit position in the concatenation of the
   restart segments, each padded to a byte;
3. emit: the codes MSB-first at those positions, and each segment's
   padding with 1-bits;
4. stuff and join: a 0x00 after every 0xFF byte and RST0-7 markers
   between segments.

Both give the bytes of ``runtime.join_segments(runtime.native_encode_scan(
...))`` for the same planes and tables (a symbol without a code writes no
code bits there too). Planes are one image's, per component a 2-D int16
tensor in natural order with the block at ``[by * 8, bx * 8]``, as K2
leaves them (:func:`jpeg_tpu_torch.ops.fused_plane.padded_plane_shapes`);
``tables`` is :func:`pack_tables`' ``[2, 2, 256]`` int32 tensor, on the
planes' device for the kernels.
:func:`huffman_encode` takes the plain version only for tensors on the CPU.
For CUDA tensors it launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from jpeg_tpu_torch.ops.zigzag import ZIGZAG_INDICES
from jpeg_tpu_torch.utils.build import LaunchCounter, load_cuda_kernel

LAUNCHES = LaunchCounter()  # one a packed scan (six kernels)

MAX_COMP = 4
MAX_SLOTS = 32
# Bytes a block can take before stuffing: a 32-bit DC, 63 AC symbols of at
# most 16 + 16 bits, a segment's padding.
MAX_BLOCK_BYTES = 260
BLOCK_THREADS = 128  # the kernels' blocks a thread block (count, emit)
BYTE_TILE = 4096     # bytes a thread block of the byte passes
FF_GRID = 132 * 8    # thread blocks of the byte passes, at most
CHUNK = 8192         # blocks the plain version takes at a time


def mcu_slots(sampling) -> list[tuple[int, int, int]]:
    """MCU slot order: (component, vi, hi), vi-major (JPEG A.2.3)."""
    out = []
    for ci, (h, v) in enumerate(sampling):
        for vi in range(v):
            for hi in range(h):
                out.append((ci, vi, hi))
    return out


def pack_tables(dc_maps, ac_maps) -> torch.Tensor:
    """[2 table ids][DC, AC][256] int32 ``(length << 16) | code`` (the
    kernels read it as uint32) from the encoder's (code, length) maps, luma
    first (gray: its one table in both ids, as the C++ packer takes it)."""
    if len(dc_maps) == 1:
        dc_maps, ac_maps = dc_maps * 2, ac_maps * 2
    out = np.zeros((2, 2, 256), np.uint32)
    for t in range(2):
        for k, (code, length) in enumerate((dc_maps[t], ac_maps[t])):
            out[t, k] = (np.asarray(length, np.uint32) << 16) | (
                np.asarray(code, np.uint32) & 0xFFFF)
    return torch.from_numpy(out.view(np.int32))


def _check(planes, geom, restart_interval_mcus, tables) -> None:
    sampling = geom.sampling
    if len(planes) != len(sampling) or not 1 <= len(sampling) <= MAX_COMP:
        raise ValueError(f"{len(sampling)} components need as many planes "
                         f"(1 to {MAX_COMP}), got {len(planes)}")
    if sum(h * v for h, v in sampling) > MAX_SLOTS:
        raise ValueError(f"at most {MAX_SLOTS} blocks an MCU, got {sampling}")
    for p, (h, v) in zip(planes, sampling):
        if (p.dtype != torch.int16 or p.dim() != 2
                or p.shape[0] < geom.mcus_y * v * 8
                or p.shape[1] < geom.mcus_x * h * 8):
            raise ValueError(
                f"a plane must be int16 [>= {geom.mcus_y * v * 8}, >= "
                f"{geom.mcus_x * h * 8}], got {p.dtype} {tuple(p.shape)}")
    if restart_interval_mcus < 0:
        raise ValueError(f"restart interval {restart_interval_mcus} < 0")
    if tables.shape != (2, 2, 256) or tables.dtype != torch.int32:
        raise ValueError(f"tables must be int32 [2, 2, 256], got "
                         f"{tables.dtype} {tuple(tables.shape)}")


def _layout(geom, restart_interval_mcus: int) -> dict:
    """Per block of the scan, in scan order: component, block row and
    column in its plane, the block whose DC it predicts from (-1: none),
    its segment, and whether it is its segment's first or last block."""
    slots = mcu_slots(geom.sampling)
    bpm, n_comp = len(slots), len(geom.sampling)
    n_mcus = geom.mcus_x * geom.mcus_y
    ri = restart_interval_mcus or n_mcus
    sc, sv, sh = (torch.tensor([s[k] for s in slots]) for k in range(3))
    first = torch.tensor([min(i for i, s in enumerate(slots) if s[0] == c)
                          for c in range(n_comp)])
    last = torch.tensor([max(i for i, s in enumerate(slots) if s[0] == c)
                         for c in range(n_comp)])
    h = torch.tensor([h for h, _ in geom.sampling])
    v = torch.tensor([v for _, v in geom.sampling])
    b = torch.arange(n_mcus * bpm)
    mcu, slot = b // bpm, b % bpm
    comp, in_seg = sc[slot], mcu % ri
    prev = torch.where(slot != first[comp], b - 1,
                       torch.where(in_seg != 0, (mcu - 1) * bpm + last[comp], -1))
    return dict(
        comp=comp, prev=prev, seg=mcu // ri, ri=ri, bpm=bpm,
        n_segs=-(-n_mcus // ri),
        by=(mcu // geom.mcus_x) * v[comp] + sv[slot],
        bx=(mcu % geom.mcus_x) * h[comp] + sh[slot],
        last=(slot == bpm - 1) & ((in_seg == ri - 1) | (mcu == n_mcus - 1)))


_ZZ_ROW = torch.from_numpy(ZIGZAG_INDICES // 8).long()
_ZZ_COL = torch.from_numpy(ZIGZAG_INDICES % 8).long()


def _blocks(planes, lay, lo: int, hi: int) -> torch.Tensor:
    """[hi - lo, 64] int64: the coefficients of scan blocks lo..hi-1 in
    zigzag order."""
    comp = lay["comp"][lo:hi]
    by, bx = lay["by"][lo:hi, None], lay["bx"][lo:hi, None]
    z = torch.empty((hi - lo, 64), dtype=torch.int64)
    for c, p in enumerate(planes):
        m = comp == c
        if m.any():
            z[m] = p[by[m] * 8 + _ZZ_ROW, bx[m] * 8 + _ZZ_COL].long()
    return z


def _dc(planes, lay, idx: torch.Tensor) -> torch.Tensor:
    """Coefficient 0 of scan blocks ``idx`` (0 where ``idx`` is -1)."""
    out = torch.zeros(idx.shape, dtype=torch.int64)
    comp = torch.where(idx >= 0, lay["comp"][idx.clamp(min=0)], -1)
    for c, p in enumerate(planes):
        m = comp == c
        out[m] = p[lay["by"][idx[m]] * 8, lay["bx"][idx[m]] * 8].long()
    return out


def _size(v: torch.Tensor) -> torch.Tensor:
    """Bit size of |v| (0 -> 0); exact for |v| < 2 ** 24."""
    return torch.frexp(v.abs().float()).exponent.long()


def _low_bits(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.where(v < 0, v + (1 << s) - 1, v)


def _symbols(planes, lay, tab, lo: int, hi: int) -> dict:
    """Blocks lo..hi-1: each one's bits and the codes that make them."""
    z = _blocks(planes, lay, lo, hi)
    tid = lay["comp"][lo:hi].clamp(max=1)
    diff = z[:, 0] - _dc(planes, lay, lay["prev"][lo:hi])
    s_dc = _size(diff)
    e = tab[tid, 0, s_dc]
    dc_len = (e >> 16) + s_dc
    dc_val = ((e & 0xFFFF) << s_dc) | _low_bits(diff, s_dc)
    ac = z[:, 1:]
    nz = ac != 0
    pos = torch.arange(1, 64).expand_as(ac)
    seen = torch.cummax(torch.where(nz, pos, 0), dim=1).values
    run = pos - torch.cat([torch.zeros_like(seen[:, :1]), seen[:, :-1]], 1) - 1
    zrl = torch.where(nz, run >> 4, 0)
    s = _size(ac)
    e = tab[tid[:, None], 1, ((run & 15) << 4) | s]
    zrl_len = (tab[tid, 1, 0xF0] >> 16)[:, None]
    sym_len = torch.where(nz, (e >> 16) + s, 0)
    sym_val = ((e & 0xFFFF) << s) | _low_bits(ac, s)
    group = zrl * zrl_len + sym_len
    eob_e = tab[tid, 1, 0x00]
    eob_len = torch.where(ac[:, 62] == 0, eob_e >> 16, 0)
    return dict(bits=dc_len + group.sum(1) + eob_len, dc_len=dc_len,
                dc_val=dc_val, group=group, zrl=zrl, zrl_len=zrl_len,
                zrl_code=(tab[tid, 1, 0xF0] & 0xFFFF)[:, None],
                sym_len=sym_len, sym_val=sym_val, eob_len=eob_len,
                eob_code=eob_e & 0xFFFF)


def _put(words: torch.Tensor, off, val, length) -> None:
    """OR codes ``val`` of ``length`` bits (<= 32) at bit ``off`` into
    big-endian 32-bit ``words`` (int64). The bits of codes never overlap, so
    a sum is the OR."""
    keep = length > 0
    off, val, length = off[keep], val[keep], length[keep]
    w, end = off >> 5, (off & 31) + length
    one = end <= 32
    words.index_add_(0, w[one], val[one] << (32 - end[one]))
    two = ~one
    spill = end[two] - 32
    words.index_add_(0, w[two], val[two] >> spill)
    words.index_add_(0, w[two] + 1, (val[two] & ((1 << spill) - 1)) << (32 - spill))


def huffman_encode_plain(planes, geom, restart_interval_mcus: int,
                         tables: torch.Tensor) -> bytes:
    """Plain PyTorch twin of the kernels: the scan's bytes, RST markers
    between segments, on the CPU."""
    _check(planes, geom, restart_interval_mcus, tables)
    lay = _layout(geom, restart_interval_mcus)
    tab = tables.cpu().long()
    n = lay["comp"].numel()
    # 1. count
    bits = torch.cat([_symbols(planes, lay, tab, lo, min(lo + CHUNK, n))["bits"]
                      for lo in range(0, n, CHUNK)])
    # 2. offsets: segments are runs of ri * bpm blocks, each byte-aligned
    cum = torch.cumsum(bits, 0) - bits
    firsts = torch.arange(lay["n_segs"]) * (lay["ri"] * lay["bpm"])
    ends = torch.cat([firsts[1:], torch.tensor([n])])
    seg_bytes = (cum[ends - 1] + bits[ends - 1] - cum[firsts] + 7) // 8
    seg_start = torch.cumsum(seg_bytes, 0) - seg_bytes
    seg = lay["seg"]
    at = 8 * seg_start[seg] + cum - cum[firsts[seg]]
    n_bytes = int(seg_bytes.sum())
    # 3. emit
    words = torch.zeros(n_bytes // 4 + 2, dtype=torch.int64)
    for lo in range(0, n, CHUNK):
        hi = min(lo + CHUNK, n)
        sym, e = _symbols(planes, lay, tab, lo, hi), at[lo:hi]
        _put(words, e, sym["dc_val"], sym["dc_len"])
        group = e[:, None] + sym["dc_len"][:, None] + torch.cumsum(
            sym["group"], 1) - sym["group"]
        for i in range(3):  # ZRLs: at most three before a coefficient
            zl = torch.where(sym["zrl"] > i, sym["zrl_len"], 0)
            _put(words, group + i * sym["zrl_len"],
                 sym["zrl_code"].expand_as(group), zl)
        _put(words, group + sym["zrl"] * sym["zrl_len"], sym["sym_val"],
             sym["sym_len"])
        end = e + sym["bits"]
        _put(words, end - sym["eob_len"], sym["eob_code"], sym["eob_len"])
        pad = torch.where(lay["last"][lo:hi], (8 - end % 8) % 8, 0)
        _put(words, end, (1 << pad) - 1, pad)
    # 4. stuff and join
    u = torch.stack([(words >> k) & 0xFF for k in (24, 16, 8, 0)], 1)
    u = u.reshape(-1)[:n_bytes]
    ff = (u == 0xFF).long()
    ff_before = torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(ff, 0)])
    j = torch.arange(n_bytes)
    later = seg_start[1:]
    out = torch.zeros(n_bytes + int(ff.sum()) + 2 * later.numel(),
                      dtype=torch.uint8)
    out[j + ff_before[:-1] + 2 * torch.searchsorted(later, j, right=True)] = (
        u.to(torch.uint8))
    s = torch.arange(1, lay["n_segs"])
    p = later + ff_before[later] + 2 * (s - 1)
    out[p] = 0xFF
    out[p + 1] = (0xD0 + (s - 1) % 8).to(torch.uint8)
    return out.numpy().tobytes()


def _configure(lib) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    i32p, u8p = ctypes.POINTER(i32), ctypes.POINTER(ctypes.c_uint8)
    lib.jt_huffman_encode.restype = ctypes.c_int
    lib.jt_huffman_encode.argtypes = [
        ctypes.POINTER(vp), ctypes.POINTER(i64), i32,  # planes, strides, n_comp
        i32p, i32p, i32p,  # comp_h, comp_v, comp_tid
        u8p, u8p, u8p, i32,  # slot_comp, slot_vi, slot_hi, bpm
        i32, i64, i64,  # mcus_x, n_mcus, restart interval
        vp, vp, vp, vp, vp,  # tables, bits, tile_agg, tile_start, seg_start
        vp, vp, vp, i32,  # scan, ff_tile, ff_start, ff_grid
        vp, vp, vp,  # out, meta, stream
    ]


def load_kernel():
    """Build (at first use) and load the pack's library."""
    return load_cuda_kernel("huffman_encode", (), _configure)


class _Scratch:
    """A card's device buffers, reused call after call and remade larger
    only when a call needs more blocks or segments than they hold: every
    buffer is sized by those two counts alone, and the kernels take the
    call's own counts, so one scratch serves every geometry. ``scan`` (the
    unstuffed words) is all zero between calls: the scatter kernel zeroes
    what it read."""

    def __init__(self, n_blocks: int, n_segs: int, device):
        i64 = dict(dtype=torch.int64, device=device)
        self.n_blocks, self.n_segs = n_blocks, n_segs
        n_tiles = -(-n_blocks // BLOCK_THREADS)
        scan_bytes = _scan_tiles(n_blocks) * BYTE_TILE
        self.bits = torch.empty(n_blocks, dtype=torch.int32, device=device)
        self.tile_agg = torch.empty((n_tiles, 3), **i64)
        self.tile_start = torch.empty(n_tiles, **i64)
        self.seg_start = torch.empty(n_segs, **i64)
        self.scan = torch.zeros(scan_bytes, dtype=torch.uint8, device=device)
        self.ff_tile = torch.empty((scan_bytes // BYTE_TILE, 3), **i64)
        self.ff_start = torch.empty(scan_bytes // BYTE_TILE, **i64)
        self.out = torch.empty(2 * scan_bytes + 2 * n_segs, dtype=torch.uint8,
                               device=device)
        self.meta = torch.empty(2, **i64)
        self.meta_host = torch.empty(2, dtype=torch.int64, pin_memory=True)
        self.host = torch.empty(0, dtype=torch.uint8)

    def host_buffer(self, n: int) -> torch.Tensor:
        """The first ``n`` bytes of a reused page-locked buffer."""
        if self.host.numel() < n:
            self.host = torch.empty(max(n, 2 * self.host.numel()),
                                    dtype=torch.uint8, pin_memory=True)
        return self.host[:n]


def _scan_tiles(n_blocks: int) -> int:
    """Byte tiles of the largest unstuffed scan ``n_blocks`` blocks make."""
    return -(-n_blocks * MAX_BLOCK_BYTES // BYTE_TILE)


_scratch: dict = {}  # device -> _Scratch
_lock = threading.RLock()  # one pack at a time: the scratch is shared


def _c_array(ctype, values):
    return (ctype * len(values))(*values)


def enqueue(planes, geom, restart_interval_mcus: int,
            tables: torch.Tensor) -> _Scratch:
    """Launch the six kernels on the current stream and return the scratch
    whose ``out[:meta[1]]`` will hold the scan. Every plane contiguous, on
    one CUDA device, 16-byte aligned, with rows of a multiple of 8 elements
    (K2's planes are); ``tables`` on that device too."""
    _check(planes, geom, restart_interval_mcus, tables)
    dev = planes[0].device
    for p in planes:
        if (p.device != dev or not p.is_contiguous() or p.data_ptr() % 16
                or p.shape[1] % 8):
            raise ValueError("planes must be contiguous, on one device, "
                             "16-byte aligned, rows a multiple of 8")
    if tables.device != dev or not tables.is_contiguous():
        raise ValueError(f"tables must be contiguous on {dev}, got "
                         f"{tables.device}")
    lib = load_kernel()
    slots = mcu_slots(geom.sampling)
    n_comp, bpm = len(planes), len(slots)
    n_mcus = geom.mcus_x * geom.mcus_y
    n_blocks = n_mcus * bpm
    n_segs = -(-n_mcus // (restart_interval_mcus or n_mcus))
    u8, i32 = ctypes.c_uint8, ctypes.c_int32
    with _lock:
        sc = _scratch.get(dev)
        if sc is None or sc.n_blocks < n_blocks or sc.n_segs < n_segs:
            size = (max(n_blocks, getattr(sc, "n_blocks", 0)),
                    max(n_segs, getattr(sc, "n_segs", 0)))
            sc = _scratch[dev] = None  # the old buffers go first
            sc = _scratch[dev] = _Scratch(*size, dev)
        rc = lib.jt_huffman_encode(
            _c_array(ctypes.c_void_p, [p.data_ptr() for p in planes]),
            _c_array(ctypes.c_int64, [p.shape[1] for p in planes]), n_comp,
            _c_array(i32, [h for h, _ in geom.sampling]),
            _c_array(i32, [v for _, v in geom.sampling]),
            _c_array(i32, [min(c, 1) for c in range(n_comp)]),
            *(_c_array(u8, [s[k] for s in slots]) for k in range(3)), bpm,
            geom.mcus_x, n_mcus, restart_interval_mcus, tables.data_ptr(),
            sc.bits.data_ptr(), sc.tile_agg.data_ptr(),
            sc.tile_start.data_ptr(), sc.seg_start.data_ptr(),
            sc.scan.data_ptr(), sc.ff_tile.data_ptr(), sc.ff_start.data_ptr(),
            min(_scan_tiles(n_blocks), FF_GRID), sc.out.data_ptr(),
            sc.meta.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            _scratch.pop(dev)  # its words may not be zero any more
            raise RuntimeError(f"Huffman pack launch failed: CUDA error {rc}")
        LAUNCHES.add()
        return sc


def huffman_encode_cuda(planes, geom, restart_interval_mcus: int,
                        tables: torch.Tensor) -> bytes:
    """:func:`enqueue`, then read the scan's length and copy that many
    bytes into a reused page-locked buffer. Same contract as
    :func:`huffman_encode_plain`."""
    stream = torch.cuda.current_stream(planes[0].device)
    with _lock:
        sc = enqueue(planes, geom, restart_interval_mcus, tables)
        try:
            sc.meta_host.copy_(sc.meta, non_blocking=True)
            stream.synchronize()
            host = sc.host_buffer(int(sc.meta_host[1]))
            host.copy_(sc.out[: host.numel()], non_blocking=True)
            stream.synchronize()
            return host.numpy().tobytes()
        except BaseException:
            _scratch.pop(planes[0].device, None)  # a fault: start afresh
            raise


def huffman_encode(planes, geom, restart_interval_mcus: int,
                   tables: torch.Tensor) -> bytes:
    """The pack: the plain version for CPU tensors, the kernels for CUDA
    tensors (no fallback between them)."""
    dev = planes[0].device
    if dev.type == "cpu":
        return huffman_encode_plain(planes, geom, restart_interval_mcus, tables)
    if dev.type == "cuda":
        return huffman_encode_cuda(planes, geom, restart_interval_mcus, tables)
    raise ValueError(f"the Huffman pack runs on cpu or cuda, not {dev}")
