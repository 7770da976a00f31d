"""JPEG encoder: RGB or gray samples -> JFIF bytes.

Counterpart of ``jpeg_tpu/models/encoder.py``, byte-identical to it: 8- and
12-bit sequential streams, Huffman (SOF0 / SOF1) or arithmetic coded (SOF9),
progressive streams (SOF2 / SOF10) and Adobe CMYK / YCCK. Two routes, as in
the JAX package:

- :func:`encode_rgb`, :func:`encode_rgb_progressive` and
  :func:`encode_cmyk`: the forward transform in NumPy on the host (a copy of
  the JAX package's), then the C++ entropy encoder (``engine="native"``:
  Huffman, arithmetic and the progressive scans) or the pure-Python one
  (``engine="python"``; ``entropy/arith.py`` for arithmetic coding, which
  SOF10 streams and arithmetic CMYK always take, as in the JAX package);
- :func:`encode_rgb_device`: the forward transform as K2
  (``ops/fused_encode.py``) on ``device``, the planes copied to the host
  once, then the C++ entropy encoder. K2 multiplies by a reciprocal table
  where the host route divides, so the two routes are not byte-identical
  (quantisation ties); they decode within the repo's 45 dB bar.

A failed build or load of the C++ encoder raises; nothing drops to the
Python packer behind the caller's back, where the JAX package falls back on
``ImportError`` / ``OSError``.
"""

from __future__ import annotations

import numpy as np

from jpeg_tpu_torch.entropy import annex_k
from jpeg_tpu_torch.entropy.tables import HuffmanTable
from jpeg_tpu_torch.models.decoder import PipelineGeometry
from jpeg_tpu_torch.ops.idct import forward_dct_matrix
from jpeg_tpu_torch.ops.zigzag import ZIGZAG_INDICES, unzigzag, zigzag
from jpeg_tpu_torch.runtime import (
    join_segments,
    native_encode_arith_scan,
    native_encode_progressive_scans,
    native_encode_scan,
)


def _build_encode_maps(table: HuffmanTable):
    """symbol -> (code, length) arrays for fast lookup."""
    code = np.zeros(256, dtype=np.uint32)
    length = np.zeros(256, dtype=np.uint8)
    code[table.values] = table.codes.astype(np.uint32)
    length[table.values] = table.lengths
    return code, length


class BitWriter:
    """MSB-first bit packer with 0xFF00 byte stuffing (JPEG B.1.1.5)."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def put(self, code: int, length: int) -> None:
        if length == 0:
            return
        self.acc = (self.acc << length) | (code & ((1 << length) - 1))
        self.nbits += length
        while self.nbits >= 8:
            self.nbits -= 8
            byte = (self.acc >> self.nbits) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0x00)
        self.acc &= (1 << self.nbits) - 1

    def flush(self) -> None:
        """Pad the final partial byte with 1-bits (spec F.1.2.3)."""
        if self.nbits:
            pad = 8 - self.nbits
            self.put((1 << pad) - 1, pad)


def _magnitude(v: np.ndarray) -> np.ndarray:
    """Bit size of |v| (0 -> 0)."""
    out = np.zeros(v.shape, dtype=np.int32)
    a = np.abs(v)
    nz = a > 0
    out[nz] = np.floor(np.log2(a[nz])).astype(np.int32) + 1
    return out


def _encode_block(writer: BitWriter, coeffs_zz: np.ndarray, dc_delta: int,
                  dc_maps, ac_maps) -> None:
    dc_code, dc_len = dc_maps
    ac_code, ac_len = ac_maps
    size = int(_magnitude(np.array([dc_delta]))[0])
    writer.put(int(dc_code[size]), int(dc_len[size]))
    if size:
        v = dc_delta if dc_delta >= 0 else dc_delta + (1 << size) - 1
        writer.put(v, size)
    ac = coeffs_zz[1:]
    nz = np.flatnonzero(ac)
    pos = 0
    for idx in nz.tolist():
        run = idx - pos
        while run >= 16:
            writer.put(int(ac_code[0xF0]), int(ac_len[0xF0]))  # ZRL
            run -= 16
        v = int(ac[idx])
        size = int(_magnitude(np.array([v]))[0])
        sym = (run << 4) | size
        writer.put(int(ac_code[sym]), int(ac_len[sym]))
        writer.put(v if v >= 0 else v + (1 << size) - 1, size)
        pos = idx + 1
    if pos < 63:
        writer.put(int(ac_code[0x00]), int(ac_len[0x00]))  # EOB


def _pad_to(x: np.ndarray, rows: int, cols: int) -> np.ndarray:
    return np.pad(x, ((0, rows - x.shape[0]), (0, cols - x.shape[1])), mode="edge")


def _plane_to_blocks(plane: np.ndarray) -> np.ndarray:
    """[R*8, C*8] -> [R*C, 64] natural-order blocks, row-major block order."""
    r, c = plane.shape[0] // 8, plane.shape[1] // 8
    return plane.reshape(r, 8, c, 8).transpose(0, 2, 1, 3).reshape(r * c, 64)


def _validate_image(rgb: np.ndarray, grayscale: bool) -> None:
    """Reject shapes the pipeline would mangle (e.g. empty images divide by
    zero in the MCU math); coercions like float dtypes stay permitted."""
    if rgb.ndim not in (2, 3) or rgb.shape[0] < 1 or rgb.shape[1] < 1 or (
            rgb.ndim == 3 and rgb.shape[2] < 3 and not grayscale):
        raise ValueError(
            "expected [H, W, 3] RGB or [H, W] grayscale with H, W >= 1, "
            f"got shape {rgb.shape}")


def _quant_tables(quality: int, grayscale: bool) -> list[np.ndarray]:
    """Zigzag-order quant tables, luma first (one per DQT slot)."""
    q_luma = annex_k.scaled_quant_table(annex_k.QUANT_LUMA, quality)
    q_chroma = annex_k.scaled_quant_table(annex_k.QUANT_CHROMA, quality)
    return [q_luma] + ([] if grayscale else [q_chroma])


def _forward_transform(rgb, quality, subsampling, grayscale,
                       precision: int = 8):
    """RGB/gray -> per-component quantized zigzag blocks + geometry (NumPy
    on the host, as in the JAX package). ``precision=12`` takes u16 samples
    in [0, 4095] and shifts by 2048."""
    rgb = np.asarray(rgb)
    _validate_image(rgb, grayscale)
    if rgb.ndim == 2:
        grayscale = True
    h_s, v_s = (1, 1) if grayscale else subsampling
    shift = np.float32(1 << (precision - 1))

    if grayscale:
        planes = [rgb.astype(np.float32) - shift]
        samplings = [(1, 1)]
    else:
        # One [N, 3] @ [3, 3] GEMM instead of nine vector passes over
        # three float temps (threaded BLAS; ~2x on a 4K frame).
        m = np.array(
            [[0.299, 0.587, 0.114],
             [-0.168735892, -0.331264108, 0.5],
             [0.5, -0.418687589, -0.081312411]], np.float32)
        ycc = rgb[..., :3].astype(np.float32).reshape(-1, 3) @ m.T
        ycc = ycc.reshape(rgb.shape[0], rgb.shape[1], 3)
        planes = [np.ascontiguousarray(ycc[..., 0]) - shift,
                  np.ascontiguousarray(ycc[..., 1]),
                  np.ascontiguousarray(ycc[..., 2])]
        samplings = [(h_s, v_s), (1, 1), (1, 1)]

    height, width = planes[0].shape
    h_max = max(s[0] for s in samplings)
    v_max = max(s[1] for s in samplings)
    mcus_x = -(-width // (8 * h_max))
    mcus_y = -(-height // (8 * v_max))
    quant_zz = _quant_tables(quality, grayscale)

    # Zigzag folded into the DCT matrix (exact: a column permutation of
    # the GEMM result), so no separate [N, 64] gather pass.
    fwd_zz = np.ascontiguousarray(forward_dct_matrix()[:, ZIGZAG_INDICES])
    comp_blocks_zz = []  # per component: [rows, cols, 64] quantized zigzag
    for ci, (plane, (h, v)) in enumerate(zip(planes, samplings)):
        if (h, v) != (h_max, v_max):
            fy, fx = v_max // v, h_max // h
            hh = -(-plane.shape[0] // fy) * fy
            ww = -(-plane.shape[1] // fx) * fx
            plane = _pad_to(plane, hh, ww)
            # Strided adds beat ndarray.mean's reduction machinery ~2x.
            acc = np.zeros((hh // fy, ww // fx), np.float32)
            for dy in range(fy):
                for dx in range(fx):
                    acc += plane[dy::fy, dx::fx]
            plane = acc * np.float32(1.0 / (fy * fx))
        rows, cols = mcus_y * v, mcus_x * h
        plane = _pad_to(plane, rows * 8, cols * 8)
        blocks = _plane_to_blocks(plane)  # [rows*cols, 64]
        coeffs_zz = blocks @ fwd_zz  # forward DCT, zigzag order out
        q = quant_zz[min(ci, len(quant_zz) - 1)].astype(np.float32)
        zz = np.round(coeffs_zz / q).astype(np.int32)
        comp_blocks_zz.append(zz.reshape(rows, cols, 64))

    return (comp_blocks_zz, samplings, quant_zz, height, width,
            mcus_x, mcus_y, grayscale)


def _huffman_tables(grayscale: bool, optimize: bool, comp_blocks_zz=None,
                    samplings=None, restart_interval_mcus=0,
                    mcus_x=0, mcus_y=0):
    """Encode-side table selection: Annex K typical tables, or per-image
    optimal tables (Annex K.2) when ``optimize`` and statistics inputs are
    given. Returns (dc_tables, ac_tables), luma first."""
    if optimize:
        from jpeg_tpu_torch.entropy.optimize import (
            build_optimal_table,
            symbol_histograms,
        )

        dc_freq, ac_freq = symbol_histograms(
            comp_blocks_zz, samplings, restart_interval_mcus, mcus_x, mcus_y)
        n_tab = 1 if grayscale else 2
        return ([build_optimal_table(dc_freq[t]) for t in range(n_tab)],
                [build_optimal_table(ac_freq[t]) for t in range(n_tab)])
    dc_t = [HuffmanTable.from_bits_values(
        annex_k.DC_LUMA_BITS, annex_k.DC_LUMA_VALS)]
    ac_t = [HuffmanTable.from_bits_values(
        annex_k.AC_LUMA_BITS, annex_k.AC_LUMA_VALS)]
    if not grayscale:
        dc_t.append(HuffmanTable.from_bits_values(
            annex_k.DC_CHROMA_BITS, annex_k.DC_CHROMA_VALS))
        ac_t.append(HuffmanTable.from_bits_values(
            annex_k.AC_CHROMA_BITS, annex_k.AC_CHROMA_VALS))
    return dc_t, ac_t


def _slots(samplings):
    """MCU slot order: (component, vi, hi), vi-major (JPEG A.2.3)."""
    out = []
    for ci, (h, v) in enumerate(samplings):
        for vi in range(v):
            for hi in range(h):
                out.append((ci, vi, hi))
    return out


def _entropy_python(comp_blocks_zz, samplings, dc_maps, ac_maps,
                    mcus_x, mcus_y, restart_interval_mcus):
    scan = bytearray()
    writer = BitWriter()
    prev_dc = [0] * len(samplings)
    n_mcus = mcus_x * mcus_y
    rst = 0
    for mi in range(n_mcus):
        if restart_interval_mcus and mi > 0 and mi % restart_interval_mcus == 0:
            writer.flush()
            scan += writer.out
            scan += bytes([0xFF, 0xD0 + rst])
            rst = (rst + 1) % 8
            writer = BitWriter()
            prev_dc = [0] * len(samplings)
        my, mx = divmod(mi, mcus_x)
        for ci, vi, hi in _slots(samplings):
            h, v = samplings[ci]
            ti = min(ci, 1)
            blk = comp_blocks_zz[ci][my * v + vi, mx * h + hi]
            delta = int(blk[0]) - prev_dc[ci]
            prev_dc[ci] = int(blk[0])
            _encode_block(writer, blk, delta, dc_maps[ti], ac_maps[ti])
    writer.flush()
    scan += writer.out
    return bytes(scan)


def _native_scan(planes, samplings, dc_maps, ac_maps, mcus_x, mcus_y,
                 restart_interval_mcus) -> bytes:
    """C++ pack of natural-order int16 planes (padded or not) -> the scan
    with RST markers interleaved."""
    def _pack(maps):
        if len(maps) == 1:
            maps = maps * 2  # grayscale: duplicate luma into slot 1
        return np.stack([m[0] for m in maps]), np.stack([m[1] for m in maps])

    dc_code, dc_len = _pack(dc_maps)
    ac_code, ac_len = _pack(ac_maps)
    segs = native_encode_scan(
        planes, _slots(samplings),
        [h for h, _ in samplings], [v for _, v in samplings],
        mcus_x, mcus_x * mcus_y, restart_interval_mcus,
        dc_code, dc_len, ac_code, ac_len,
        [min(ci, 1) for ci in range(len(samplings))],
    )
    return join_segments(segs)


def _entropy_native(comp_blocks_zz, samplings, dc_maps, ac_maps,
                    mcus_x, mcus_y, restart_interval_mcus):
    return _native_scan(_natural_planes(comp_blocks_zz), samplings, dc_maps,
                        ac_maps, mcus_x, mcus_y, restart_interval_mcus)


def device_inputs(rgb: np.ndarray, quality: int = 85,
                  subsampling: tuple[int, int] = (2, 2),
                  grayscale: bool = False):
    """What :func:`encode_rgb_device` hands K2 for one image, prepared on
    the host: (geometry, edge-padded planar u8 [n_comp, H_pad, W_pad],
    natural-order reciprocal quant tables f32 [n_comp, 64], the zigzag
    quant tables of the stream's DQT segments)."""
    from jpeg_tpu_torch.ops.fused_encode import plan_inv_quant_tables
    from jpeg_tpu_torch.ops.fused_plane import padded_size

    rgb = np.asarray(rgb)
    _validate_image(rgb, grayscale)
    if rgb.ndim == 2:
        grayscale = True
    height, width = rgb.shape[:2]
    samplings = ((1, 1),) if grayscale else (tuple(subsampling), (1, 1), (1, 1))
    h_max = max(s[0] for s in samplings)
    v_max = max(s[1] for s in samplings)
    geom = PipelineGeometry(
        width=width, height=height,
        mcus_x=-(-width // (8 * h_max)), mcus_y=-(-height // (8 * v_max)),
        h_max=h_max, v_max=v_max, sampling=samplings,
        color_model="gray" if grayscale else "ycbcr")
    # Component 0 (luma) is at full Y resolution: its padded plane shape is
    # exactly the planar input shape K2 expects.
    rows_pad, w_pad = padded_size(geom)
    chans = rgb[None] if grayscale else rgb.transpose(2, 0, 1)
    planar = np.pad(chans, ((0, 0), (0, rows_pad - geom.height),
                            (0, w_pad - geom.width)), mode="edge")
    quant_zz = _quant_tables(quality, grayscale)
    iq = plan_inv_quant_tables([quant_zz[min(ci, len(quant_zz) - 1)]
                                for ci in range(len(geom.sampling))])
    return geom, planar, iq, quant_zz


def pack_planes(planes, geom, quant_zz, restart_interval_mcus: int = 0,
                optimize: bool = False) -> bytes:
    """K2's int16 planes of one image (host numpy, padded layout) -> JFIF
    bytes through the C++ entropy encoder."""
    samplings = list(geom.sampling)
    grayscale = len(samplings) == 1
    mcus_x, mcus_y = geom.mcus_x, geom.mcus_y
    comp_blocks_zz = None
    if optimize:
        # Statistics from the device-produced planes: block-ify + zigzag.
        comp_blocks_zz = []
        for p, (h, v) in zip(planes, samplings):
            rows, cols = mcus_y * v, mcus_x * h
            crop = p[: rows * 8, : cols * 8]
            nat = crop.reshape(rows, 8, cols, 8).transpose(0, 2, 1, 3)
            comp_blocks_zz.append(
                zigzag(nat.reshape(rows, cols, 64).astype(np.int32)))
    dc_t, ac_t = _huffman_tables(grayscale, optimize, comp_blocks_zz,
                                 samplings, restart_interval_mcus,
                                 mcus_x, mcus_y)
    scan = _native_scan(planes, samplings,
                        [_build_encode_maps(t) for t in dc_t],
                        [_build_encode_maps(t) for t in ac_t],
                        mcus_x, mcus_y, restart_interval_mcus)
    return _container(scan, samplings, quant_zz, dc_t, ac_t, geom.height,
                      geom.width, restart_interval_mcus)


def encode_rgb_device(rgb: np.ndarray, quality: int = 85,
                      subsampling: tuple[int, int] = (2, 2),
                      restart_interval_mcus: int = 0,
                      grayscale: bool = False,
                      optimize: bool = False,
                      device="cuda") -> bytes:
    """Encode with the forward transform on ``device``.

    The dense half (colour convert, chroma box downsample, forward DCT,
    quantisation) runs as K2 (:func:`jpeg_tpu_torch.ops.fused_encode.
    fused_plane_encode`): the kernel on a CUDA device, its plain PyTorch
    twin on the CPU. Its quantized int16 planes come back to the host once
    and the C++ entropy encoder packs them in parallel. Not byte-identical
    to :func:`encode_rgb` (K2 multiplies by a reciprocal table where the
    host route divides); equivalent quality.
    """
    from jpeg_tpu_torch.parallel.batch import encode_batch_device

    geom, planar, iq, quant_zz = device_inputs(rgb, quality, subsampling,
                                               grayscale)
    planes = encode_batch_device(planar[None], iq[None], geom, device=device)
    planes = [p[0].cpu().numpy() for p in planes]
    return pack_planes(planes, geom, quant_zz, restart_interval_mcus, optimize)


def _container(scan, samplings, quant_zz, dc_t, ac_t, height, width,
               restart_interval_mcus, comment: str | None = None,
               component_ids=None, quant_ids=None, table_ids=None,
               adobe_transform: int | None = None,
               precision: int = 8) -> bytes:
    """Assemble SOI..EOI around a sequential scan.

    Defaults emit a JFIF stream with ids 1..n and the luma/chroma table
    split; the optional keyword args support Adobe streams (APP14 instead
    of JFIF APP0 — JFIF only allows 1 or 3 components) with custom
    component ids and per-component table assignments. ``dc_t=None`` marks
    an arithmetic scan (SOF9 and DAC in place of SOF0/SOF1 and DHT)."""
    ncomp = len(samplings)
    component_ids = component_ids or [ci + 1 for ci in range(ncomp)]
    quant_ids = quant_ids or [min(ci, 1) for ci in range(ncomp)]
    table_ids = table_ids or [min(ci, 1) for ci in range(ncomp)]
    arithmetic = dc_t is None
    out = bytearray(b"\xff\xd8")  # SOI
    if adobe_transform is None:
        app0 = b"JFIF\x00\x01\x01\x00" + (1).to_bytes(2, "big") * 2 + b"\x00\x00"
        out += b"\xff\xe0" + (len(app0) + 2).to_bytes(2, "big") + app0
    else:
        app14 = b"Adobe" + bytes([0, 100, 0, 0, 0, 0, adobe_transform])
        out += b"\xff\xee" + (len(app14) + 2).to_bytes(2, "big") + app14
    if comment:
        body = comment.encode("utf-8")
        out += b"\xff\xfe" + (len(body) + 2).to_bytes(2, "big") + body
    for tid, q in enumerate(quant_zz):
        body = bytes([tid]) + bytes(q.astype(np.uint8).tolist())
        out += b"\xff\xdb" + (len(body) + 2).to_bytes(2, "big") + body
    sof = bytes([precision]) + height.to_bytes(2, "big") + width.to_bytes(
        2, "big") + bytes([ncomp])
    for ci, (h, v) in enumerate(samplings):
        sof += bytes([component_ids[ci], (h << 4) | v, quant_ids[ci]])
    # 12-bit needs the extended-sequential frame types: SOF1 (Huffman) /
    # SOF9 (arithmetic, which covers both precisions).
    sof_marker = (b"\xff\xc9" if arithmetic
                  else (b"\xff\xc1" if precision == 12 else b"\xff\xc0"))
    out += sof_marker + (len(sof) + 2).to_bytes(2, "big") + sof
    if arithmetic:
        out += _dac_segment(sorted(set(table_ids)))
    else:
        for cls, tables in ((0, dc_t), (1, ac_t)):
            for tid, t in enumerate(tables):
                body = bytes([(cls << 4) | tid]) + bytes(t.bits.tolist()) + bytes(t.values.tolist())
                out += b"\xff\xc4" + (len(body) + 2).to_bytes(2, "big") + body
    if restart_interval_mcus:
        out += b"\xff\xdd\x00\x04" + restart_interval_mcus.to_bytes(2, "big")
    sos = bytes([ncomp])
    for ci in range(ncomp):
        ti = table_ids[ci]
        sos += bytes([component_ids[ci], (ti << 4) | ti])
    sos += bytes([0, 63, 0])
    out += b"\xff\xda" + (len(sos) + 2).to_bytes(2, "big") + sos
    out += scan
    out += b"\xff\xd9"  # EOI
    return bytes(out)


def _dac_segment(table_ids) -> bytes:
    """DAC with the default conditioning (DC L=0 U=1, AC Kx=5; T.81
    F.1.4.4.1.4) for each table slot in use."""
    dac = b""
    for tid in table_ids:
        dac += bytes([tid, (1 << 4) | 0])  # DC: U=1, L=0
        dac += bytes([(1 << 4) | tid, 5])  # AC: Kx=5
    return b"\xff\xcc" + (len(dac) + 2).to_bytes(2, "big") + dac


def _natural_planes(comp_blocks_zz) -> list[np.ndarray]:
    """Quantized zigzag blocks [rows, cols, 64] -> natural-order int16
    planes [rows * 8, cols * 8] (K2's output layout, unpadded)."""
    planes = []
    for blocks_zz in comp_blocks_zz:
        rows, cols, _ = blocks_zz.shape
        nat = unzigzag(blocks_zz.reshape(-1, 64)).reshape(rows, cols, 8, 8)
        planes.append(
            nat.transpose(0, 2, 1, 3).reshape(rows * 8, cols * 8).astype(np.int16)
        )
    return planes


def _arith_scan(comp_blocks_zz, samplings, mcus_x, mcus_y,
                restart_interval_mcus, table_ids, engine: str) -> bytes:
    """A sequential arithmetic (SOF9) scan: the C++ QM coder
    (``engine="native"``) or ``entropy/arith.py`` (``"python"``)."""
    if engine == "python":
        from jpeg_tpu_torch.entropy.arith import encode_scan_arith

        return encode_scan_arith(comp_blocks_zz, samplings, mcus_x, mcus_y,
                                 restart_interval_mcus, table_ids)
    segs = native_encode_arith_scan(
        _natural_planes(comp_blocks_zz), _slots(samplings),
        [h for h, _ in samplings], [v for _, v in samplings],
        mcus_x, mcus_x * mcus_y, restart_interval_mcus, table_ids)
    return join_segments(segs)


def encode_rgb(rgb: np.ndarray, quality: int = 85,
               subsampling: tuple[int, int] = (2, 2),
               restart_interval_mcus: int = 0,
               grayscale: bool = False,
               engine: str = "native",
               optimize: bool = False,
               comment: str | None = None,
               arithmetic: bool = False,
               precision: int = 8) -> bytes:
    """Encode [H, W, 3] RGB (or [H, W] gray) to sequential JFIF bytes.

    ``subsampling`` is the luma sampling factor (h, v): (1,1)=4:4:4,
    (2,1)=4:2:2, (2,2)=4:2:0. ``engine``: "native" (threaded C++ entropy
    pack, parallel over restart segments) or "python". ``optimize=True``
    runs a statistics pass and emits per-image optimal Huffman tables
    (Annex K.2) instead of the typical Annex K tables.
    ``arithmetic=True`` emits SOF9 QM-coded entropy instead (adaptive, so
    ``optimize`` does not apply). ``precision=12`` emits a 12-bit
    extended-sequential stream (SOF1 Huffman, always with optimal tables,
    or SOF9) from [H, W(, 3)] u16 samples in [0, 4095]. The forward
    transform runs in NumPy on the host, as in the JAX package; the device
    transform is :func:`encode_rgb_device`.
    """
    if precision not in (8, 12):
        raise ValueError(f"unsupported precision {precision}")
    if engine not in ("native", "python"):
        raise ValueError(f"unknown engine {engine!r}")
    (comp_blocks_zz, samplings, quant_zz, height, width,
     mcus_x, mcus_y, grayscale) = _forward_transform(
        rgb, quality, subsampling, grayscale, precision)

    if arithmetic:
        scan = _arith_scan(comp_blocks_zz, samplings, mcus_x, mcus_y,
                           restart_interval_mcus,
                           [min(ci, 1) for ci in range(len(samplings))],
                           engine)
        return _container(scan, samplings, quant_zz, None, None, height,
                          width, restart_interval_mcus, comment=comment,
                          precision=precision)

    dc_t, ac_t = _huffman_tables(grayscale, optimize or precision == 12,
                                 comp_blocks_zz, samplings,
                                 restart_interval_mcus, mcus_x, mcus_y)
    dc_maps = [_build_encode_maps(t) for t in dc_t]
    ac_maps = [_build_encode_maps(t) for t in ac_t]
    entropy = _entropy_native if engine == "native" else _entropy_python
    scan = entropy(comp_blocks_zz, samplings, dc_maps, ac_maps,
                   mcus_x, mcus_y, restart_interval_mcus)
    return _container(scan, samplings, quant_zz, dc_t, ac_t, height, width,
                      restart_interval_mcus, comment=comment,
                      precision=precision)


def encode_rgb_progressive(rgb: np.ndarray, quality: int = 85,
                           subsampling: tuple[int, int] = (2, 2),
                           grayscale: bool = False,
                           scan_script=None,
                           restart_interval: int = 0,
                           arithmetic: bool = False,
                           precision: int = 8) -> bytes:
    """Encode to a progressive JFIF stream: SOF2, or SOF10 with
    ``arithmetic=True``.

    libjpeg's standard scan script (or ``scan_script``) with per-scan
    optimal Huffman tables; the same quantized coefficients as
    :func:`encode_rgb`, so both decode to the same pixels. Huffman scans
    run in C++ (``runtime.native_encode_progressive_scans``, byte-identical
    to ``entropy/progressive_encode.py``); arithmetic scans run in
    ``entropy/arith.py``, as in the JAX package, which has no C++ SOF10
    encoder."""
    from jpeg_tpu_torch.entropy.progressive_encode import standard_scan_script

    if precision not in (8, 12):
        raise ValueError(f"unsupported precision {precision}")
    (comp_blocks_zz, samplings, quant_zz, height, width,
     mcus_x, mcus_y, grayscale) = _forward_transform(
        rgb, quality, subsampling, grayscale, precision)
    ncomp = len(samplings)

    if arithmetic:
        from jpeg_tpu_torch.entropy.arith import encode_progressive_scans_arith

        scans = encode_progressive_scans_arith(
            comp_blocks_zz, samplings, mcus_x, mcus_y,
            scan_script or standard_scan_script(ncomp), restart_interval,
            [min(ci, 1) for ci in range(ncomp)])
    else:
        scans = native_encode_progressive_scans(
            comp_blocks_zz, samplings, mcus_x, mcus_y, width, height,
            scan_script=scan_script, restart_interval=restart_interval)

    out = bytearray(b"\xff\xd8")
    app0 = b"JFIF\x00\x01\x01\x00" + (1).to_bytes(2, "big") * 2 + b"\x00\x00"
    out += b"\xff\xe0" + (len(app0) + 2).to_bytes(2, "big") + app0
    for tid, q in enumerate(quant_zz):
        body = bytes([tid]) + bytes(q.astype(np.uint8).tolist())
        out += b"\xff\xdb" + (len(body) + 2).to_bytes(2, "big") + body
    sof = bytes([precision]) + height.to_bytes(2, "big") + width.to_bytes(
        2, "big") + bytes([ncomp])
    for ci, (h, v) in enumerate(samplings):
        sof += bytes([ci + 1, (h << 4) | v, min(ci, 1)])
    out += (b"\xff\xca" if arithmetic else b"\xff\xc2") + (
        len(sof) + 2).to_bytes(2, "big") + sof  # SOF10 / SOF2
    if arithmetic:
        out += _dac_segment(sorted({min(ci, 1) for ci in range(ncomp)}))
    if restart_interval:
        out += b"\xff\xdd\x00\x04" + restart_interval.to_bytes(2, "big")
    for scan in scans:
        # Per-scan DHT(s): DC tables at slots by component position, AC at 0.
        for cls_name, slot, table in scan["tables"]:
            cls = 0 if cls_name == "dc" else 1
            body = bytes([(cls << 4) | slot]) + bytes(table.bits.tolist()) \
                + bytes(table.values.tolist())
            out += b"\xff\xc4" + (len(body) + 2).to_bytes(2, "big") + body
        sos = bytes([len(scan["comps"])])
        for si, ci in enumerate(scan["comps"]):
            if arithmetic:
                dc_sel = ac_sel = min(ci, 1)
            else:
                dc_sel = si if scan["ss"] == 0 and scan["ah"] == 0 else 0
                ac_sel = 0
            sos += bytes([ci + 1, (dc_sel << 4) | ac_sel])
        sos += bytes([scan["ss"], scan["se"], (scan["ah"] << 4) | scan["al"]])
        out += b"\xff\xda" + (len(sos) + 2).to_bytes(2, "big") + sos
        out += scan["data"]
    out += b"\xff\xd9"
    return bytes(out)


def encode_cmyk(cmyk: np.ndarray, quality: int = 85,
                engine: str = "native",
                restart_interval_mcus: int = 0,
                ycck: bool = False,
                comment: str | None = None,
                arithmetic: bool = False) -> bytes:
    """Encode [H, W, 4] u8 CMYK (Pillow convention) to an Adobe JPEG,
    byte-identical to the JAX package's ``encode_cmyk``.

    Emits an APP14 transform-0 stream with C,M,Y,K component ids, 4:4:4
    sampling, and the luma quant/Huffman tables for every component
    (libjpeg's CMYK defaults). Bytes are stored Adobe-inverted (255 - ink),
    matching what Pillow writes and reads back via its ``CMYK;I`` rawmode.
    ``ycck=True`` emits APP14 transform 2 with the ink channels
    YCbCr-converted first (libjpeg jccolor rgb_ycck_convert). ``engine``:
    "native" (the C++ packer) or "python". ``arithmetic=True`` writes SOF9
    through ``entropy/arith.py`` whatever ``engine``, as the JAX package
    does.
    """
    if engine not in ("native", "python"):
        raise ValueError(f"unknown engine {engine!r}")
    cmyk = np.asarray(cmyk)
    if cmyk.ndim != 3 or cmyk.shape[2] != 4 or 0 in cmyk.shape[:2]:
        raise ValueError(f"expected [H, W, 4] CMYK with H, W >= 1, "
                         f"got shape {cmyk.shape}")
    height, width = cmyk.shape[:2]
    samplings = [(1, 1)] * 4
    mcus_x, mcus_y = -(-width // 8), -(-height // 8)
    q_luma = annex_k.scaled_quant_table(annex_k.QUANT_LUMA, quality)
    fwd = forward_dct_matrix()
    stored = 255.0 - cmyk.astype(np.float32)  # Adobe inversion
    if ycck:
        # libjpeg cmyk_ycck_convert re-inverts the ink to RGB-like values
        # (r = 255 - stored = the Pillow-convention ink) before the YCbCr
        # forward; K stays stored.
        r, g, b = (cmyk[..., i].astype(np.float32) for i in range(3))
        y = 0.299 * r + 0.587 * g + 0.114 * b
        cb = (b - y) / (2.0 - 2.0 * 0.114) + 128.0
        cr = (r - y) / (2.0 - 2.0 * 0.299) + 128.0
        stored = np.stack([y, cb, cr, stored[..., 3]], axis=-1)
    comp_blocks_zz = []
    for ci in range(4):
        plane = _pad_to(stored[..., ci] - 128.0, mcus_y * 8, mcus_x * 8)
        coeffs = _plane_to_blocks(plane) @ fwd
        zz = np.round(zigzag(coeffs) / q_luma.astype(np.float32)).astype(np.int32)
        comp_blocks_zz.append(zz.reshape(mcus_y, mcus_x, 64))

    if arithmetic:
        scan = _arith_scan(comp_blocks_zz, samplings, mcus_x, mcus_y,
                           restart_interval_mcus, [0] * 4, "python")
        return _container(scan, samplings, [q_luma], None, None, height,
                          width, restart_interval_mcus, comment=comment,
                          component_ids=[67, 77, 89, 75],
                          quant_ids=[0] * 4, table_ids=[0] * 4,
                          adobe_transform=2 if ycck else 0)
    dc_t = [HuffmanTable.from_bits_values(
        annex_k.DC_LUMA_BITS, annex_k.DC_LUMA_VALS)]
    ac_t = [HuffmanTable.from_bits_values(
        annex_k.AC_LUMA_BITS, annex_k.AC_LUMA_VALS)]
    dc_maps = [_build_encode_maps(dc_t[0])] * 2
    ac_maps = [_build_encode_maps(ac_t[0])] * 2
    entropy = _entropy_native if engine == "native" else _entropy_python
    scan = entropy(comp_blocks_zz, samplings, dc_maps, ac_maps,
                   mcus_x, mcus_y, restart_interval_mcus)
    return _container(scan, samplings, [q_luma], dc_t, ac_t, height, width,
                      restart_interval_mcus, comment=comment,
                      component_ids=[67, 77, 89, 75],  # 'C','M','Y','K'
                      quant_ids=[0] * 4, table_ids=[0] * 4,
                      adobe_transform=2 if ycck else 0)
