"""Host container layer: JPEG marker walk -> ``DecodePlan``.

Parity: reference ``src/jpeg/mod.rs:202-465`` (``JPEGImage::parse``): SOI/EOI,
COM, DQT (8- and 16-bit entries), SOF0, DHT, SOS, APP0. Beyond the reference:
- DRI / RST0-7 restart segmentation (reference panics: ``src/jpeg/mod.rs:427``)
  — the feature that makes entropy decode parallel.
- All APPn segments are skipped instead of panicking (``src/jpeg/mod.rs:446``).
- Clear errors instead of panics for unsupported SOF types.

The output is a *decode plan*: plain arrays (quant tables, Huffman LUTs,
per-segment byte ranges, MCU geometry) that the C++ runtime and the CUDA
kernels consume. The parse itself is irregular byte work and stays on the
host.

Copy of ``jpeg_tpu/io/container.py`` (importing that module loads jax), held
to it field by field by ``tests/test_torch_container.py``. Differences: scans
over 64 KB always unstuff through the port's C++ binding (a missing library
raises instead of falling back), and :func:`plan_from_reference` converts a
``jpeg_tpu`` plan so both packages decode the same tables in tests.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from jpeg_tpu_torch.entropy.tables import HuffmanTable, empty_table, shared_table
from jpeg_tpu_torch.utils import profiling

# Marker bytes (second byte after 0xFF).
SOI = 0xD8
EOI = 0xD9
SOS = 0xDA
DQT = 0xDB
DRI = 0xDD
DHT = 0xC4
COM = 0xFE
SOF0 = 0xC0  # baseline sequential DCT
SOF_MIN, SOF_MAX = 0xC0, 0xCF  # SOFn family (C4=DHT, C8=JPG, CC=DAC excluded)
RST0, RST7 = 0xD0, 0xD7
APP0, APP15 = 0xE0, 0xEF


class JPEGError(ValueError):
    """Malformed or unsupported JPEG stream."""


@dataclasses.dataclass
class ComponentInfo:
    """Merged frame+scan per-component config.

    Parity: reference ``JPEGDecoderComponentFields``
    (``src/jpeg/decoder.rs:39-52``) and the frame/scan component headers
    (``src/jpeg/mod.rs:104-139``).
    """

    component_id: int
    h: int  # horizontal sampling factor
    v: int  # vertical sampling factor
    quant_id: int
    dc_id: int = -1
    ac_id: int = -1


@dataclasses.dataclass
class Segment:
    """One restart segment of the entropy-coded stream (byte-aligned)."""

    byte_start: int  # offset into unstuffed scan bytes
    byte_end: int
    mcu_start: int
    mcu_count: int


@dataclasses.dataclass
class ProgScan:
    """One scan of a progressive (SOF2) stream.

    Tables are snapshotted at scan time (DHT may redefine slots between
    scans); ``bounds`` are restart-segment byte ranges within ``scan_data``.
    """

    comp_indices: list[int]
    dc_ids: list[int]
    ac_ids: list[int]
    ss: int
    se: int
    ah: int
    al: int
    scan_data: np.ndarray
    bounds: list[tuple[int, int]]
    restart_interval: int
    dc_tables: list
    ac_tables: list
    # Arithmetic conditioning snapshot (SOF10; DAC may redefine between
    # scans, so capture at scan time like the Huffman table snapshots).
    arith_dc_L: tuple = (0, 0, 0, 0)
    arith_dc_U: tuple = (1, 1, 1, 1)
    arith_ac_K: tuple = (5, 5, 5, 5)
    # Lossless (SOF3, T.81 Annex H — beyond the reference AND this
    # system's libjpeg-turbo 2.1.5): an "MCU" is one sample position;
    # predictor = SOS Ss (1-7), point_transform = SOS Al.
    lossless: bool = False
    predictor: int = 0
    point_transform: int = 0


@dataclasses.dataclass
class DecodePlan:
    """Everything device + entropy decoders need, as plain arrays.

    Replaces the reference's ``JPEGImage`` mutable state
    (``src/jpeg/mod.rs:59-87``) with an immutable struct-of-arrays plan.
    """

    width: int
    height: int
    components: list[ComponentInfo]
    quant_tables: np.ndarray  # [4, 64] u16, zigzag order
    dc_tables: list[HuffmanTable]  # 4 slots
    ac_tables: list[HuffmanTable]  # 4 slots
    scan_data: np.ndarray  # [n] u8 unstuffed entropy bytes (all segments)
    segments: list[Segment]
    restart_interval: int  # MCUs per restart segment; 0 = none
    # Derived geometry (JPEG A.1.1, spec-correct — the reference's MCU count
    # math at src/jpeg/decoder.rs:164-192 under-counts for 4:2:0; see SURVEY
    # §2 quirks. We follow the spec/libjpeg.)
    h_max: int = 1
    v_max: int = 1
    mcus_x: int = 0
    mcus_y: int = 0
    comment: str | None = None
    jfif_version: tuple[int, int] | None = None
    jfif_units: int | None = None
    jfif_density: tuple[int, int] | None = None
    exif: dict | None = None
    adobe_transform: int | None = None  # APP14 color transform (0/1/2)
    progressive: bool = False
    prog_scans: list = dataclasses.field(default_factory=list)
    # Arithmetic coding (SOF9 + DAC, T.81 Annex D/F — beyond the reference,
    # which is Huffman-only). Conditioning defaults per F.1.4.4.1.4.
    arith_code: bool = False
    # Sample precision (SOF P field): 8, or 12 on SOF1/SOF9 extended
    # sequential (level shift 1<<(P-1), DC/AC magnitude categories 15/14).
    precision: int = 8
    arith_dc_L: tuple = (0, 0, 0, 0)
    arith_dc_U: tuple = (1, 1, 1, 1)
    arith_ac_K: tuple = (5, 5, 5, 5)
    # Lossless (SOF3, T.81 Annex H — beyond the reference AND this
    # system's libjpeg-turbo 2.1.5): an "MCU" is one sample position;
    # predictor = SOS Ss (1-7), point_transform = SOS Al.
    lossless: bool = False
    predictor: int = 0
    point_transform: int = 0

    @property
    def color_model(self) -> str:
        """Decoded colorspace: gray | ycbcr | rgb | cmyk | ycck.

        Follows libjpeg jdcolor default_decompress_parms: 3 components are
        YCbCr unless APP14 says transform 0 or the component ids spell R,G,B;
        4 components are CMYK (YCCK when APP14 transform is 2)."""
        ids = tuple(c.component_id for c in self.components)
        if len(ids) == 1:
            return "gray"
        if len(ids) == 4:
            return "ycck" if self.adobe_transform == 2 else "cmyk"
        if self.adobe_transform == 0 or ids == (82, 71, 66):
            return "rgb"
        return "ycbcr"

    @property
    def n_mcus(self) -> int:
        return self.mcus_x * self.mcus_y

    @property
    def blocks_per_mcu(self) -> int:
        return sum(c.h * c.v for c in self.components)

    @property
    def total_blocks(self) -> int:
        return self.n_mcus * self.blocks_per_mcu

    def component_block_slots(self) -> list[tuple[int, int]]:
        """Stream order of blocks within one MCU: (component_index, sub_index).

        Interleave order per JPEG A.2.3: components in scan order, each
        contributing v*h blocks row-major. Parity: reference MCU loop
        ``src/jpeg/decoder.rs:195-215``.
        """
        slots = []
        for ci, c in enumerate(self.components):
            for s in range(c.h * c.v):
                slots.append((ci, s))
        return slots


def _u16(data: np.ndarray, i: int) -> int:
    """Big-endian u16 read (reference ``u8s_to_u16``, src/jpeg/mod.rs:9-13)."""
    return (int(data[i]) << 8) | int(data[i + 1])


def _unstuff_and_segment(data: np.ndarray, start: int):
    """Scan entropy-coded data: strip 0xFF00 stuffing, split at RSTn markers.

    Returns (unstuffed bytes, list of (seg_start, seg_end) into those bytes,
    index one past the terminating marker start). Parity: reference byte
    unstuffing ``src/jpeg/mod.rs:371-385``; RST handling is new (reference
    panics on DRI and never sees RST markers).

    Vectorized: find all 0xFF positions once, classify successors, then build
    per-segment slices with the stuffed zeros dropped via np.delete. Large
    scans route through the C++ runtime's single-pass scanner.
    """
    if len(data) - start > 65536:
        from jpeg_tpu_torch.runtime import native_unstuff_scan

        return native_unstuff_scan(data, start)
    buf = data[start:]
    ff = np.flatnonzero(buf == 0xFF)
    seg_bounds = []  # (rel_start, rel_end) raw byte ranges, per segment
    seg_start = 0
    end_rel = len(buf)
    for p in ff.tolist():
        if p + 1 >= len(buf):
            end_rel = p
            break
        nxt = int(buf[p + 1])
        if nxt == 0x00:
            continue  # stuffed 0xFF data byte
        if RST0 <= nxt <= RST7:
            seg_bounds.append((seg_start, p))
            seg_start = p + 2
            continue
        # Any other marker terminates the scan (EOI, next SOS, DNL, ...).
        end_rel = p
        break
    else:
        end_rel = len(buf)
    seg_bounds.append((seg_start, end_rel))

    out_chunks = []
    out_bounds = []
    pos = 0
    for s, e in seg_bounds:
        chunk = buf[s:e]
        # Drop the 0x00 of each 0xFF00 pair inside this chunk.
        ffs = np.flatnonzero(chunk[:-1] == 0xFF) + 1 if len(chunk) else np.array([], np.int64)
        zeros = ffs[chunk[ffs] == 0x00] if len(ffs) else ffs
        if len(zeros):
            chunk = np.delete(chunk, zeros)
        out_chunks.append(chunk)
        out_bounds.append((pos, pos + len(chunk)))
        pos += len(chunk)
    unstuffed = np.concatenate(out_chunks) if out_chunks else np.zeros(0, np.uint8)
    return unstuffed, out_bounds, start + end_rel


def parse_jpeg(data: bytes | np.ndarray) -> DecodePlan:
    """Parse a baseline JPEG byte stream into a :class:`DecodePlan`.

    Parity: reference ``JPEGImage::parse`` (``src/jpeg/mod.rs:202-465``); like
    the reference it decodes the first scan only (single-scan baseline).

    The plan's Huffman tables are shared (``entropy.tables.shared_table``):
    each is the plan's own :class:`HuffmanTable` object, but its arrays are
    read-only and are those of every other plan whose DHT carried the same
    bytes, built once and kept in a process-wide cache of at most 64 tables
    (8.1 MiB); the unused slots share one all-invalid table. Inside a
    recorded span (``utils.profiling``, the ``decode.parse`` span of
    ``BatchedCorpusDecoder``) the parse counts the DHT tables it read,
    ``tables``, and those the cache already held, ``tables_reused``.
    """
    vec = np.frombuffer(bytes(data), dtype=np.uint8) if not isinstance(data, np.ndarray) else data
    n = len(vec)
    if n < 4 or vec[0] != 0xFF or vec[1] != SOI:
        raise JPEGError("not a JPEG: missing SOI marker")

    quant = np.zeros((4, 64), dtype=np.uint16)
    dc_tables: list[HuffmanTable] = [empty_table() for _ in range(4)]
    ac_tables: list[HuffmanTable] = [empty_table() for _ in range(4)]
    arith_code = False
    sample_precision = 8
    lossless = False
    predictor = 0
    point_transform = 0
    arith_dc_L = [0, 0, 0, 0]
    arith_dc_U = [1, 1, 1, 1]
    arith_ac_K = [5, 5, 5, 5]
    components: list[ComponentInfo] = []
    width = height = 0
    restart_interval = 0
    comment = None
    jfif_version = jfif_units = jfif_density = None
    exif = None
    adobe_transform = None
    scan_data = np.zeros(0, np.uint8)
    segments: list[Segment] = []
    got_frame = False
    progressive = False
    prog_scans: list[ProgScan] = []

    i = 2
    while i < n - 1:
        if vec[i] != 0xFF:
            raise JPEGError(f"expected marker at {i}, got {vec[i]:#04x}")
        marker = int(vec[i + 1])
        if marker == 0xFF:  # fill byte
            i += 1
            continue
        if marker in (SOI, EOI) or RST0 <= marker <= RST7:
            if marker == EOI:
                break
            i += 2
            continue
        if i + 4 > n:
            raise JPEGError(f"truncated marker segment at {i}")
        seg_len = _u16(vec, i + 2)
        if seg_len < 2:
            raise JPEGError(f"bad segment length {seg_len} at {i}")
        body = i + 4
        body_len = seg_len - 2
        if body + body_len > n:
            raise JPEGError(
                f"marker segment at {i} runs past end of stream")

        if marker == COM:
            try:
                comment = bytes(vec[body : body + body_len]).decode("utf-8")
            except UnicodeDecodeError:
                comment = None
        elif marker == DQT:
            # JPEG B.2.4.1; parity src/jpeg/mod.rs:228-261 incl. 16-bit entries.
            idx = body
            seg_end = body + body_len
            while idx < seg_end:
                precision = (int(vec[idx]) & 0xF0) >> 4
                ident = int(vec[idx]) & 0x0F
                if ident > 3:
                    raise JPEGError(f"invalid DQT destination {ident}")
                size = 65 if precision == 0 else 129
                if precision > 1:
                    raise JPEGError(f"bad quant table precision {precision}")
                if idx + size > seg_end:
                    raise JPEGError("truncated DQT segment")
                if precision == 0:
                    quant[ident] = vec[idx + 1 : idx + 65].astype(np.uint16)
                else:
                    raw = vec[idx + 1 : idx + 129].astype(np.uint16)
                    quant[ident] = (raw[0::2] << 8) | raw[1::2]
                idx += size
        elif marker == DHT:
            # JPEG B.2.4.2; parity src/jpeg/mod.rs:299-335.
            idx = body
            seg_end = body + body_len
            while idx < seg_end:
                if idx + 17 > seg_end:
                    raise JPEGError("truncated DHT segment")
                table_class = (int(vec[idx]) & 0xF0) >> 4
                dest = int(vec[idx]) & 0x0F
                idx += 1
                bits = vec[idx : idx + 16]
                idx += 16
                count = int(bits.sum())
                if idx + count > seg_end:
                    raise JPEGError("truncated DHT segment")
                values = vec[idx : idx + count]
                idx += count
                if dest > 3:
                    raise JPEGError(f"invalid DHT destination {dest}")
                if table_class == 0 and count and int(values.max()) > 16:
                    # DC symbols are magnitude categories (JPEG F.1.2.1.1,
                    # 0..16); larger values would make the entropy decoders
                    # read >16 magnitude bits (libjpeg rejects these too).
                    raise JPEGError(
                        f"invalid DC Huffman symbol {int(values.max())} > 16")
                table, reused = shared_table(bits, values)
                profiling.count("tables", 1)
                profiling.count("tables_reused", int(reused))
                (dc_tables if table_class == 0 else ac_tables)[dest] = table
        elif marker == DRI:
            # JPEG B.2.4.4 — reference panics here (src/jpeg/mod.rs:424-428).
            restart_interval = _u16(vec, body)
        elif marker in (SOF0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA):
            # JPEG B.2.2; parity src/jpeg/mod.rs:262-298. SOF2 = progressive,
            # SOF1 = extended sequential — at 8-bit precision its decode is
            # identical to baseline (more table slots, which we already
            # support). SOF9 = sequential DCT with arithmetic entropy coding
            # (QM coder, entropy/arith.py). All beyond the reference.
            precision = int(vec[body])
            lossless = marker == 0xC3
            if lossless:
                # SOF3 lossless: any precision 2..16 (T.81 Table B.3).
                if not 2 <= precision <= 16:
                    raise JPEGError(
                        f"invalid lossless precision {precision}")
            elif precision == 12 and marker in (0xC1, 0xC2, 0xC9, 0xCA):
                # 12-bit extended/progressive (T.81 Table B.2): magnitude
                # categories grow to DC<=15 / AC<=14 and the level shift
                # to 2048; every tier below (oracle, C++ runtime, XLA
                # pipeline, progressive + arithmetic state machines)
                # handles it. Beyond both the reference and this
                # system's 8-bit-built libjpeg.
                pass
            elif precision != 8:
                raise JPEGError(
                    f"unsupported sample precision {precision} for "
                    f"SOF{marker - 0xC0} (8-bit everywhere; 12-bit on "
                    "SOF1/SOF2/SOF9/SOF10)")
            progressive = marker in (0xC2, 0xCA)
            height = _u16(vec, body + 1)
            width = _u16(vec, body + 3)
            if width == 0 or (height == 0 and progressive):
                raise JPEGError(f"invalid frame dimensions {width}x{height}")
            # height == 0 is legal for sequential frames: the real height
            # arrives in a DNL marker after the first scan (B.2.5 — beyond
            # the reference AND libjpeg, which ignores DNL).
            ncomp = int(vec[body + 5])
            if ncomp == 0 or ncomp > 4:
                raise JPEGError(f"unsupported component count {ncomp}")
            idx = body + 6
            for _ in range(ncomp):
                cid = int(vec[idx])
                h = (int(vec[idx + 1]) & 0xF0) >> 4
                v = int(vec[idx + 1]) & 0x0F
                # Power-of-two factors 1/2/4 (a superset of the reference's
                # 1/2, src/jpeg/mod.rs:275-277); 3 is legal JPEG but
                # vanishingly rare and not supported by the tiled kernels.
                if h not in (1, 2, 4) or v not in (1, 2, 4):
                    raise JPEGError(f"unsupported sampling factors {h}x{v}")
                if lossless and (h != 1 or v != 1):
                    raise JPEGError(
                        "lossless (SOF3) supports 1x1 sampling only")
                tq = int(vec[idx + 2])
                if tq > 3:
                    raise JPEGError(f"invalid quant table id {tq}")
                components.append(ComponentInfo(cid, h, v, quant_id=tq))
                idx += 3
            arith_code = marker in (0xC9, 0xCA)
            sample_precision = precision
            got_frame = True
        elif marker == 0xCC:
            # DAC: arithmetic conditioning (B.2.4.3). DC: Cs = (U << 4) | L;
            # AC: Cs = Kx.
            idx = body
            seg_end = body + body_len
            if body_len % 2:
                raise JPEGError(
                    f"truncated DAC segment: odd parameter length {body_len}")
            while idx + 1 < seg_end:
                tc, tb = int(vec[idx]) >> 4, int(vec[idx]) & 0x0F
                cs = int(vec[idx + 1])
                idx += 2
                if tb > 3:
                    raise JPEGError(f"invalid DAC table id {tb}")
                if tc == 0:
                    low, up = cs & 0x0F, cs >> 4
                    if low > up:
                        raise JPEGError(
                            f"invalid DC conditioning L={low} > U={up}")
                    arith_dc_L[tb], arith_dc_U[tb] = low, up
                elif tc == 1:
                    if not 1 <= cs <= 63:
                        raise JPEGError(f"invalid AC conditioning Kx={cs}")
                    arith_ac_K[tb] = cs
                else:
                    raise JPEGError(f"invalid DAC class {tc}")
        elif SOF_MIN <= marker <= SOF_MAX and marker not in (0xC4, 0xC8, 0xCC):
            raise JPEGError(
                f"unsupported SOF type {marker:#04x}: only baseline (SOF0), "
                "extended sequential (SOF1, 8-bit), progressive (SOF2) and "
                "arithmetic (SOF9/SOF10) DCT are supported"
            )
        elif marker == SOS:
            # JPEG B.2.3; parity src/jpeg/mod.rs:337-362 (without its i+=2
            # indexing quirk — we read each component's own bytes).
            if not got_frame:
                raise JPEGError("SOS before SOF0")
            ncomp_scan = int(vec[body]) if body_len >= 1 else -1
            if not 1 <= ncomp_scan <= 4:
                raise JPEGError(f"invalid scan component count {ncomp_scan}")
            # Header is Ns byte + 2 bytes/component + Ss/Se/AhAl (B.2.3);
            # bound every read by the declared segment length so crafted
            # Ns/short segments raise JPEGError, not IndexError.
            if body_len < 1 + 2 * ncomp_scan + 3:
                raise JPEGError("truncated SOS header")
            idx = body + 1
            scan_comp_idx: list[int] = []
            scan_dc_ids: list[int] = []
            scan_ac_ids: list[int] = []
            for _ in range(ncomp_scan):
                cid = int(vec[idx])
                dc_id = (int(vec[idx + 1]) & 0xF0) >> 4
                ac_id = int(vec[idx + 1]) & 0x0F
                matched = [
                    (j, c) for j, c in enumerate(components)
                    if c.component_id == cid
                ]
                if not matched:
                    raise JPEGError(f"scan component {cid} not in frame")
                j, comp = matched[0]
                comp.dc_id = dc_id
                comp.ac_id = ac_id
                scan_comp_idx.append(j)
                scan_dc_ids.append(dc_id)
                scan_ac_ids.append(ac_id)
                idx += 2
            # Spectral selection / successive approximation (B.2.3).
            ss = int(vec[idx])
            se = int(vec[idx + 1])
            ah = (int(vec[idx + 2]) & 0xF0) >> 4
            al = int(vec[idx + 2]) & 0x0F
            idx += 3
            if lossless:
                # H: Ss = predictor selection, Se = 0, Al = Pt.
                predictor = ss
                point_transform = al
                if not 1 <= predictor <= 7:
                    raise JPEGError(f"invalid predictor {predictor}")
                if se != 0 or ah != 0:
                    raise JPEGError(
                        f"invalid lossless scan header Se={se} Ah={ah}")
                if point_transform >= precision:
                    raise JPEGError(
                        f"point transform {point_transform} >= precision")
            elif ss > 63 or se > 63 or ss > se:
                raise JPEGError(f"invalid spectral selection {ss}..{se}")
            if progressive:
                # libjpeg jdphuff start_pass checks: a refinement scan must
                # peel exactly one bit (Ah == Al+1), Al <= 13, and AC bands
                # are single-component.
                if al > 13 or (ah and ah != al + 1):
                    raise JPEGError(
                        f"invalid successive approximation Ah={ah} Al={al}")
                if ss > 0 and len(scan_comp_idx) != 1:
                    raise JPEGError(
                        "progressive AC scan must be single-component")
            if any(t > 3 for t in scan_dc_ids + scan_ac_ids):
                raise JPEGError("invalid scan table selector > 3")
            if not progressive and ncomp_scan < len(components):
                if lossless:
                    raise JPEGError(
                        "non-interleaved multi-scan lossless unsupported")
                # Non-interleaved multi-scan sequential (each component in
                # its own scan, A.2.2): legal JPEG but out of scope — the
                # engine decodes the FIRST sequential scan only (reference
                # parity, src/jpeg/mod.rs:417). Decoding a partial-frame
                # scan as if it were the whole image would be silently
                # wrong, so refuse with a clear error instead.
                raise JPEGError(
                    f"sequential scan covers {ncomp_scan} of "
                    f"{len(components)} frame components "
                    "(non-interleaved multi-scan sequential unsupported)")
            scan_data, bounds, scan_end = _unstuff_and_segment(vec, idx)
            if height == 0:
                # DNL (B.2.5): FF DC 00 04 NL — defines the number of lines
                # when the frame header deferred it.
                if (scan_end + 6 > n or vec[scan_end] != 0xFF
                        or vec[scan_end + 1] != 0xDC):
                    raise JPEGError(
                        "frame height 0 requires a DNL marker after the "
                        "first scan")
                height = _u16(vec, scan_end + 4)
                if height == 0:
                    raise JPEGError("invalid DNL line count 0")
            if progressive:
                prog_scans.append(ProgScan(
                    comp_indices=scan_comp_idx,
                    dc_ids=scan_dc_ids,
                    ac_ids=scan_ac_ids,
                    ss=ss, se=se, ah=ah, al=al,
                    scan_data=scan_data,
                    bounds=bounds,
                    restart_interval=restart_interval,
                    dc_tables=list(dc_tables),
                    ac_tables=list(ac_tables),
                    arith_dc_L=tuple(arith_dc_L),
                    arith_dc_U=tuple(arith_dc_U),
                    arith_ac_K=tuple(arith_ac_K),
                ))
                i = scan_end
                continue
            h_max = max(c.h for c in components)
            v_max = max(c.v for c in components)
            if lossless:
                mcus_x, mcus_y = width, height  # one sample per MCU
            else:
                mcus_x = (width + 8 * h_max - 1) // (8 * h_max)
                mcus_y = (height + 8 * v_max - 1) // (8 * v_max)
            n_mcus = mcus_x * mcus_y
            ri = restart_interval or n_mcus
            segments = []
            for k, (s, e) in enumerate(bounds):
                mcu_start = k * ri
                if mcu_start >= n_mcus:
                    break
                segments.append(
                    Segment(s, e, mcu_start, min(ri, n_mcus - mcu_start))
                )
            plan = DecodePlan(
                width=width,
                height=height,
                components=components,
                quant_tables=quant,
                dc_tables=dc_tables,
                ac_tables=ac_tables,
                scan_data=scan_data,
                segments=segments,
                restart_interval=restart_interval,
                h_max=h_max,
                v_max=v_max,
                mcus_x=mcus_x,
                mcus_y=mcus_y,
                comment=comment,
                jfif_version=jfif_version,
                jfif_units=jfif_units,
                jfif_density=jfif_density,
                exif=exif,
                adobe_transform=adobe_transform,
                arith_code=arith_code,
                precision=sample_precision,
                arith_dc_L=tuple(arith_dc_L),
                arith_dc_U=tuple(arith_dc_U),
                arith_ac_K=tuple(arith_ac_K),
                lossless=lossless,
                predictor=predictor,
                point_transform=point_transform,
            )
            # Like the reference (src/jpeg/mod.rs:417): first scan only.
            return plan
        elif APP0 <= marker <= APP15:
            if marker == APP0 + 1:  # APP1: EXIF (reference has no support)
                from jpeg_tpu_torch.io.exif import parse_exif

                exif = exif or parse_exif(bytes(vec[body : body + body_len]))
            if marker == APP0 + 14 and body_len >= 12:
                # Adobe APP14: the transform flag picks CMYK vs YCCK for
                # 4-component and RGB vs YCbCr for 3-component streams.
                if bytes(vec[body : body + 5]) == b"Adobe":
                    adobe_transform = int(vec[body + 11])
            if marker == APP0 and body_len >= 14:
                # JFIF APP0 (reference parses-and-discards with absolute-
                # offset bugs, src/jpeg/mod.rs:429-444; we parse correctly).
                ident = bytes(vec[body : body + 5])
                if ident == b"JFIF\x00":
                    jfif_version = (int(vec[body + 5]), int(vec[body + 6]))
                    jfif_units = int(vec[body + 7])
                    jfif_density = (_u16(vec, body + 8), _u16(vec, body + 10))
            # other APPn: skip (reference panics on APP12/APP14).
        else:
            raise JPEGError(f"unhandled marker 0xff{marker:02x} at {i}")
        i = body + body_len
    if progressive and prog_scans:
        h_max = max(c.h for c in components)
        v_max = max(c.v for c in components)
        return DecodePlan(
            width=width, height=height, components=components,
            quant_tables=quant, dc_tables=dc_tables, ac_tables=ac_tables,
            scan_data=np.zeros(0, np.uint8), segments=[],
            restart_interval=restart_interval,
            h_max=h_max, v_max=v_max,
            mcus_x=(width + 8 * h_max - 1) // (8 * h_max),
            mcus_y=(height + 8 * v_max - 1) // (8 * v_max),
            comment=comment, jfif_version=jfif_version,
            jfif_units=jfif_units, jfif_density=jfif_density, exif=exif,
            adobe_transform=adobe_transform,
            progressive=True, prog_scans=prog_scans,
            arith_code=arith_code, precision=sample_precision,
            arith_dc_L=tuple(arith_dc_L), arith_dc_U=tuple(arith_dc_U),
            arith_ac_K=tuple(arith_ac_K),
        )
    raise JPEGError("no SOS marker found (no image data)")


def plan_from_reference(plan) -> DecodePlan:
    """Convert a ``jpeg_tpu.io.container.DecodePlan`` into this package's
    :class:`DecodePlan`, copying every field (tables rebuilt from their DHT
    lists, so the LUTs are this package's own). Used by tests that feed
    the same parsed stream to both packages; duck-typed so this module never
    imports ``jpeg_tpu``."""

    def table(t) -> HuffmanTable:
        return HuffmanTable.from_bits_values(np.array(t.bits), np.array(t.values))

    def segments(segs) -> list[Segment]:
        return [Segment(s.byte_start, s.byte_end, s.mcu_start, s.mcu_count)
                for s in segs]

    fields = {f.name: getattr(plan, f.name)
              for f in dataclasses.fields(DecodePlan)}
    fields["components"] = [
        ComponentInfo(c.component_id, c.h, c.v, c.quant_id, c.dc_id, c.ac_id)
        for c in plan.components]
    fields["quant_tables"] = np.array(plan.quant_tables)
    fields["dc_tables"] = [table(t) for t in plan.dc_tables]
    fields["ac_tables"] = [table(t) for t in plan.ac_tables]
    fields["scan_data"] = np.array(plan.scan_data)
    fields["segments"] = segments(plan.segments)
    fields["exif"] = dict(plan.exif) if plan.exif is not None else None
    fields["prog_scans"] = [
        ProgScan(**{
            **{f.name: getattr(s, f.name) for f in dataclasses.fields(ProgScan)},
            "comp_indices": list(s.comp_indices),
            "dc_ids": list(s.dc_ids),
            "ac_ids": list(s.ac_ids),
            "scan_data": np.array(s.scan_data),
            "bounds": list(s.bounds),
            "dc_tables": [table(t) for t in s.dc_tables],
            "ac_tables": [table(t) for t in s.ac_tables],
        })
        for s in plan.prog_scans]
    return DecodePlan(**fields)
