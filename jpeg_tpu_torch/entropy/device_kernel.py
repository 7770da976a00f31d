"""K4, device entropy decode over whole word columns (the v4 tier).

Counterpart of ``jpeg_tpu/entropy/device_kernel.py``
(``decode_coefficients_device4[_batch]``, ``kernel_runner[_batch]``,
``plan_kernel_tables``, ``_lane_words``, ``_plan_w``). The CUDA kernel is
``csrc/huffman_words.cu``; :func:`decode_words_plain` is its plain PyTorch
twin, decoding all lanes in lockstep with tensor operations.

The kernel runs K3's two passes over the word columns (a serial walk per
lane that records each block's start bit and DC predictor, then one thread
per block), from the tables K3's passes read
(:func:`~jpeg_tpu_torch.entropy.device_huffman.kernel_tables`), which
:func:`kernel_tables_device` builds on the host from the same rows as
``luts`` and ``hvs``.

Layout (the TPU kernel's): one lane per restart segment, on the minor axis.
``words [W, S]`` int32 holds each lane's segment as big-endian 32-bit words,
padded with 0xAA fill bytes up to ``W`` words; a word index at or past
``W`` reads 0. Output ``[max_mcus, bpm, 64, S]`` int32 (zigzag order, DC
predicted), every element written, and ``err [1, S]`` bool.

Contract, bit for bit that of the TPU kernel (flagged lanes included):

- the twin keeps the TPU kernel's 96-bit register, refilled with two words
  whenever it holds <= 32 bits; the TPU kernel decodes a symbol only while
  it holds >= 31 bits, which always holds after a refill (a symbol takes at
  most 32 bits, so a refill leaves >= 33). The register's cursor is the
  bits a lane consumed, which is all the CUDA kernel keeps of it;
- at most ``MAX_BLOCK_STEPS`` AC symbols per block in the twin; a block
  still open after them would flag its lane. It cannot happen: a block
  opens at coefficient 1 and every AC symbol advances it by at least 1, so
  63 symbols close any block (``tests/test_torch_k4_two_pass.py``), and the
  CUDA kernel carries no counter;
- a lane stops at its first invalid prefix: that block keeps what it wrote
  plus its DC predictor, its later blocks and blocks past its ``nblk`` are
  zeros;
- a lane is also flagged when it consumed more than 8 bits past its
  segment end (``cursor > bitend + 8``).

Because refills past ``W`` read zeros (not 0xAA forever, as K3 does), a
flagged lane's garbage depends on ``W``: :func:`kernel_runner` rounds ``W``
up to 8 words, :func:`kernel_runner_batch` to 256, as the TPU runners do.

The VMEM launch sizing of the TPU module (``suggest_device_batch``,
``fit_batch_plans``) and its "mxu" Kronecker gather have nothing to port:
the card has no 16 MiB scoped-VMEM frame, and the kernel indexes its tables.
``gather`` is accepted for parity with the TPU API; "mxu" tables exist only
to be held to the JAX ones, and both values run the same kernel.
:func:`decode_words` takes the plain version only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from jpeg_tpu_torch.entropy.device_huffman import (
    T11,
    _magnitude,
    _resolve,
    kernel_tables,
    lane_tables,
    slot_rows,
)
from jpeg_tpu_torch.utils.build import LaunchCounter, load_cuda_kernel

MAX_BLOCK_STEPS = 70  # AC symbols per block before a lane is flagged
MAX_SLOTS = 10        # blocks per MCU (JPEG limit)
GATHERS = ("select", "mxu")

LAUNCHES = LaunchCounter()


# --------------------------------------------------------------------------
# Host-side preparation


def _plan_w(plan) -> int:
    """Word-column height for ``plan`` under kernel_runner_batch's
    256-word bucketing (+4 slack words for refill prefetch)."""
    mw = max(-(-(s.byte_end - s.byte_start) // 4)
             for s in plan.segments) + 4
    return -(-mw // 256) * 256


def plan_kernel_tables(plan, gather: str = "select"):
    """(lut11s, huffvals, canon) of the TPU kernel: rows 0-3 DC tables, 4-7
    AC; ``canon[row]`` = (mincode, maxcode, valptr) tuples of five ints for
    code lengths 12..16. "select" gives i32 [8, T11, 1] / [8, 256, 1]
    columns; "mxu" the TPU's f32 [8, 64, 32] / [8, 16, 16] Kronecker split
    of the same tables (the CUDA kernel only reads the "select" layout)."""
    _check_gather(gather)
    lut, hv, cn = lane_tables(plan)
    canon = tuple(tuple(tuple(int(v) for v in row[5 * j : 5 * j + 5])
                        for j in range(3)) for row in cn)
    if gather == "mxu":
        return (np.ascontiguousarray(lut.reshape(8, 32, 64).transpose(0, 2, 1))
                .astype(np.float32),
                np.ascontiguousarray(hv.reshape(8, 16, 16).transpose(0, 2, 1))
                .astype(np.float32),
                canon)
    return lut[:, :, None], hv[:, :, None], canon


def _check_gather(gather: str) -> None:
    if gather not in GATHERS:
        raise ValueError(f"unknown gather {gather!r}")


def _lane_words(scan, segs, max_words: int) -> np.ndarray:
    """[W, S] i32 big-endian u32 word columns, one per lane, 0xAA-padded
    (the reference's tail-fill byte, ``src/jpeg/huffman.rs:240-250``)."""
    out = np.full((max_words, len(segs)), 0xAAAAAAAA, np.uint32)
    b = np.frombuffer(bytes(scan), np.uint8)
    for i, s in enumerate(segs):
        seg = b[s.byte_start : s.byte_end]
        n_words = -(-len(seg) // 4)
        padded = np.full(n_words * 4, 0xAA, np.uint8)
        padded[: len(seg)] = seg
        w = padded.reshape(-1, 4).astype(np.uint32)
        out[:n_words, i] = (
            (w[:, 0] << 24) | (w[:, 1] << 16) | (w[:, 2] << 8) | w[:, 3])
    return out.view(np.int32)


def kernel_constants(plan, device="cuda"):
    """(canon [8, 15], slots [bpm, 3]) int32 tensors on ``device``: the
    constants the TPU kernel bakes into its trace, which the ``run`` of
    :func:`kernel_runner` hands to :func:`decode_words` beside ``args``."""
    dev = torch.device(device)
    return (torch.from_numpy(lane_tables(plan)[2]).to(dev),
            torch.from_numpy(slot_rows(plan)).to(dev))


def kernel_tables_device(lut, hv, canon, slots, device) -> tuple:
    """The CUDA kernel's tables on ``device``, from :func:`lane_tables`'
    ``lut [8, T11]``, ``hv [8, 256]``, ``canon [8, 15]`` and
    :func:`slot_rows`' ``slots [bpm, 3]`` (numpy int32): K3's
    (skip, pair, huffval, canon, slots) of
    :func:`~jpeg_tpu_torch.entropy.device_huffman.kernel_tables`, cut to the
    table rows the slots use."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in kernel_tables(lut, hv, canon, slots))


def _runner(words, plan, nblk, bitend, max_mcus, device, gather):
    """(run, args) for K4 over prepared lanes. ``args`` are the TPU kernel's
    (words, luts, hvs, nblk, bitend) on ``device``; ``run`` carries the
    constants the TPU kernel bakes into its trace (canonical parameters,
    slot structure, ``max_mcus``) and, on a CUDA device, the kernel's skip
    and pair tables."""
    _check_gather(gather)
    for t in plan.dc_tables:  # the parser refuses these; a built plan may not
        if len(t.values) and int(np.max(t.values)) > 16:
            raise ValueError(f"DC Huffman symbol {int(np.max(t.values))} > 16: "
                             "K4's register shifts at most 32 bits a symbol")
    luts, hvs, _ = plan_kernel_tables(plan, "select")
    dev = torch.device(device)
    args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        words, luts, hvs, np.array([nblk], np.int32),
        np.array([bitend], np.int32)))
    canon_t, slots_t = kernel_constants(plan, dev)
    tables = (kernel_tables_device(*lane_tables(plan), slot_rows(plan), dev)
              if dev.type == "cuda" else None)

    def run(words, luts, hvs, nblk, bitend):
        return decode_words(words, luts, hvs, nblk, bitend, canon_t, slots_t,
                            max_mcus, tables)

    return run, args


def kernel_runner(plan, device="cuda", gather: str = "select"):
    """K4 for one ``plan`` -> (run, args, max_mcus, S). ``run(*args)``
    returns the raw ([max_mcus, bpm, 64, S] i32, err [1, S] bool) tensors on
    ``device``, not synchronised."""
    segs = plan.segments
    bpm = plan.blocks_per_mcu
    max_mcus = max(s.mcu_count for s in segs)
    # Lane-private word columns: +4 slack words for refill prefetch.
    max_words = max(-(-(s.byte_end - s.byte_start) // 4) for s in segs) + 4
    W = -(-max_words // 8) * 8
    words = _lane_words(plan.scan_data, segs, W)
    nblk = [s.mcu_count * bpm for s in segs]
    bitend = [(s.byte_end - s.byte_start) * 8 for s in segs]
    run, args = _runner(words, plan, nblk, bitend, max_mcus, device, gather)
    return run, args, max_mcus, len(segs)


def decode_coefficients_device4(plan, device="cuda", gather: str = "select",
                                to_host: bool = True):
    """Entropy-decode one plan with K4 on ``device`` -> ([total_blocks, 64]
    i32, err [S] bool): numpy arrays, or with ``to_host=False`` tensors on
    ``device``, not synchronised."""
    run, args, max_mcus, S = kernel_runner(plan, device, gather)
    out, err = run(*args)
    coeffs = out.permute(3, 0, 1, 2).reshape(-1, 64)[: plan.total_blocks]
    if to_host:
        return coeffs.cpu().numpy(), err[0].cpu().numpy()
    return coeffs, err[0]


def kernel_runner_batch(plans: list, device="cuda", gather: str = "select"):
    """K4 over a corpus: every plan's restart segments stacked on the lane
    axis -> (run, args, max_mcus, S_total, lane_base), ``lane_base[i]``
    image i's first lane. Raises ``ValueError`` before anything is launched
    unless all plans share the first one's slot structure and Huffman
    tables; per-image segment counts and lengths may differ."""
    if not plans:
        raise ValueError("empty batch")
    p0 = plans[0]
    slots = slot_rows(p0)
    tables = lane_tables(p0)
    for p in plans[1:]:
        if not np.array_equal(slot_rows(p), slots) or not all(
                np.array_equal(a, b) for a, b in zip(lane_tables(p), tables)):
            raise ValueError(
                "in-kernel batch requires identical slot structure and "
                "Huffman tables across images")
    bpm = p0.blocks_per_mcu
    max_mcus = max(s.mcu_count for p in plans for s in p.segments)
    W = max(_plan_w(p) for p in plans)  # the TPU runner's 256-word buckets
    lane_base, cols, nblk, bitend = [], [], [], []
    pos = 0
    for p in plans:
        lane_base.append(pos)
        cols.append(_lane_words(p.scan_data, p.segments, W))
        nblk.extend(s.mcu_count * bpm for s in p.segments)
        bitend.extend((s.byte_end - s.byte_start) * 8 for s in p.segments)
        pos += len(p.segments)
    run, args = _runner(np.concatenate(cols, axis=1), p0, nblk, bitend,
                        max_mcus, device, gather)
    return run, args, max_mcus, pos, lane_base


def decode_coefficients_device4_batch(plans: list, device="cuda",
                                      gather: str = "select",
                                      to_host: bool = True):
    """Corpus entropy decode in one K4 launch -> (list of [total_blocks, 64]
    i32 per image, err [S_total]). An image whose restart interval is
    shorter than the batch-wide longest segment is trimmed segment by
    segment. ``to_host=False`` returns tensors on ``device``, not
    synchronised; otherwise numpy arrays."""
    run, args, max_mcus, S, lane_base = kernel_runner_batch(plans, device,
                                                            gather)
    bpm = plans[0].blocks_per_mcu
    out, err = run(*args)
    flat = out.permute(3, 0, 1, 2).reshape(S, max_mcus * bpm, 64)
    results = []
    for p, row in zip(plans, lane_base):
        segs = p.segments
        if all(s.mcu_count == max_mcus for s in segs[:-1]):
            img = flat[row : row + len(segs)].reshape(-1, 64)
        else:
            img = torch.cat([flat[row + i, : s.mcu_count * bpm]
                             for i, s in enumerate(segs)])
        results.append(img[: p.total_blocks])
    if to_host:
        return [r.cpu().numpy() for r in results], err[0].cpu().numpy()
    return results, err[0]


# --------------------------------------------------------------------------
# The kernel's plain twin


def _word_peek(words, lanes, cursor):
    """32 stream bits of each lane at bit ``cursor`` (int64), reading 0 for
    word indices at or past W (the last row of ``words`` is that zero)."""
    last = words.shape[0] - 1
    w = cursor >> 5
    off = cursor & 31
    a = words[torch.clamp(w, max=last), lanes]
    b = words[torch.clamp(w + 1, max=last), lanes]
    return ((a << off) | (b >> (32 - off))) & 0xFFFFFFFF


def decode_words_plain(words, luts, hvs, nblk, bitend, canon, slots,
                       max_mcus: int):
    """Plain PyTorch K4 over the kernel's own arguments: ``words [W, S]``,
    ``luts [8, T11, 1]``, ``hvs [8, 256, 1]``, ``nblk``/``bitend [1, S]``
    int32, ``canon [8, 15]`` and ``slots [bpm, 3]`` int32. All lanes step
    through the MCUs in lockstep; within a block, AC symbols repeat until
    every lane is done or the step cap hits. The register is kept as its
    word index ``wi`` and bit count ``cnt`` (its bits are the 32-bit peek at
    ``cursor = wi * 32 - cnt``). Returns (out [max_mcus, bpm, 64, S] int32,
    err [1, S] bool)."""
    dev = words.device
    i64 = torch.int64
    W, S = words.shape
    wz = torch.cat([words.to(i64) & 0xFFFFFFFF,
                    torch.zeros((1, S), dtype=i64, device=dev)])
    lut, hv = luts[:, :, 0].to(i64), hvs[:, :, 0].to(i64)
    canon = canon.cpu().tolist()
    slots = slots.cpu().tolist()
    bpm = len(slots)
    nblk, bitend = nblk[0].to(i64), bitend[0].to(i64)
    lanes = torch.arange(S, device=dev)
    out = torch.zeros((max_mcus, bpm, 64, S), dtype=torch.int32, device=dev)
    wi = torch.full((S,), 2, dtype=i64, device=dev)
    cnt = torch.full((S,), 64, dtype=i64, device=dev)
    err = torch.zeros(S, dtype=torch.bool, device=dev)
    dc = torch.zeros((4, S), dtype=i64, device=dev)

    def refill():
        gain = torch.where(cnt <= 32, 64, 0)
        return wi + gain // 32, cnt + gain

    for k in range(max_mcus * bpm):
        active = ~err & (k < nblk)
        if not bool(active.any()):
            break  # err and k < nblk only narrow: nothing is active later
        comp, dcr, acr = slots[k % bpm]
        acr += 4
        block = torch.zeros((S, 64), dtype=i64, device=dev)
        wi, cnt = refill()
        peek = _word_peek(wz, lanes, wi * 32 - cnt)
        ln, size = _resolve(lut[dcr], hv[dcr], canon[dcr], peek)
        bad = active & (ln == 0)
        ok = active & ~bad
        size = torch.where(ok, size, 0)
        block[:, 0] = torch.where(ok, _magnitude(peek, ln, size), 0)
        cnt = cnt - torch.where(ok, ln + size, 0)
        err = err | bad
        coef = torch.where(ok, 1, 64)
        for _ in range(MAX_BLOCK_STEPS):
            busy = active & ~err & (coef < 64)
            if not bool(busy.any()):
                break
            wi, cnt = refill()
            busy = busy & (cnt >= 31)  # the TPU kernel's mask; true after refill
            peek = _word_peek(wz, lanes, wi * 32 - cnt)
            ln, sym = _resolve(lut[acr], hv[acr], canon[acr], peek)
            bad = busy & (ln == 0)
            go = busy & ~bad
            eob, zrl = sym == 0x00, sym == 0xF0
            nbits = torch.where(eob | zrl, 0, sym & 0xF)
            val = _magnitude(peek, ln, nbits)
            pos = coef + torch.minimum((sym >> 4) & 0xF, 63 - coef)
            write = go & ~eob & ~zrl
            block[lanes[write], pos[write]] = val[write]
            coef_next = torch.where(
                eob, 64, torch.where(zrl, (coef + 16).clamp(max=64), pos + 1))
            coef = torch.where(go, coef_next, coef)
            cnt = cnt - torch.where(go, ln + nbits, 0)
            err = err | bad
        err = err | (active & (coef < 64))
        dc[comp] = dc[comp] + torch.where(active, block[:, 0], 0)
        block[:, 0] = dc[comp]
        block = torch.where(active[:, None], block, 0)
        out[k // bpm, k % bpm] = block.to(torch.int32).T
    err = err | (wi * 32 - cnt > bitend + 8)
    return out, err[None]


# --------------------------------------------------------------------------
# The kernel


def _configure(lib) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int32
    lib.jt_huffman_words.restype = ctypes.c_int
    lib.jt_huffman_words.argtypes = [
        vp, i32, i32, vp, vp,  # words, W, S, nblk, bitend
        vp, vp, vp, vp, vp,  # skip, pair, huffval, canon, slots
        i32, i32, i32,  # table rows, bpm, max_mcus
        vp, vp, vp, vp,  # meta, out, err, stream
    ]


def load_kernel():
    """Build (at first use) and load the K4 library."""
    return load_cuda_kernel("huffman_words", (), _configure,
                            headers=("huffman_common.cuh",))


def _check_args(words, luts, hvs, nblk, bitend, canon, slots):
    W, S = words.shape
    want = {"words": (torch.int32, (W, S)), "luts": (torch.int32, (8, T11, 1)),
            "hvs": (torch.int32, (8, 256, 1)), "nblk": (torch.int32, (1, S)),
            "bitend": (torch.int32, (1, S)), "canon": (torch.int32, (8, 15)),
            "slots": (torch.int32, (slots.shape[0], 3))}
    dev = words.device
    for name, x in zip(want, (words, luts, hvs, nblk, bitend, canon, slots)):
        dtype, shape = want[name]
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"K4 input {name} must be {dtype} {list(shape)}, "
                             f"got {x.dtype} {list(x.shape)}")
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"K4 input {name} must be contiguous on {dev}")
    if W < 2 or S < 1 or not 1 <= slots.shape[0] <= MAX_SLOTS:
        raise ValueError(f"K4 takes W >= 2, S >= 1 and 1..{MAX_SLOTS} slots")
    if W * S >= 2**31:
        raise ValueError(f"K4 indexes words with 32 bits: W * S = {W * S} "
                         "must stay below 2^31")


def decode_words_cuda(words, luts, hvs, nblk, bitend, canon, slots,
                      max_mcus: int, tables=None):
    """Launch K4's two passes on the current stream. Same contract as
    :func:`decode_words_plain`. ``tables`` are :func:`kernel_tables_device`'s
    for these ``luts``, ``hvs``, ``canon`` and ``slots`` (the runners build
    them once); without them they are built here, through the host. Every
    output element is written once, so the outputs, and the per-block
    records the passes share (16 B a block and lane), are allocated
    uninitialised."""
    _check_args(words, luts, hvs, nblk, bitend, canon, slots)
    dev = words.device
    W, S = words.shape
    bpm = slots.shape[0]
    if tables is None:
        tables = kernel_tables_device(
            luts[:, :, 0].cpu().numpy(), hvs[:, :, 0].cpu().numpy(),
            canon.cpu().numpy(), slots.cpu().numpy(), dev)
    skip, pair, hv, cn, kslots = tables
    for x in tables:
        if x.dtype != torch.int32 or x.device != dev or not x.is_contiguous():
            raise ValueError(f"K4 tables must be contiguous int32 on {dev}")
    if (skip.shape != pair.shape or skip.shape[1] != T11
            or tuple(hv.shape) != (skip.shape[0], 256)
            or tuple(cn.shape) != (skip.shape[0], 15)
            or tuple(kslots.shape) != (bpm, 3)):
        raise ValueError("K4 tables do not belong to these slots")
    lib = load_kernel()
    out = torch.empty((max_mcus, bpm, 64, S), dtype=torch.int32, device=dev)
    meta = torch.empty((max_mcus * bpm, S, 4), dtype=torch.int32, device=dev)
    err = torch.empty(S, dtype=torch.uint8, device=dev)
    rc = lib.jt_huffman_words(
        words.data_ptr(), W, S, nblk.data_ptr(), bitend.data_ptr(),
        skip.data_ptr(), pair.data_ptr(), hv.data_ptr(), cn.data_ptr(),
        kslots.data_ptr(), skip.shape[0], bpm, max_mcus, meta.data_ptr(),
        out.data_ptr(), err.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K4 launch failed: CUDA error {rc}")
    LAUNCHES.add()
    return out, err.bool()[None]


def decode_words(words, luts, hvs, nblk, bitend, canon, slots,
                 max_mcus: int, tables=None):
    """K4 wrapper: the plain version for CPU tensors, the kernel for CUDA
    tensors (no fallback between them). ``tables``: see
    :func:`decode_words_cuda`; the plain version reads ``luts``."""
    kind = words.device.type
    if kind == "cpu":
        return decode_words_plain(words, luts, hvs, nblk, bitend, canon,
                                  slots, max_mcus)
    if kind == "cuda":
        return decode_words_cuda(words, luts, hvs, nblk, bitend, canon,
                                 slots, max_mcus, tables)
    raise ValueError(f"K4 runs on cpu or cuda, not {words.device}")
