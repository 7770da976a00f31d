"""The two-sentinel check of K3, K4 and K7 on damaged lanes: a check of
uninitialised reads that needs no sanitizer.

K3 and K4 allocate their outputs with ``torch.empty`` and K7 its lane
counts, on the contract that every entry a consumer reads is written by the
kernel (``entropy/device_huffman.py::decode_lanes_cuda``,
``device_kernel.py::decode_words_cuda``, ``device_spec.py::spec_lanes_cuda``).
:func:`check` runs each kernel twice over the fuzz's damaged cases
(``jpeg_tpu_torch.tools.fuzz``: its 20 variants, corrupted by its recipe),
with every ``torch.empty`` of the kernel's module pre-filled with one byte
the first time and another byte the second (:func:`filled_empty`, a patch of
the module's ``torch`` for the duration of the run: the library is not
changed). Every entry that a consumer reads must be equal across the two
runs:

- K3 (``decode_lanes``): the error flags, and the coefficient rows of
  every unflagged lane;
- K4 (``kernel_runner_batch``): the error flags, and the blocks of every
  unflagged lane up to its segment's MCUs;
- K7: what its caller reads, ``decode_coefficients_device_spec``'s
  coefficients (or None: a broken chain) and stats, at two overlaps.

Entries that no consumer reads (rows of flagged lanes, K4's blocks past a
lane's segment) are compared too and reported, not held. On the CPU the
wrappers run their plain twins, which allocate with ``torch.zeros``: the
check then only rehearses its own control flow.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

SENTINELS = (0xA5, 0x5A)
SPEC_LANES = 64
SPEC_OVERLAPS = (24, 2)


class _FilledTorch:
    """``torch`` with ``empty`` returning tensors whose every byte is
    ``byte``; every other name is torch's."""

    def __init__(self, byte: int):
        self._byte = byte

    def __getattr__(self, name):
        return getattr(torch, name)

    def empty(self, *args, **kwargs):
        x = torch.empty(*args, **kwargs)
        if x.numel():
            x.view(-1).view(torch.uint8).fill_(self._byte)
        return x


@contextlib.contextmanager
def filled_empty(modules, byte: int):
    """Within the block, ``torch.empty`` in each of ``modules`` returns
    tensors filled with ``byte``."""
    saved = [m.torch for m in modules]
    try:
        for m in modules:
            m.torch = _FilledTorch(byte)
        yield
    finally:
        for m, t in zip(modules, saved):
            m.torch = t


def damaged_plans(seeds) -> list[tuple[str, object]]:
    """(label, plan) of the fuzz's cases for ``seeds`` that parse and that
    the lane decoders take (sequential 8-bit Huffman DCT scans)."""
    from jpeg_tpu_torch.io.container import parse_jpeg
    from jpeg_tpu_torch.tools import fuzz

    out = []
    for name, data in fuzz.make_variants().items():
        for seed in seeds:
            try:
                plan = parse_jpeg(fuzz.corrupt(name, data, seed))
            except ValueError:
                continue
            if fuzz.sequential_huffman(plan):
                out.append((f"{name}/{seed}", plan))
    return out


def _k3(plan, dev):
    """K3 on one plan -> (read entries, all entries), or None if refused."""
    from jpeg_tpu_torch.entropy import device_huffman as k3

    try:
        batch = k3.prepare_lane_batch([plan])
    except ValueError:
        return None
    n = len(batch.lane_start)
    coeffs, err = k3.decode_lanes(k3.lane_tensors(batch, dev), n,
                                  batch.total_rows)
    coeffs, err = coeffs.cpu().numpy(), err.cpu().numpy()
    rows = [coeffs[int(r0) : int(r0) + int(nb)]
            for lane, (r0, nb) in enumerate(zip(batch.lane_out, batch.lane_nblk))
            if not err[lane]]
    return [err, *rows], [err, coeffs]


def _k4(plan, dev):
    """K4 on one plan -> (read entries, all entries), or None if refused."""
    from jpeg_tpu_torch.entropy import device_kernel as k4
    from jpeg_tpu_torch.tools.fuzz import lane_blocks

    try:
        run, args, _, _, lane_base = k4.kernel_runner_batch([plan], dev)
    except ValueError:
        return None
    out, err = run(*args)
    blocks = lane_blocks(out.cpu().numpy())
    err = err[0].cpu().numpy()
    bpm, l0 = plan.blocks_per_mcu, lane_base[0]
    rows = [blocks[l0 + j, : s.mcu_count * bpm]
            for j, s in enumerate(plan.segments) if not err[l0 + j]]
    return [err, *rows], [err, blocks]


def _k7(plan, dev):
    """K7's caller on one plan -> (read entries, the same), or None when
    K7 does not take it (segments that do not cover every MCU)."""
    from jpeg_tpu_torch.entropy.device_spec import (
        decode_coefficients_device_spec,
    )
    from jpeg_tpu_torch.tools.fuzz import covers

    if not covers(plan):
        return None
    got = []
    for overlap in SPEC_OVERLAPS:
        try:
            coeffs, stats = decode_coefficients_device_spec(
                plan, SPEC_LANES, overlap, device=dev)
        except ValueError as e:
            got += [type(e).__name__]
            continue
        got += [None if coeffs is None else coeffs.cpu().numpy(),
                repr(sorted(stats.items()))]
    return got, got


def _equal(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.shape == b.shape and np.array_equal(a, b))
    return a == b


def check(device="cuda", seeds=range(3), kernels=("K3", "K4", "K7")) -> dict:
    """Run ``kernels`` twice over the damaged cases of ``seeds``; returns
    per kernel ``{"cases", "read_differ": [labels], "unread_differ":
    [labels], "launches"}`` (the kernel's launches over both runs; its
    counter is added to, never reset)."""
    from jpeg_tpu_torch.entropy import device_huffman, device_kernel, device_spec

    table = {"K3": (device_huffman, _k3), "K4": (device_kernel, _k4),
             "K7": (device_spec, _k7)}
    dev = torch.device(device)
    plans = damaged_plans(list(seeds))
    res = {}
    for name in kernels:
        module, run = table[name]
        before = module.LAUNCHES.value  # the caller's count runs on
        rec = {"cases": 0, "read_differ": [], "unread_differ": []}
        for label, plan in plans:
            runs = []
            for byte in SENTINELS:
                with filled_empty([module], byte):
                    runs.append(run(plan, dev))
            if runs[0] is None:
                continue
            rec["cases"] += 1
            (read_a, all_a), (read_b, all_b) = runs
            if len(read_a) != len(read_b) or not all(
                    map(_equal, read_a, read_b)):
                rec["read_differ"].append(label)
            elif not all(map(_equal, all_a, all_b)):
                rec["unread_differ"].append(label)
        rec["launches"] = module.LAUNCHES.value - before
        res[name] = rec
    return res
