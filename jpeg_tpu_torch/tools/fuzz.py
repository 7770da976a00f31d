"""Deterministic corruption fuzz of every decode route: the port's
counterpart of the repo-root ``tools/fuzz.py``.

    python -m jpeg_tpu_torch.tools.fuzz [LO HI] [--routes ...]
        [--clean-size WxH] [--device cuda|cpu]

The JAX tool's contract, kept exactly. For each of its 20 stream variants
(:data:`VARIANTS`; its docstring says 16 and ``tools/README.md`` 19, its
dict holds 20) and each seed in ``[LO, HI)`` (default 0 40), a case is the
variant with 1-5 XOR byte flips from byte 2, then nothing, a truncation or
a 16-byte insertion, all drawn from
``numpy.random.default_rng(zlib.crc32(name) * 1000 + seed)``
(:func:`corrupt`). Failures: an exception other than ``ValueError``
escaping a decode, two decodes that give different pixels, one that
decodes while the other raises. The core comparison is the JAX tool's,
``decode_bytes(engine="oracle")`` against ``engine="native"``, here on
``--device`` (the card by default).

Each case also goes through the port's kernel routes (``--routes``), where
the route takes the stream:

- ``k1``: ``decode_bytes(path="fast")`` on the device against the same call
  with ``device="cpu"`` (K1 against its twin): the same pixels or the same
  exception type. Taken by the fast path's own test (``fast_path_takes``).
- ``k3``: ``decode_coefficients_device5`` (K3); ``k4``:
  ``decode_coefficients_device4`` through ``kernel_runner`` (K4). Each
  flags the same lanes as its plain twin run on the CPU, its unflagged
  lanes equal the twin's and, where the C++ decoder decodes the stream,
  the C++ decoder's coefficients; where the C++ decoder raises, a lane is
  flagged. Taken by every sequential 8-bit Huffman DCT stream (the lane
  decoders' contract; restart segments as parsed, all of them covered).
- ``k7``: ``decode_coefficients_device_spec`` (K7, the host merge, the
  relocate) at :data:`SPEC_LANES` lanes with overlaps 24 and 2: the C++
  decoder's coefficients bit for bit, and a failed merge (``None``)
  exactly where the C++ decoder raises. Taken by those streams whose
  restart segments cover every MCU.
- ``corpus``: the main path, ``BatchedCorpusDecoder(hybrid_device=True)``,
  over 24 clean frames, the case and 7 more clean frames (``--clean-size``,
  4K by default: the main path's restart-per-row fixtures), so that the
  device thread's first claim is the case and 7 clean frames. The clean
  frames decode bit for bit as they do alone, the case as
  ``decode_bytes(path="fast")`` does (pixels, or an error record of the
  same exception type), and no ``RuntimeError`` escapes. The claim's
  outcome is counted: K3 decoded the case, K3 flagged it (host route), the
  route does not take it (``_device_eligible``), its tables differ from
  the clean frames' (``BatchMismatch``: the whole claim on the host), or
  the host took it before the device thread claimed.

Output: one JSON line per case (variant, seed, its outcome per route), a
summary line (cases, problems, and per route the cases taken and, on the
card, the cases that launched the kernel: for the corpus route, the cases
K3 took in a claim), then ``fuzz [LO,HI) x 20
variants: N problems``. Exit 1 on any problem, and when a kernel route
reached no case (on the card: its launch counter never moved).

The five libjpeg variants come from ``fuzz_streams/`` (written by Pillow,
which the card's machine lacks; see its README); ``cmyk_ours`` and
``ycck_ours`` take Pillow's ``convert("CMYK")`` of the image, computed here
(:func:`rgb_to_cmyk`). Every other variant is the port's encoders', which
write the JAX package's bytes.

Under ``compute-sanitizer --tool memcheck`` (or ``initcheck``) run with
``PYTORCH_NO_CUDA_MEMORY_CACHING=1`` so that each tensor is its own
allocation, and a small ``--clean-size``.
"""

from __future__ import annotations

import argparse
import json
import os
import traceback
import zlib

import numpy as np

STREAM_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "fuzz_streams")
SIZE = (144, 96)  # the JAX tool's synthetic_image(144, 96, seed=1)
QUALITY = 80
# The JAX tool's dict, in its order.
VARIANTS = ("ycck_ours", "cmyk_ours", "pil_cmyk_prog", "pil_cmyk", "pil",
            "pil_opt", "pil_prog", "base", "rst", "gray420", "opt", "prog",
            "prog_rst", "arith", "arith_rst", "prog_arith", "p12",
            "p12_arith", "p12_prog", "lossless")
PIL_VARIANTS = ("pil_cmyk_prog", "pil_cmyk", "pil", "pil_opt", "pil_prog")
ROUTES = ("k1", "k3", "k4", "k7", "corpus")
SPEC_LANES = 64
SPEC_OVERLAPS = (24, 2)
CLEAN_BEFORE, CLAIM = 24, 8  # clean frames ahead of the claim; claim size


def rgb_to_cmyk(img: np.ndarray) -> np.ndarray:
    """Pillow's ``convert("CMYK")`` of RGB u8: inverted RGB, K = 0."""
    return np.concatenate([255 - img, np.zeros(img.shape[:2] + (1,),
                                               np.uint8)], axis=-1)


def make_variants() -> dict[str, bytes]:
    """The 20 stream variants, name -> bytes, in the JAX tool's order."""
    from jpeg_tpu_torch.entropy.lossless import encode_lossless
    from jpeg_tpu_torch.io.corpus import synthetic_image
    from jpeg_tpu_torch.models.encoder import (
        encode_cmyk,
        encode_rgb,
        encode_rgb_progressive,
    )

    img = synthetic_image(*SIZE, seed=1)
    cmyk = rgb_to_cmyk(img)
    p12 = img.astype(np.uint16) << 4
    q = QUALITY
    made = {
        "ycck_ours": lambda: encode_cmyk(cmyk, quality=q, ycck=True),
        "cmyk_ours": lambda: encode_cmyk(cmyk, quality=q,
                                         restart_interval_mcus=3),
        "base": lambda: encode_rgb(img, quality=q),
        "rst": lambda: encode_rgb(img, quality=q, restart_interval_mcus=3),
        "gray420": lambda: encode_rgb(img, quality=q, subsampling=(2, 2)),
        "opt": lambda: encode_rgb(img, quality=q, optimize=True),
        "prog": lambda: encode_rgb_progressive(img, quality=q),
        "prog_rst": lambda: encode_rgb_progressive(img, quality=q,
                                                   restart_interval=4),
        "arith": lambda: encode_rgb(img, quality=q, arithmetic=True),
        "arith_rst": lambda: encode_rgb(img, quality=q, arithmetic=True,
                                        restart_interval_mcus=3),
        "prog_arith": lambda: encode_rgb_progressive(img, quality=q,
                                                     arithmetic=True),
        "p12": lambda: encode_rgb(p12, quality=q, precision=12,
                                  engine="python"),
        "p12_arith": lambda: encode_rgb(p12, quality=q, precision=12,
                                        arithmetic=True, engine="python"),
        "p12_prog": lambda: encode_rgb_progressive(p12, quality=q,
                                                   precision=12),
        "lossless": lambda: encode_lossless(img, predictor=4,
                                            restart_interval=11),
    }
    out = {}
    for name in VARIANTS:
        if name in PIL_VARIANTS:
            with open(os.path.join(STREAM_DIR, f"{name}.jpg"), "rb") as f:
                out[name] = f.read()
        else:
            out[name] = made[name]()
    return out


def corrupt(name: str, data: bytes, seed: int) -> bytes:
    """Case ``seed`` of variant ``name``: the JAX tool's recipe."""
    rng = np.random.default_rng(zlib.crc32(name.encode()) * 1000 + seed)
    d = bytearray(data)
    for _ in range(int(rng.integers(1, 6))):
        i = int(rng.integers(2, len(d)))
        d[i] ^= int(rng.integers(1, 256))
    mode = int(rng.integers(0, 3))
    if mode == 1:
        d = d[: int(rng.integers(4, len(d)))]
    elif mode == 2:
        j = int(rng.integers(2, len(d)))
        d = d[:j] + bytes(rng.integers(0, 256, 16, dtype=np.uint8)) + d[j:]
    return bytes(d)


class Unexpected(Exception):
    """An exception other than ValueError escaped a decode (a failure)."""


def outcome(fn):
    """``fn()``'s result, or the name of the ValueError class it raised.
    Any other exception is printed and raised as :class:`Unexpected`."""
    try:
        return fn()
    except ValueError as e:
        return type(e).__name__
    except Exception as e:  # noqa: BLE001 — the fuzz's failure rule
        traceback.print_exc(limit=5)
        raise Unexpected(f"{type(e).__name__}: {str(e)[:200]}") from e


def same(a, b) -> bool:
    """Equal outcomes: equal arrays, or the same exception class."""
    if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
        return a.shape == b.shape and np.array_equal(a, b)
    return type(a) is type(b) and a == b


def brief(a) -> str:
    return "ok" if isinstance(a, np.ndarray) else str(a)


def sequential_huffman(plan) -> bool:
    """Streams the lane decoders (K3, K4, K7) decode: sequential 8-bit
    Huffman DCT scans."""
    return (not plan.lossless and not plan.arith_code and not plan.progressive
            and plan.precision == 8 and len(plan.segments) > 0)


def covers(plan) -> bool:
    """The restart segments cover every MCU."""
    return sum(s.mcu_count for s in plan.segments) == plan.n_mcus


def cpp_coefficients(plan):
    """The C++ decoder's coefficients, or the ValueError class it raised."""
    from jpeg_tpu_torch.runtime import native_decode_coefficients

    return outcome(lambda: native_decode_coefficients(
        plan, reuse_buffer=False).copy())


def _lane_problems(name, err_k, err_p, rows_k, rows_p, lanes, ref) -> list:
    """The lane decoders' rule for one image: equal err vectors; unflagged
    lanes equal the twin's rows and, where the C++ decoder decoded, its
    rows; a flagged lane where the C++ decoder raised. ``lanes`` lists each
    lane's (first row, rows) in the image's rows. ``err_p`` and ``rows_p``
    (the twin's) may be None: no twin ran."""
    out = []
    if err_p is not None and not np.array_equal(err_k, err_p):
        out.append(f"{name}: err vector differs from the plain twin's "
                   f"({int(err_k.sum())} vs {int(err_p.sum())} flagged)")
    for lane, (r0, n) in enumerate(lanes):
        if err_k[lane] or n <= 0:
            continue
        if rows_p is not None and not np.array_equal(rows_k[r0 : r0 + n],
                                                     rows_p[r0 : r0 + n]):
            out.append(f"{name}: unflagged lane {lane} differs from the "
                       "plain twin")
            break
        if (isinstance(ref, np.ndarray)
                and not np.array_equal(rows_k[r0 : r0 + n], ref[r0 : r0 + n])):
            out.append(f"{name}: unflagged lane {lane} differs from the C++ "
                       "decoder")
            break
    if not isinstance(ref, np.ndarray) and not err_k.any():
        out.append(f"{name}: the C++ decoder raised {ref}, no lane flagged")
    return out


def table_groups(plans: dict) -> list[list]:
    """``plans`` (case -> plan) grouped into batches the lane decoders take
    in one launch: equal slot structure and Huffman tables. A plan they
    refuse alone (``ValueError``) is returned as ``(case, name)`` in a group
    of its own."""
    from jpeg_tpu_torch.entropy import device_huffman as k3

    groups: dict = {}
    for case, plan in plans.items():
        refused = outcome(lambda: k3.prepare_lane_batch([plan]))
        if isinstance(refused, str):
            groups[("refused", case)] = [(case, refused)]
            continue
        key = (k3.slot_rows(plan).tobytes(),
               *(a.tobytes() for a in k3.lane_tables(plan)))
        groups.setdefault(key, []).append((case, plan))
    return list(groups.values())


def lane_blocks(out: np.ndarray) -> np.ndarray:
    """K4's raw output [max_mcus, bpm, 64, S] -> [S, max_mcus * bpm, 64]."""
    m, bpm, _, n = out.shape
    return out.transpose(3, 0, 1, 2).reshape(n, m * bpm, 64)


def twin_k3(plans) -> tuple[np.ndarray, np.ndarray]:
    """K3's plain twin over a batch on the CPU -> (coeffs, err)."""
    from jpeg_tpu_torch.entropy import device_huffman as k3

    batch = k3.prepare_lane_batch(plans)
    cp, ep = k3.decode_lanes_plain(k3.lane_tensors(batch, "cpu"),
                                   len(batch.lane_start), batch.total_rows)
    return cp.numpy(), ep.numpy()


def twin_k4(plans) -> tuple[np.ndarray, np.ndarray]:
    """K4's plain twin over a batch on the CPU -> (lane blocks
    [S, max_mcus * bpm, 64], err [S])."""
    from jpeg_tpu_torch.entropy import device_kernel as k4

    run, args, _, _, _ = k4.kernel_runner_batch(plans, "cpu")
    out, err = run(*args)
    return lane_blocks(out.numpy()), err[0].numpy()


TWINS = {"k3": twin_k3, "k4": twin_k4}


def _twin_worker_init() -> None:
    import torch

    torch.set_num_threads(1)  # one process a core


class Fuzz:
    """The routes on one device, with per-route counts of cases taken and
    (on the card) launched."""

    def __init__(self, device="cuda", routes=ROUTES,
                 clean_size=(3840, 2160), twins: bool = True):
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        import torch

        self.dev = torch.device(device)
        # On the card, K3 and K4 are also held to their twins (on the CPU
        # the route runs the twin itself). The twins step lanes in lockstep
        # and take up to ~90 s a batch on lanes of fill bytes: worker
        # processes, one a core but this one's, run them meanwhile.
        self._pool = ProcessPoolExecutor(
            max(1, (os.cpu_count() or 1) - 1),
            multiprocessing.get_context("spawn"),
            initializer=_twin_worker_init) if (
                twins and self.dev.type == "cuda"
                and {"k3", "k4"} & set(routes)) else None
        self.routes = tuple(routes)
        self.taken = {r: 0 for r in self.routes}
        self.launched = {r: 0 for r in self.routes}
        self.claims: dict[str, int] = {}
        self._corpus_k3 = 0  # cases K3 decoded or flagged in a claim
        self.clean_size = tuple(clean_size)
        self._clean = None
        self._decoder = None

    def close(self) -> None:
        if self._decoder is not None:
            self._decoder.close()
            self._decoder = None
        if self._pool is not None:
            self._pool.shutdown(cancel_futures=True)
            self._pool = None

    def _launches(self, route: str) -> int:
        from jpeg_tpu_torch.entropy import device_huffman as k3
        from jpeg_tpu_torch.entropy import device_kernel as k4
        from jpeg_tpu_torch.entropy import device_spec as k7
        from jpeg_tpu_torch.ops import fused_plane as k1

        if route == "corpus":  # K3 took the case itself, not just the claim
            return self._corpus_k3
        return {"k1": k1.LAUNCHES, "k3": k3.LAUNCHES, "k4": k4.LAUNCHES,
                "k7": k7.LAUNCHES}[route].value

    def cases(self, datas: list[bytes]) -> list[tuple[dict, list]]:
        """Cases through the engines and every route -> per case (outcome
        per check, problems). K3 and K4 take the cases of equal tables in
        one launch each; their twins run meanwhile in worker processes."""
        from jpeg_tpu_torch.io.container import parse_jpeg

        out = [({}, []) for _ in datas]
        plans = {}
        for i, data in enumerate(datas):
            plan = self._guard("parse", *out[i],
                               lambda: outcome(lambda: parse_jpeg(data)))
            if plan is not None and not isinstance(plan, str):
                plans[i] = plan
        lane_jobs = []
        for route in ("k3", "k4"):
            if route not in self.routes:
                continue
            taken = {i: p for i, p in plans.items() if self._takes(route, p)}
            for group in table_groups(taken):
                twin = None
                if self._pool is not None and not isinstance(group[0][1], str):
                    twin = self._pool.submit(
                        TWINS[route], [p for _, p in group])
                lane_jobs.append((route, group, twin))
        for i, data in enumerate(datas):
            self._engines(data, *out[i])
            if i not in plans:
                continue
            for route in ("k1", "k7", "corpus"):
                if route in self.routes and self._takes(route, plans[i]):
                    self._route(route, [i], out, lambda route=route: {
                        i: getattr(self, f"_{route}")(data, plans[i])})
        for route, group, twin in lane_jobs:
            idxs = [i for i, _ in group]
            if isinstance(group[0][1], str):  # refused before launch
                out[idxs[0]][0][route] = f"refused {group[0][1]}"
                self.taken[route] += 1
                continue
            fn = self._k3 if route == "k3" else self._k4
            self._route(route, idxs, out,
                        lambda fn=fn, group=group, twin=twin: fn(group, twin))
        return out

    @staticmethod
    def _guard(label, res, problems, fn):
        """``fn()``; an :class:`Unexpected` becomes a problem (None)."""
        try:
            return fn()
        except Unexpected as e:
            problems.append(f"UNEXPECTED {label}: {e}")
            res[label] = "X"
            return None

    def _engines(self, data, res, problems) -> None:
        """The JAX tool's check: the oracle and native engines agree
        (pixels, or both a ValueError)."""
        from jpeg_tpu_torch.models.decoder import decode_bytes

        eng = {e: self._guard(e, res, problems, lambda e=e: outcome(
            lambda: decode_bytes(data, engine=e, device=self.dev)))
            for e in ("oracle", "native")}
        res.update({e: brief(v) for e, v in eng.items() if v is not None})
        a, b = eng["oracle"], eng["native"]
        if a is None or b is None:
            return
        if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
            if not np.array_equal(a, b):
                problems.append("DIVERGE oracle vs native")
        elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            problems.append(f"ERRDIFF oracle {brief(a)} vs native {brief(b)}")

    def _route(self, route, idxs, out, fn) -> None:
        """Run ``fn`` (-> case -> (outcome, problems)) for cases ``idxs``,
        counting them as taken and, if the kernel's counter moved,
        launched. An exception out of the route itself (a launch or CUDA
        error, a twin that failed) is a problem of each of its cases."""
        self.taken[route] += len(idxs)
        before = self._launches(route)
        try:
            got = fn()
        except Exception as e:  # noqa: BLE001 — the fuzz's failure rule
            if not isinstance(e, Unexpected):
                traceback.print_exc(limit=5)
            for i in idxs:
                out[i][1].append(f"UNEXPECTED {route}: {type(e).__name__}: "
                                 f"{str(e)[:200]}")
                out[i][0][route] = "X"
            return
        finally:
            if self._launches(route) > before:
                self.launched[route] += len(idxs)
        for i, (shown, bad) in got.items():
            out[i][0][route] = shown
            out[i][1].extend(f"{route}: {p}" for p in bad)

    def _takes(self, route: str, plan) -> bool:
        from jpeg_tpu_torch.models.decoder import fast_path_takes

        if route == "k1":
            return fast_path_takes(plan)
        if route in ("k3", "k4"):
            return sequential_huffman(plan)
        if route == "k7":
            return sequential_huffman(plan) and covers(plan)
        return True  # the corpus decoder takes every stream

    def _k1(self, data, plan):
        from jpeg_tpu_torch.models.decoder import decode_bytes

        got = outcome(lambda: decode_bytes(data, path="fast", device=self.dev))
        want = outcome(lambda: decode_bytes(data, path="fast", device="cpu"))
        return brief(got), ([] if same(got, want) else
                            [f"device {brief(got)} vs cpu {brief(want)}"])

    def _k3(self, group, twin) -> dict:
        """K3 over a batch of equal-table plans, against its twin (``twin``,
        a future of :func:`twin_k3`; None: no twin) and each plan's C++
        coefficients."""
        from jpeg_tpu_torch.entropy import device_huffman as k3

        batch = k3.prepare_lane_batch([p for _, p in group])
        n = len(batch.lane_start)
        coeffs, err = k3.decode_lanes(k3.lane_tensors(batch, self.dev), n,
                                      batch.total_rows)
        coeffs, err = coeffs.cpu().numpy(), err.cpu().numpy()
        cp, ep = twin.result() if twin is not None else (None, None)
        got, lane0 = {}, 0
        for (case, plan), (first, rows) in zip(group, batch.images):
            ln = len(plan.segments)
            lanes = [(int(r0) - first, min(int(nb), first + rows - int(r0)))
                     for r0, nb in zip(batch.lane_out[lane0 : lane0 + ln],
                                       batch.lane_nblk[lane0 : lane0 + ln])]
            e = err[lane0 : lane0 + ln]
            got[case] = (f"{int(e.sum())}/{ln} lanes flagged", _lane_problems(
                "K3", e, None if ep is None else ep[lane0 : lane0 + ln],
                coeffs[first : first + rows],
                None if cp is None else cp[first : first + rows], lanes,
                cpp_coefficients(plan)))
            lane0 += ln
        return got

    def _k4(self, group, twin) -> dict:
        """K4 over a batch of equal-table plans (``kernel_runner_batch``),
        against its twin (``twin``, a future of :func:`twin_k4`; None: no
        twin) and each plan's C++ coefficients."""
        from jpeg_tpu_torch.entropy import device_kernel as k4

        plans = [p for _, p in group]
        runner = outcome(lambda: k4.kernel_runner_batch(plans, self.dev))
        if isinstance(runner, str):
            return {case: (f"refused {runner}", []) for case, _ in group}
        run, args, max_mcus, n, lane_base = runner
        out, err = run(*args)
        fk = lane_blocks(out.cpu().numpy())
        err = err[0].cpu().numpy()
        fp, err_p = twin.result() if twin is not None else (None, None)
        bpm = plans[0].blocks_per_mcu

        def rows(f, l0, segs):
            return None if f is None else np.concatenate(
                [f[l0 + j, : s.mcu_count * bpm] for j, s in enumerate(segs)])

        got = {}
        for (case, plan), l0 in zip(group, lane_base):
            segs = plan.segments
            lanes = [(s.mcu_start * bpm, s.mcu_count * bpm) for s in segs]
            e = err[l0 : l0 + len(segs)]
            got[case] = (f"{int(e.sum())}/{len(segs)} lanes flagged",
                         _lane_problems(
                             "K4", e, None if err_p is None
                             else err_p[l0 : l0 + len(segs)],
                             rows(fk, l0, segs), rows(fp, l0, segs), lanes,
                             cpp_coefficients(plan)))
        return got

    def _k7(self, data, plan):
        from jpeg_tpu_torch.entropy.device_spec import (
            decode_coefficients_device_spec,
        )

        ref = cpp_coefficients(plan)
        shown, bad = [], []
        for overlap in SPEC_OVERLAPS:
            got = outcome(lambda: decode_coefficients_device_spec(
                plan, SPEC_LANES, overlap, device=self.dev))
            coeffs = got if isinstance(got, str) else got[0]
            if coeffs is not None and not isinstance(coeffs, str):
                coeffs = coeffs.cpu().numpy()
            shown.append("merge failed" if coeffs is None else brief(coeffs))
            if isinstance(ref, np.ndarray):
                if not (isinstance(coeffs, np.ndarray)
                        and np.array_equal(coeffs, ref)):
                    bad.append(f"overlap {overlap}: {shown[-1]} where the C++ "
                               "decoder decodes"
                               + ("" if not isinstance(coeffs, np.ndarray)
                                  else " (coefficients differ)"))
            elif isinstance(coeffs, np.ndarray):
                bad.append(f"overlap {overlap}: decoded where the C++ decoder "
                           f"raised {ref}")
        return ", ".join(shown), bad

    def _corpus(self, data, plan):
        from jpeg_tpu_torch.entropy.device_huffman import prepare_lane_batch
        from jpeg_tpu_torch.models.decoder import decode_bytes
        from jpeg_tpu_torch.parallel.pipeline import BatchedCorpusDecoder

        if self._decoder is None:
            self._decoder = BatchedCorpusDecoder(
                hybrid_device=True, device_batch=CLAIM, device=self.dev)
            self._clean = self._clean_frames()
        clean, clean_rgb, clean_plan = self._clean
        n_clean = CLEAN_BEFORE + CLAIM - 1
        items = [clean[i % len(clean)] for i in range(CLEAN_BEFORE)] + [data] + [
            clean[i % len(clean)] for i in range(CLEAN_BEFORE, n_clean)]
        at = CLEAN_BEFORE
        try:
            res = self._decoder.decode_all(items)
        except RuntimeError as e:  # a kernel or CUDA failure escaped
            traceback.print_exc(limit=5)
            return "raised", [f"RuntimeError escaped decode_all: {e}"]
        routes = self._decoder.routes
        bad = []
        for i, r in enumerate(res):
            if i != at and not (r.ok and np.array_equal(
                    r.rgb, clean_rgb[(i - (i > at)) % len(clean)])):
                bad.append(f"clean frame {i} differs from its lone decode "
                           f"({r.error})")
                break
        want = outcome(lambda: decode_bytes(data, path="fast",
                                            device=self.dev))
        got = res[at].rgb if res[at].ok else res[at].error.split(":")[0]
        if not same(got, want):
            bad.append(f"case {brief(got)} vs decode_bytes {brief(want)}")
        claimed = routes[at] != "host" or routes[-1] != "host"
        if not claimed:
            kind = "host before claim"
        elif not BatchedCorpusDecoder._device_eligible(plan):
            kind = "not eligible"
        elif isinstance(outcome(lambda: prepare_lane_batch(
                [clean_plan, plan])), str) and routes[-1] == "fallback":
            kind = "BatchMismatch"
        else:
            kind = "K3 decoded" if routes[at] == "device" else "K3 flagged"
            self._corpus_k3 += 1
        self.claims[kind] = self.claims.get(kind, 0) + 1
        return kind, bad

    def _clean_frames(self):
        """The clean frames (two, alternating), their lone fast-path decodes
        on the device, and the first one's plan."""
        from jpeg_tpu_torch.bench import FRAMES_4K, SIZE_4K, restart_frame
        from jpeg_tpu_torch.io.container import parse_jpeg
        from jpeg_tpu_torch.models.decoder import decode_bytes

        fixtures = FRAMES_4K if self.clean_size == SIZE_4K else (None, None)
        clean = [restart_frame(self.clean_size, s, fixtures[s])
                 for s in (0, 1)]
        rgb = [decode_bytes(c, path="fast", device=self.dev) for c in clean]
        return clean, rgb, parse_jpeg(clean[0])


def run(lo: int, hi: int, device="cuda", routes=ROUTES,
        clean_size=(3840, 2160), twins: bool = True, out=print) -> dict:
    """Seeds ``[lo, hi)`` of every variant -> the summary record (``cases``,
    ``problems``, ``taken`` and ``launched`` per route, ``claims`` by
    outcome, ``unreached``: kernel routes that reached no case). ``twins``
    False holds K3 and K4 to the C++ decoder alone."""
    fuzz = Fuzz(device, routes, clean_size, twins)
    variants = make_variants()
    n_bad = cases = 0
    keys = [(v, s) for v in variants for s in range(lo, hi)]
    try:
        results = fuzz.cases([corrupt(v, variants[v], s) for v, s in keys])
    finally:
        fuzz.close()
    for (vname, s), (res, problems) in zip(keys, results):
        cases += 1
        n_bad += len(problems)
        out(json.dumps({"variant": vname, "seed": s, **res,
                        "problems": problems}))
    on_card = fuzz.dev.type == "cuda"
    reached = fuzz.launched if on_card else fuzz.taken
    unreached = [r for r in fuzz.routes if reached[r] == 0]
    return {"lo": lo, "hi": hi, "variants": len(variants), "cases": cases,
            "problems": n_bad, "taken": fuzz.taken,
            "launched": fuzz.launched if on_card else None,
            "claims": fuzz.claims, "unreached": unreached,
            "device": str(fuzz.dev)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m jpeg_tpu_torch.tools.fuzz",
        description=__doc__.split("\n\n")[0])
    p.add_argument("lo", nargs="?", type=int, default=0)
    p.add_argument("hi", nargs="?", type=int, default=40)
    p.add_argument("--routes", default=",".join(ROUTES),
                   help=f"comma-separated, of {ROUTES} (none: '')")
    p.add_argument("--clean-size", default="3840x2160",
                   help="the corpus route's clean frames, WxH")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain twins)")
    p.add_argument("--no-twins", dest="twins", action="store_false",
                   help="hold K3 and K4 to the C++ decoder alone, without "
                   "their plain twins (a memory-checking run of seeds "
                   "already compared with them)")
    args = p.parse_args(argv)
    routes = [r for r in args.routes.split(",") if r]
    if any(r not in ROUTES for r in routes):
        p.error(f"unknown route in {routes}; routes are {ROUTES}")
    from jpeg_tpu_torch.cli import _device

    dev = _device(args.device)  # no card is an error, not a CPU run
    summary = run(args.lo, args.hi, dev, routes,
                  tuple(int(x) for x in args.clean_size.split("x")),
                  args.twins, out=lambda line: print(line, flush=True))
    print(json.dumps(summary), flush=True)
    print(f"fuzz [{args.lo},{args.hi}) x {summary['variants']} variants: "
          f"{summary['problems']} problems"
          + (f"; routes that reached no case: {summary['unreached']}"
             if summary["unreached"] else ""), flush=True)
    return 1 if summary["problems"] or summary["unreached"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
