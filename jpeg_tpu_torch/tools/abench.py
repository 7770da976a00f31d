"""Quick host-entropy A/B harness: the port's counterpart of the repo-root
``tools/abench.py`` (not part of the bench), with its modes and lines.

    python -m jpeg_tpu_torch.tools.abench [MODE ...] [--size WxH]
        [--cache DIR]

Modes (default ``seq``):

- ``seq``: the restart-per-row frame, one thread (the corpus decoder's
  rate per core);
- ``corpus``: the same frame, one single-threaded decode per worker, a
  worker per host core (as the bench's ``entropy_corpus_fps``);
- ``spec``: the frame without restart markers, speculative, every thread
  (``4 * threads`` chunks);
- ``arith``: the arithmetic (SOF9) frame, a restart every 16 MCUs, every
  thread;
- ``prog``: the progressive frame, every thread.

Each prints ``<what>: <median> fps median, <best> best`` over five timed
runs after a warm-up, as the JAX tool does. Its inputs come from the bench's
stream functions (``jpeg_tpu_torch.bench``; the JAX tool writes some with
PIL, which the card's machine lacks) at ``--size`` (default 3840x2160: the
committed restart-per-row and progressive fixtures, the port's encodes of
``synthetic_image(3840, 2160, 0)`` for the others), written once to
``--cache`` (default: a temporary directory) and read back. Host numbers:
they time the CPU, not the card.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import tempfile
import time

MODES = ("seq", "corpus", "spec", "arith", "prog")


def timeit(fn, iters: int, reps: int = 5) -> tuple[float, float]:
    """(median, best) calls/s of ``fn`` over ``reps`` runs of ``iters``
    calls, after one untimed call."""
    fn()
    rates = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        rates.append(iters / (time.perf_counter() - t0))
    return statistics.median(rates), max(rates)


class Streams:
    """The modes' streams at ``size``, made once into ``cache``."""

    def __init__(self, size: tuple[int, int], cache: str):
        self.size, self.cache = size, cache

    def get(self, name: str) -> bytes:
        path = os.path.join(self.cache, f"abench_{self.size[0]}x"
                            f"{self.size[1]}_{name}.jpg")
        if not os.path.exists(path):
            tmp = f"{path}.tmp{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(self._make(name))
            os.replace(tmp, path)
        with open(path, "rb") as f:
            return f.read()

    def _make(self, name: str) -> bytes:
        from jpeg_tpu_torch import bench
        from jpeg_tpu_torch.io.corpus import synthetic_image

        if name == "4k":
            return bench.restart_frame(self.size, 0, bench.FRAMES_4K[0])
        if name == "prog":
            return bench.progressive_stream(self.size)
        img = synthetic_image(*self.size, 0)
        if name == "nr":
            return bench.norestart_stream(img)
        return bench.arithmetic_stream(img)


def run(modes, size=(3840, 2160), cache: str | None = None,
        out=print) -> dict:
    """Run ``modes``; returns ``{mode: (median, best)}`` frames/s."""
    from concurrent.futures import ThreadPoolExecutor

    from jpeg_tpu_torch import runtime
    from jpeg_tpu_torch.io.container import parse_jpeg

    unknown = set(modes) - set(MODES)
    if unknown:
        raise ValueError(f"unknown modes {sorted(unknown)}; modes: {MODES}")
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        streams = Streams(size, cache or tmp)
        if "seq" in modes:
            plan = parse_jpeg(streams.get("4k"))
            med, best = timeit(lambda: runtime.native_decode_planes(
                plan, n_threads=1), 6)
            res["seq"] = (med, best)
            out(f"seq 1-thread: {med:.1f} fps median, {best:.1f} best")
        if "corpus" in modes:
            plan = parse_jpeg(streams.get("4k"))
            n = os.cpu_count() or 1
            with ThreadPoolExecutor(max_workers=n) as ex:
                def one():
                    list(ex.map(lambda _: runtime.native_decode_planes(
                        plan, n_threads=1), range(n)))

                med, best = timeit(one, 6)
            res["corpus"] = (med * n, best * n)
            out(f"corpus {n}-worker: {med * n:.1f} fps median, "
                f"{best * n:.1f} best")
        if "spec" in modes:
            plan = parse_jpeg(streams.get("nr"))
            med, best = timeit(lambda: runtime.native_decode_planes(plan), 6)
            res["spec"] = (med, best)
            out(f"spec no-restart: {med:.1f} fps median, {best:.1f} best")
        if "arith" in modes:
            plan = parse_jpeg(streams.get("arith"))
            med, best = timeit(lambda: runtime.native_decode_arith_planes(
                plan), 6)
            res["arith"] = (med, best)
            out(f"arith {_tag(size)}: {med:.1f} fps median, {best:.1f} best")
        if "prog" in modes:
            plan = parse_jpeg(streams.get("prog"))
            med, best = timeit(lambda: runtime.native_decode_progressive(
                plan, reuse_buffer=True), 4)
            res["prog"] = (med, best)
            out(f"prog {_tag(size)}: {med:.1f} fps median, {best:.1f} best")
    return res


def _tag(size) -> str:
    return "4K" if tuple(size) == (3840, 2160) else f"{size[0]}x{size[1]}"


def main(argv=None) -> int:
    from jpeg_tpu_torch.bench import _size

    ap = argparse.ArgumentParser(prog="python -m jpeg_tpu_torch.tools.abench",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("modes", nargs="*", choices=MODES, metavar="MODE",
                    help=f"any of {', '.join(MODES)} (default seq)")
    ap.add_argument("--size", type=_size, default=(3840, 2160))
    ap.add_argument("--cache", default=None,
                    help="where the streams are written once and reused "
                         "(default: a temporary directory)")
    args = ap.parse_args(argv)
    run(args.modes or ["seq"], args.size, args.cache)
    return 0


if __name__ == "__main__":
    sys.exit(main())
