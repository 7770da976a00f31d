"""Interleaved same-process A/B of builds of the C++ entropy runtime: the
port's counterpart of the repo-root ``tools/ab_host_entropy.py``.

    python -m jpeg_tpu_torch.tools.ab_host_entropy NAME=DEFS [NAME=DEFS ...]
        [--rounds 5] [--size WxH]

    e.g. python -m jpeg_tpu_torch.tools.ab_host_entropy plain=""
         python -m jpeg_tpu_torch.tools.ab_host_entropy nopf="-DJT_NO_PREFETCH"

A host's rate drifts from minute to minute, so timing one build after
another cannot resolve a 5-15% change. This tool builds each ``NAME=DEFS``
variant of the runtime (the shipping compiler line plus ``DEFS``) as a
library of its own (``jpegtpu.ab_<NAME>``, hash-named in
``jpeg_tpu_torch/build/``), loads them all beside the shipping runtime (the
``shipping`` arm, as the JAX tool's first arm is the runtime it loads by
default), and alternates rounds arm by arm: per round, each arm's
``entropy_host_fps`` (the threaded plane decode of one frame) and
``entropy_corpus_fps`` (one single-threaded decode per worker, a worker per
core), the bench's rungs (``jpeg_tpu_torch.bench``), on the restart-per-row
frame (the committed 4K fixture at 3840x2160, else the port's encode at
``--size``). Medians across rounds cancel the drift; [min, max] shows what
is left. ``plain=""`` builds the shipping line again: an A/A that shows the
host's noise.

Prints one line per round and the medians with their spread, as the JAX
tool does. Host numbers: they time the CPU, not the card.
"""

from __future__ import annotations

import argparse
import statistics
import sys

SHIPPING = "shipping"


def build_variant(name: str, defs: str) -> str:
    """The runtime built with ``defs`` appended to the shipping compiler
    line, as the library ``jpegtpu.ab_<name>``; returns its path."""
    from jpeg_tpu_torch import runtime
    from jpeg_tpu_torch.utils.build import GXX_FLAGS, build_library

    return build_library(f"jpegtpu.ab_{name}",
                         ["g++", *GXX_FLAGS, *defs.split()],
                         [runtime.PORT_SOURCE], headers=(runtime.SOURCE,))


def parse_variant(text: str) -> tuple[str, str]:
    name, _, defs = text.partition("=")
    if not name or name == SHIPPING:
        raise ValueError(f"a variant is NAME=DEFS, NAME not {SHIPPING!r}: "
                         f"{text!r}")
    return name, defs.strip("'\"")


def ab(variants: list[tuple[str, str]], plan, rounds: int = 5,
       out=print) -> dict:
    """Alternate ``rounds`` rounds over the shipping runtime and
    ``variants`` on ``plan``. Returns per arm the rounds' rates and their
    medians: ``{arm: {"single": [...], "corpus": [...], "single_median",
    "corpus_median"}}``."""
    from concurrent.futures import ThreadPoolExecutor

    from jpeg_tpu_torch import bench, runtime
    from jpeg_tpu_torch.utils import build

    runtime.load()
    name = runtime.library_name()
    ship_path = build.loaded(name)[1]
    with ThreadPoolExecutor(max(1, len(variants))) as ex:
        paths = list(ex.map(lambda v: build_variant(*v), variants))
    arms = [(SHIPPING, ship_path)] + [
        (v, p) for (v, _), p in zip(variants, paths)]
    res = {arm: {"single": [], "corpus": []} for arm, _ in arms}
    try:
        for r in range(rounds):
            for arm, path in arms:
                build.use_library(name, path, runtime._configure)
                single, _ = bench.bench_host_entropy(plan, iters=2)  # touch
                single()
                single, _ = bench.bench_host_entropy(plan)
                corpus, _ = bench.bench_host_entropy_corpus(plan)
                res[arm]["single"].append(single()["entropy_host_fps"])
                res[arm]["corpus"].append(corpus()["entropy_corpus_fps"])
            out(f"round {r}: " + "  ".join(
                f"{arm} s={res[arm]['single'][-1]:.0f} "
                f"c={res[arm]['corpus'][-1]:.0f}" for arm, _ in arms))
    finally:
        build.use_library(name, ship_path, runtime._configure)
    out(f"medians over {rounds} interleaved rounds:")
    for arm, _ in arms:
        for kind in ("single", "corpus"):
            res[arm][f"{kind}_median"] = statistics.median(res[arm][kind])
        out(f"  {arm:10s} single {res[arm]['single_median']:6.1f} fps "
            f"[{min(res[arm]['single']):.1f}, {max(res[arm]['single']):.1f}]"
            f"   corpus {res[arm]['corpus_median']:6.1f} fps "
            f"[{min(res[arm]['corpus']):.1f}, {max(res[arm]['corpus']):.1f}]")
    return res


def verdict(res: dict, a: str, b: str, kind: str) -> str:
    """``a`` against ``b`` on ``kind``: the ratio of medians, and "no
    difference" when each median lies inside the other arm's [min, max]."""
    ra, rb = res[a][kind], res[b][kind]
    ma, mb = res[a][f"{kind}_median"], res[b][f"{kind}_median"]
    inside = min(rb) <= ma <= max(rb) or min(ra) <= mb <= max(ra)
    word = ("no difference" if inside
            else f"{a} {'faster' if ma > mb else 'slower'}")
    return f"{kind}: {a}/{b} = {ma / mb:.3f} ({word})"


def main(argv=None) -> int:
    from jpeg_tpu_torch.bench import _size

    ap = argparse.ArgumentParser(
        prog="python -m jpeg_tpu_torch.tools.ab_host_entropy",
        description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="+", type=parse_variant,
                    metavar="NAME=DEFS")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--size", type=_size, default=(3840, 2160))
    args = ap.parse_args(argv)

    from jpeg_tpu_torch import bench
    from jpeg_tpu_torch.io.container import parse_jpeg

    plan = parse_jpeg(bench.restart_frame(args.size, 0, bench.FRAMES_4K[0]))
    res = ab(args.variants, plan, args.rounds)
    for name, _ in args.variants:
        for kind in ("single", "corpus"):
            print(verdict(res, SHIPPING, name, kind))
    return 0


if __name__ == "__main__":
    sys.exit(main())
