"""The port's corrupt-stream fuzz (``jpeg_tpu_torch/tools/fuzz.py``)
against the repo-root ``tools/fuzz.py``, which is read as source: the JAX
tool runs its fuzz when imported, so the test executes only its statements
that build the stream variants and, per case, corrupt a stream.

- the 20 variants are byte-identical to the bytes the JAX tool's own code
  makes with the JAX package's encoders and Pillow (so the five committed
  libjpeg files equal what Pillow writes here), and the port's CMYK input
  equals Pillow's ``convert("CMYK")``;
- seeds 0-3 of every variant corrupt to the JAX recipe's bytes;
- each such case decodes on ``device="cpu"`` to the JAX package's outcome
  on both engines and on the fast path: the same pixels, or the same
  exception class;
- a small fuzz corpus through the port's ``BatchedCorpusDecoder`` on the CPU
  (its device thread claiming, K3's twin decoding) gives each image the JAX
  ``BatchedCorpusDecoder``'s outcome;
- the tool's routes run on the CPU without a problem, and its command line
  prints its summary.
"""

import ast
import json
import os

import numpy as np
import pytest

import jpeg_tpu
from jpeg_tpu.parallel.pipeline import BatchedCorpusDecoder as RefCorpusDecoder
from jpeg_tpu_torch.io.container import parse_jpeg
from jpeg_tpu_torch.models.decoder import decode_bytes
from jpeg_tpu_torch.parallel.pipeline import BatchedCorpusDecoder
from jpeg_tpu_torch.tools import fuzz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOL = os.path.join(REPO, "tools", "fuzz.py")
SEEDS = range(4)


def _jax_tool():
    """(the JAX tool's variants dict, its per-case corruption as a function
    of (name, data, seed)), executed from its own statements."""
    tree = ast.parse(open(JAX_TOOL).read())
    body = [n for n in tree.body
            if not (isinstance(n, ast.Expr) and isinstance(n.value, ast.Constant))]
    at = next(i for i, n in enumerate(body) if isinstance(n, ast.Assign)
              and getattr(n.targets[0], "id", None) == "variants")
    env = {"__file__": JAX_TOOL, "__name__": "jax_fuzz"}
    exec(compile(ast.Module(body[: at + 1], []), JAX_TOOL, "exec"), env)
    # The case loop: `for vname, data in ...: for s in ...: <recipe>; res = {}`.
    outer = next(n for n in body if isinstance(n, ast.For))
    inner = next(n for n in outer.body if isinstance(n, ast.For))
    stop = next(i for i, n in enumerate(inner.body) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "res")
    recipe = compile(ast.Module(inner.body[:stop], []), JAX_TOOL, "exec")

    def corrupt(vname, data, s):
        scope = {"np": np, "vname": vname, "data": data, "s": s}
        exec(recipe, scope)
        return bytes(scope["d"])

    return env["variants"], corrupt


@pytest.fixture(scope="module")
def jax_tool():
    return _jax_tool()


@pytest.fixture(scope="module")
def variants():
    return fuzz.make_variants()


def test_the_jax_tool_has_twenty_variants(jax_tool):
    """Its docstring says 16 and tools/README.md 19; its dict holds 20."""
    assert list(jax_tool[0]) == list(fuzz.VARIANTS)
    assert len(fuzz.VARIANTS) == 20


@pytest.mark.parametrize("name", fuzz.VARIANTS)
def test_variant_bytes_match_the_jax_tool(jax_tool, variants, name):
    assert variants[name] == jax_tool[0][name]


def test_cmyk_input_is_pillows_conversion():
    from PIL import Image

    from jpeg_tpu_torch.io.corpus import synthetic_image

    img = synthetic_image(*fuzz.SIZE, seed=1)
    np.testing.assert_array_equal(
        fuzz.rgb_to_cmyk(img), np.asarray(Image.fromarray(img).convert("CMYK")))


@pytest.mark.parametrize("name", fuzz.VARIANTS)
def test_corruption_matches_the_jax_recipe(jax_tool, variants, name):
    for s in SEEDS:
        assert fuzz.corrupt(name, variants[name], s) == jax_tool[1](
            name, variants[name], s)


def _outcome(fn):
    try:
        return np.asarray(fn())
    except ValueError as e:
        return type(e).__name__


def _same_outcome(got, want, lossless: bool) -> None:
    """Pixels bit for bit (u8), within 1 at 12 bits (the compat route's
    fp32 sums run in another order in torch than in XLA: 3 of the 320
    outcomes of seeds 0-3 differ, each by 1 on 1-2 values); else the same
    exception class. A lossless stream's differences decode in C++ in the
    port and in Python in the JAX compat route (ROADMAP queue 3, "Lossless
    routing"), so there both raise a ValueError, of their own class."""
    if isinstance(want, str) or isinstance(got, str):
        assert isinstance(got, str) and isinstance(want, str)
        assert lossless or got == want
        return
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == np.uint8:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got.astype(np.int64) - want.astype(np.int64)).max() <= 1


@pytest.mark.parametrize("name", fuzz.VARIANTS)
def test_case_outcomes_match_the_jax_package(variants, name):
    for s in SEEDS:
        data = fuzz.corrupt(name, variants[name], s)
        lossless = name == "lossless"
        for engine in ("oracle", "native"):
            _same_outcome(
                _outcome(lambda: decode_bytes(data, engine=engine,
                                              device="cpu")),
                _outcome(lambda: jpeg_tpu.decode_bytes(data, engine=engine)),
                lossless)
        _same_outcome(
            _outcome(lambda: decode_bytes(data, path="fast", device="cpu")),
            _outcome(lambda: jpeg_tpu.decode_bytes(data, path="fast")),
            lossless)


def _corpus(variants):
    """Cases of the restart variant (which the device route takes) and of
    three it does not, between clean restart frames of the same tables."""
    from jpeg_tpu_torch.bench import restart_frame

    clean = [restart_frame((128, 64), s) for s in (0, 1)]
    cases = [fuzz.corrupt(v, variants[v], s)
             for v in ("rst", "base", "prog", "cmyk_ours") for s in SEEDS]
    return [clean[i % 2] for i in range(24)] + cases + [
        clean[i % 2] for i in range(8)]


def test_fuzz_corpus_outcomes_match_the_jax_decoder(variants):
    items = _corpus(variants)
    dec = BatchedCorpusDecoder(hybrid_device=True, device_batch=8,
                               device="cpu")
    got = dec.decode_all(items)
    routes = dec.routes
    dec.close()
    ref = RefCorpusDecoder().decode_all(items)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.ok == r.ok, (i, g.error, r.error)
        if g.ok:
            np.testing.assert_array_equal(g.rgb, r.rgb)
        else:
            assert g.error.split(":")[0] == r.error.split(":")[0]
    # The device thread claimed from the back; K3's twin decoded frames.
    assert len(routes) == len(items) and "device" in routes
    assert set(routes) <= {"host", "device", "fallback"}


def test_routes_on_the_cpu(variants):
    """Every route's checks on a few cases: restart lanes (K3, K4 in one
    batch of equal tables, K7), the fast path and a claim."""
    cases = [fuzz.corrupt("rst", variants["rst"], s) for s in (1, 2)] + [
        variants["rst"], fuzz.corrupt("prog", variants["prog"], 0)]
    f = fuzz.Fuzz("cpu", clean_size=(128, 64))
    try:
        out = f.cases(cases)
    finally:
        f.close()
    for res, problems in out:
        assert problems == [], problems
    plans = [fuzz.outcome(lambda d=d: parse_jpeg(d)) for d in cases]
    lanes = sum(not isinstance(p, str) and fuzz.sequential_huffman(p)
                for p in plans)
    assert f.taken["k3"] == f.taken["k4"] == lanes >= 2
    assert f.taken["corpus"] == sum(not isinstance(p, str) for p in plans)
    assert out[2][0]["k7"] == "ok, ok"  # the clean stream merges
    assert f.claims.get("K3 decoded", 0) >= 1


def test_command_line_summary(capsys):
    assert fuzz.main(["0", "1", "--routes", "", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "fuzz [0,1) x 20 variants: 0 problems"
    summary = json.loads(lines[-2])
    assert summary["cases"] == 20 and summary["problems"] == 0
    assert [json.loads(ln)["variant"] for ln in lines[:-2]] == list(
        fuzz.VARIANTS)


def test_committed_libjpeg_streams_name_their_writer():
    with open(os.path.join(fuzz.STREAM_DIR, "README.md")) as f:
        text = f.read()
    import PIL

    assert f"Pillow {PIL.__version__}" in text
