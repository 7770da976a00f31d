"""The port's approx quality tool (``jpeg_tpu_torch/tools/
measure_approx_quality.py``) against the repo-root
``tools/measure_approx_quality.py``, which is read with ``ast`` and never
run (it needs a TPU and Pillow):

- the port's cases have the JAX tool's names, sizes, qualities, samplings,
  seeds and restart layout, and its reference files are the JAX tool's;
- each case's stream has that geometry, and the gray case's luma is
  Pillow's ``convert("L")``;
- at small sizes each case's stream is, byte for byte, the JAX package's
  ``encode_rgb`` of its own ``synthetic_image`` (the gray case through
  Pillow's ``convert("L")``), and the two decodes ``one()`` makes hold to
  the JAX package's ``decode_plan_fast`` (Pallas interpret): the exact
  one within +-1 u8 on under 5% of the values, the approx one within the
  approx gate;
- ``one()`` equals an exact-vs-approx comparison made here through
  ``decode_plan_fast(device="cpu")`` at small sizes; K1a's plain twin
  rounds to bf16, so the differences are not zero;
- ``main`` at small sizes prints the JAX tool's rows, and a gate miss or a
  missing card exits non-zero.
"""

import ast
import inspect
import os

import numpy as np
import pytest
import torch
from conftest import REFERENCE
from PIL import Image

from jpeg_tpu.io import corpus as jax_corpus
from jpeg_tpu.io.container import parse_jpeg as ref_parse
from jpeg_tpu.models import decoder as ref_dec
from jpeg_tpu.models.encoder import encode_rgb as ref_encode_rgb
from jpeg_tpu_torch.io.container import parse_jpeg
from jpeg_tpu_torch.models import decoder as port_dec
from jpeg_tpu_torch.io.corpus import synthetic_image
from jpeg_tpu_torch.models.decoder import decode_plan_fast
from jpeg_tpu_torch.tools import measure_approx_quality as maq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOL = os.path.join(REPO, "tools", "measure_approx_quality.py")
SMALL = {3840: (64, 48), 1920: (48, 32)}


def small_cases():
    return tuple((c[0], *SMALL[c[1]], *c[3:]) for c in maq.CASES)


def _kw(call, name, default=None):
    for k in call.keywords:
        if k.arg == name:
            return ast.literal_eval(k.value)
    return default


def jax_cases() -> list[tuple]:
    """The JAX tool's synthetic cases, as the port's CASES tuples."""
    main = next(n for n in ast.parse(open(JAX_TOOL).read()).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    defaults = inspect.signature(jax_corpus.synthetic_jpeg).parameters
    loop_q = next(ast.literal_eval(n.iter) for n in ast.walk(main)
                  if isinstance(n, ast.For) and n.target.id == "q")
    calls = sorted((n for n in ast.walk(main) if isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)),
                   key=lambda n: (n.lineno, n.col_offset))
    # Pillow re-encodes, in order: (sampling, quality).
    saves = [("gray" if isinstance(c.func.value, ast.Call)
              and c.func.value.func.attr == "convert" else
              {0: "4:4:4"}.get(_kw(c, "subsampling"), "4:2:0"),
              _kw(c, "quality")) for c in calls if c.func.attr == "save"]
    out, content = [], None
    for c in calls:
        if c.func.attr != "append" or not isinstance(c.args[0], ast.Tuple):
            continue
        name, stream = c.args[0].elts
        if getattr(stream.func, "id", None) == "synthetic_jpeg":
            w, h = (ast.literal_eval(a) for a in stream.args)
            seed = _kw(stream, "seed")
            restart = _kw(stream, "restart_rows",
                          defaults["restart_rows"].default) == 1
            if isinstance(name, ast.JoinedStr):  # for q in (...): quality=q
                out += [(name.values[0].value + str(q), w, h, q, "4:2:0",
                         seed, restart) for q in loop_q]
            else:
                out.append((name.value, w, h, _kw(
                    stream, "quality", defaults["quality"].default), "4:2:0",
                            seed, restart))
            content = out[-1]
        elif getattr(stream.func, "attr", None) == "getvalue":
            # A Pillow re-encode of the last synthetic case: no restarts.
            sampling, quality = saves.pop(0)
            out.append((name.value, content[1], content[2], quality,
                        sampling, content[5], False))
    return out


def test_cases_are_the_jax_tools():
    want = jax_cases()
    assert len(want) == 6 and want[0][0] == "synthetic 4K q70"
    assert list(maq.CASES) == want


def test_reference_files_are_the_jax_tools():
    paths = [n.value for n in ast.walk(ast.parse(open(JAX_TOOL).read()))
             if isinstance(n, ast.Constant) and isinstance(n.value, str)
             and n.value.startswith(REFERENCE + "/")]
    assert paths == [f"{REFERENCE}/{rel}" for rel in maq.REFERENCE_FILES]


@pytest.mark.parametrize("case", maq.CASES, ids=[c[0] for c in maq.CASES])
def test_case_stream_geometry(case):
    name, w, h, quality, sampling, seed, restart = case
    plan = parse_jpeg(maq.case_stream(case))
    assert (plan.width, plan.height) == (w, h)
    comps = [(c.h, c.v) for c in plan.components]
    assert comps == {"gray": [(1, 1)], "4:4:4": [(1, 1)] * 3,
                     "4:2:0": [(2, 2), (1, 1), (1, 1)]}[sampling]
    assert plan.restart_interval == (plan.mcus_x if restart else 0)
    if restart:
        assert len(plan.segments) == plan.mcus_y


def test_gray_luma_is_pillows():
    img = synthetic_image(96, 64, seed=1)
    want = np.asarray(Image.fromarray(img).convert("L"))
    np.testing.assert_array_equal(maq.luma(img), want)


def jax_stream(case) -> bytes:
    """A case encoded by the JAX package from its own ``synthetic_image``."""
    _, w, h, quality, sampling, seed, restart = case
    img = jax_corpus.synthetic_image(w, h, seed)
    if sampling == "gray":
        gray = np.asarray(Image.fromarray(img).convert("L"))
        return ref_encode_rgb(gray, quality=quality, grayscale=True)
    sub = {"4:2:0": (2, 2), "4:4:4": (1, 1)}[sampling]
    return ref_encode_rgb(img, quality=quality, subsampling=sub,
                          restart_interval_mcus=(-(-w // (8 * sub[0]))
                                                 if restart else 0))


@pytest.mark.parametrize("case", small_cases(), ids=[c[0] for c in maq.CASES])
def test_case_stream_equals_jax_encoder(case):
    assert maq.case_stream(case) == jax_stream(case)


@pytest.mark.parametrize("case", small_cases(), ids=[c[0] for c in maq.CASES])
def test_one_decodes_match_the_jax_package(case, monkeypatch):
    data = maq.case_stream(case)
    seen = {}
    real = port_dec.decode_plan_fast

    def record(plan, *args, idct_mode="exact", **kwargs):
        seen[idct_mode] = real(plan, *args, idct_mode=idct_mode, **kwargs)
        return seen[idct_mode]

    monkeypatch.setattr(port_dec, "decode_plan_fast", record)
    maq.one(case[0], data, "cpu")
    want = np.asarray(ref_dec.decode_plan_fast(ref_parse(data)))
    assert seen["exact"].shape == want.shape == (case[2], case[1], 3)
    diff = np.abs(seen["exact"].astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.05
    diff = np.abs(seen["approx"].astype(int) - want.astype(int))
    mse = float((diff.astype(np.float64) ** 2).mean())
    assert diff.max() <= maq.MAX_DIFF
    assert mse == 0 or 10 * np.log10(255.0**2 / mse) >= maq.MIN_PSNR


@pytest.mark.parametrize("case", small_cases(), ids=[c[0] for c in maq.CASES])
def test_one_equals_exact_vs_approx_on_cpu(case, capsys):
    data = maq.case_stream(case)
    d, p = maq.one(case[0], data, "cpu")
    plan = parse_jpeg(data)
    exact = torch.from_numpy(decode_plan_fast(plan, device="cpu")).double()
    approx = torch.from_numpy(decode_plan_fast(
        plan, device="cpu", idct_mode="approx")).double()
    diff = approx - exact
    mse = float(torch.mean(diff * diff))
    assert d == int(diff.abs().max()) and d > 0
    assert p == pytest.approx(20 * np.log10(255.0) - 10 * np.log10(mse),
                              rel=1e-9)
    row = capsys.readouterr().out.strip()
    assert row == f"| {case[0]} | {case[1]}x{case[2]} | {d} | {p:.1f} |"


def test_main_at_small_sizes(tmp_path, monkeypatch, capsys):
    small = small_cases()
    monkeypatch.setattr(maq, "CASES", small)
    ref = tmp_path / "reference"
    os.makedirs(ref)
    (ref / "lena.jpeg").write_bytes(maq.case_stream(small[1]))
    assert maq.main(["--device", "cpu", "--reference", str(ref)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("skipped: ") for line in out) == 3
    rows = [line for line in out if line.startswith("| ")]
    assert rows[0] == "| stream | size | max diff (u8) | PSNR vs exact (dB) |"
    assert [r.split(" | ")[0][2:] for r in rows[1:]] == \
        ["lena.jpeg"] + [c[0] for c in maq.CASES]
    assert out[-1].startswith("worst-case: max diff ")


def test_gate_miss_exits_nonzero(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(maq, "CASES", small_cases()[:1])
    monkeypatch.setattr(maq, "one", lambda name, data, device: (3, 48.0))
    assert maq.main(["--device", "cpu", "--reference", str(tmp_path)]) == 1
    assert "FAILS the gate" in capsys.readouterr().out


def test_no_card_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        maq.main([])
