"""The port's host tools (``jpeg_tpu_torch/tools/``) against the repo-root
``tools/`` they port, at small sizes:

- ``dump_scan`` / ``dump_prog`` write the files of ``tools/dump_scan.py`` /
  ``tools/dump_prog.py`` byte for byte (those run in one child process with
  ``JAX_PLATFORMS=cpu``);
- the four C++ microbenchmarks and the libjpeg harness equal their
  ``tools/`` sources but for the one ``#include`` line, build from the
  port's copy and run on dumped 512x384 streams;
- ``ab_host_entropy`` and every ``abench`` mode run and print their lines;
- ``arith_ref``: libjpeg's coefficients of the port's arithmetic streams
  and of the JAX package's libjpeg goldens equal the port's decode, and
  the port decodes libjpeg's own streams to libjpeg's pixels (PSNR as
  ``tests/test_arith.py`` holds the JAX package);
- the ASan sweep runs two seeds with no report;
- the two-sentinel harness patches a module's ``torch.empty`` and restores
  it (its check runs on the card: ``tests/test_torch_cuda.py``).
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from jpeg_tpu_torch import decode_bytes, encode_rgb
from jpeg_tpu_torch.io.container import parse_jpeg
from jpeg_tpu_torch.io.corpus import synthetic_image
from jpeg_tpu_torch.runtime import native_decode_arith_coefficients
from jpeg_tpu_torch.tools import (
    ab_host_entropy,
    abench,
    arith_ref,
    asan_sweep,
    dump_prog,
    dump_scan,
    microbench,
    sentinel,
)
from jpeg_tpu_torch.utils.build import BuildError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "goldens", "torch")
SMALL = "512x384"
# (dumper, case) -> a stream; the JAX tool of the same name dumps it too.
DUMPS = [("dump_scan", "restart"), ("dump_scan", "sof9"),
         ("dump_scan", "norestart"), ("dump_prog", "gray_prog"),
         ("dump_prog", "sof10")]
FILES = {"restart": "synth_512x384_s2_q85_rst1.jpg",
         "norestart": "synth_512x384_s3_q85_rst0.jpg",
         "gray_prog": "synth_512x384_s12_q85_rst0_gray_prog.jpg",
         "sof10": "synth_512x384_s7_q85_rst0_sof10.jpg"}
SOURCES = ["profile_entropy.cpp", "profile_prog.cpp", "profile_arith.cpp",
           "ab_qm_interleave.cpp", "jpeg_arith_ref.c"]
PORT_INCLUDE = '#include "../../runtime/native/jpegtpu.cpp"'
JAX_INCLUDE = '#include "../jpeg_tpu/runtime/native/jpegtpu.cpp"'


def psnr(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """case -> path of its stream."""
    d = tmp_path_factory.mktemp("streams")
    out = {k: os.path.join(FIXTURES, v) for k, v in FILES.items()}
    out["sof9"] = str(d / "sof9.jpg")
    with open(out["sof9"], "wb") as f:
        f.write(encode_rgb(synthetic_image(512, 384, 9), quality=85,
                           arithmetic=True, restart_interval_mcus=8))
    return out


@pytest.fixture(scope="module")
def jax_dumps(streams, tmp_path_factory):
    """(dumper, case) -> the directory the JAX tool dumped it into, all in
    one child process."""
    root = tmp_path_factory.mktemp("jax_dumps")
    dirs = {dc: str(root / f"{dc[0]}_{dc[1]}") for dc in DUMPS}
    code = ("import runpy, sys\n"
            f"for tool, path, out in {[(t, streams[c], dirs[(t, c)]) for t, c in DUMPS]!r}:\n"
            "    sys.argv = [tool, path, out]\n"
            "    runpy.run_path(f'tools/{tool}.py', run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={**os.environ, "JAX_PLATFORMS": "cpu"},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dirs


@pytest.mark.parametrize("tool,case", DUMPS)
def test_dumps_equal_the_jax_tools(jax_dumps, streams, tmp_path, tool, case):
    with open(streams[case], "rb") as f:
        {"dump_scan": dump_scan, "dump_prog": dump_prog}[tool].dump(
            f.read(), str(tmp_path))
    want = jax_dumps[(tool, case)]
    assert sorted(os.listdir(tmp_path)) == sorted(os.listdir(want))
    assert len(os.listdir(want)) >= 10
    for name in os.listdir(want):
        with open(tmp_path / name, "rb") as f, open(
                os.path.join(want, name), "rb") as g:
            assert f.read() == g.read(), name


def test_dump_prog_refuses_a_sequential_frame(streams, tmp_path):
    with open(streams["restart"], "rb") as f:
        with pytest.raises(ValueError, match="progressive"):
            dump_prog.dump(f.read(), str(tmp_path))


@pytest.mark.parametrize("name", SOURCES)
def test_sources_equal_the_tools_sources_but_the_include(name):
    with open(os.path.join(microbench.CSRC, name)) as f:
        port = f.read()
    with open(os.path.join(REPO, "tools", name)) as f:
        jax = f.read()
    if name.endswith(".cpp"):
        assert port.count(PORT_INCLUDE) == 1 and JAX_INCLUDE not in port
        port = port.replace(PORT_INCLUDE, JAX_INCLUDE)
    assert port == jax


@pytest.fixture(scope="module")
def micro():
    return microbench.microbench((512, 384), reps=1, decisions=100_000,
                                 out=lambda _: None)


@pytest.mark.parametrize("name,pattern", [
    ("profile_entropy", r"full prezero=2: +[\d.]+ ms"),
    ("profile_arith", r"arith 4-thread: +[\d.]+ ms"),
    ("profile_prog", r"sum of per-scan bests: [\d.]+ ms"),
    ("ab_qm_interleave", r"interleave gain: x2 [\d.]+, x4 [\d.]+")])
def test_microbenchmarks_build_from_the_port_and_run(micro, name, pattern):
    assert re.search(pattern, micro[name]), micro[name]
    with open(os.path.join(microbench.CSRC, f"{name}.cpp")) as f:
        assert PORT_INCLUDE in f.read()


def test_ab_host_entropy_runs_two_variants(capsys):
    assert ab_host_entropy.main(["plain=", "o2=-O2", "--rounds", "2",
                                 "--size", SMALL]) == 0
    out = capsys.readouterr().out
    assert len(re.findall(r"^round \d: shipping s=\d+ c=\d+  plain s=\d+ "
                          r"c=\d+  o2 s=\d+ c=\d+$", out, re.M)) == 2
    for arm in ("shipping", "plain", "o2"):
        assert re.search(rf"^  {arm} +single +[\d.]+ fps \[[\d.]+, [\d.]+\]",
                         out, re.M), out
    assert len(re.findall(r"^(single|corpus): shipping/(plain|o2) = [\d.]+ "
                          r"\(", out, re.M)) == 4


def test_ab_host_entropy_refuses_a_shipping_variant():
    with pytest.raises(ValueError):
        ab_host_entropy.parse_variant("shipping=-O2")


@pytest.fixture(scope="module")
def abench_cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("abench"))


@pytest.mark.parametrize("mode,line", [
    ("seq", "seq 1-thread"), ("corpus", f"corpus {os.cpu_count()}-worker"),
    ("spec", "spec no-restart"), ("arith", "arith 512x384"),
    ("prog", "prog 512x384")])
def test_abench_mode_prints_its_line(abench_cache, capsys, mode, line):
    assert abench.main([mode, "--size", SMALL, "--cache", abench_cache]) == 0
    out = capsys.readouterr().out.strip()
    assert re.fullmatch(rf"{line}: [\d.]+ fps median, [\d.]+ best", out), out
    assert any(f.startswith("abench_512x384_") for f in os.listdir(abench_cache))


@pytest.mark.parametrize("kind", ["color", "rst", "gray"])
def test_libjpeg_coefficients_equal_the_ports_on_its_streams(kind):
    img = synthetic_image(96, 64, 2)
    data = {"color": lambda: encode_rgb(img, quality=85, arithmetic=True),
            "rst": lambda: encode_rgb(img, quality=85, arithmetic=True,
                                      restart_interval_mcus=2),
            "gray": lambda: encode_rgb(img[..., 0].copy(), quality=85,
                                       grayscale=True, arithmetic=True)}[kind]()
    n, equal = arith_ref.check_port_stream(data)
    assert equal and n > 0


@pytest.mark.parametrize("kind", ["color", "rst", "gray"])
def test_harness_reads_the_jax_goldens_coefficients(kind):
    """The port's build of the harness dumps, from the JAX package's libjpeg
    goldens, the coefficients the original harness dumped into them; the
    port's decoder gives the same."""
    gold = np.load(os.path.join(REPO, "tests", "goldens", "arith_libjpeg.npz"))
    data = gold[f"{kind}_jpg"].tobytes()
    got = arith_ref.coefficients(data)
    mine = arith_ref.port_grids(parse_jpeg(data),
                                native_decode_arith_coefficients(
                                    parse_jpeg(data)))
    for ci, grid in enumerate(got):
        np.testing.assert_array_equal(grid, gold[f"{kind}_coef{ci}"])
        bh, bw = grid.shape[:2]
        np.testing.assert_array_equal(mine[ci][:bh, :bw], grid)
    assert f"{kind}_coef{len(got)}" not in gold


@pytest.mark.parametrize("progressive,restart_rows",
                         [(False, 0), (False, 1), (True, 0)])
def test_port_decodes_libjpegs_streams_to_its_pixels(progressive,
                                                     restart_rows):
    img = synthetic_image(96, 64, 4)
    data = arith_ref.encode(img, 85, progressive, restart_rows)
    plan = parse_jpeg(data)
    assert plan.arith_code and plan.progressive == progressive
    if not progressive:
        assert arith_ref.check_port_stream(data)[1]
    want = arith_ref.decode(data)
    got = np.asarray(decode_bytes(data, rounding="round", device="cpu"))
    assert got.shape == want.shape
    assert psnr(got, want) > 40.0


def test_harness_without_jpeglib_h_raises(monkeypatch):
    monkeypatch.setattr(arith_ref, "find_header", lambda: None)
    with pytest.raises(BuildError, match="jpeglib.h"):
        arith_ref.build()


def test_asan_sweep_two_seeds_report_nothing():
    summary = asan_sweep.sweep(0, 1, out=print)
    assert summary["ok"], summary
    assert summary["asan_reports"] == 0 and summary["cases"] == 40
    assert summary["calls"] > summary["cases"] and summary["encodes"] > 0


def test_sentinel_patch_fills_empty_and_restores():
    from jpeg_tpu_torch.entropy import device_huffman

    for byte in sentinel.SENTINELS:
        with sentinel.filled_empty([device_huffman], byte):
            x = device_huffman.torch.empty((3, 5), dtype=torch.int32)
            assert device_huffman.torch.zeros is torch.zeros
        assert (x.view(torch.uint8) == byte).all()
    assert device_huffman.torch is torch


def test_sentinel_check_counts_launches_without_resetting(monkeypatch):
    """The check runs each case once per sentinel and reports the launches
    it made, leaving the caller's running count of the kernel intact."""
    from jpeg_tpu_torch.entropy import device_huffman

    def fake_k3(plan, dev):
        device_huffman.LAUNCHES.add()
        x = np.full(3, device_huffman.torch.empty(1).numel())
        return [x], [x]

    monkeypatch.setattr(sentinel, "damaged_plans",
                        lambda seeds: [("a/0", None), ("b/0", None)])
    monkeypatch.setattr(sentinel, "_k3", fake_k3)
    device_huffman.LAUNCHES.reset()
    device_huffman.LAUNCHES.add()
    rec = sentinel.check("cpu", [0], ("K3",))["K3"]
    assert rec == {"cases": 2, "read_differ": [], "unread_differ": [],
                   "launches": 4}
    assert device_huffman.LAUNCHES.value == 5
    device_huffman.LAUNCHES.reset()
