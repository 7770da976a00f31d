"""jpeg_tpu_torch host layer: parse parity with jpeg_tpu field by field,
plan_from_reference, the C++ runtime binding, and the import guard (the
port never loads jax)."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from jpeg_tpu.io.container import parse_jpeg as ref_parse
from jpeg_tpu.models.encoder import encode_rgb
from jpeg_tpu.runtime import native_decode_planes as ref_planes
from jpeg_tpu_torch.io.container import (
    DecodePlan,
    JPEGError,
    parse_jpeg,
    plan_from_reference,
)
from jpeg_tpu_torch.runtime import native_decode_planes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "goldens", "torch")


def _fixture(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def _stream(kind: str) -> bytes:
    rng = np.random.default_rng(sum(map(ord, kind)))
    img = rng.integers(0, 256, (80, 96, 3), dtype=np.uint8)
    if kind == "gray":
        return encode_rgb(img[..., 0], quality=85, grayscale=True,
                          restart_interval_mcus=4)
    if kind == "optimize":
        return encode_rgb(img, quality=92, subsampling=(2, 2),
                          restart_interval_mcus=3, optimize=True,
                          comment="port parity")
    if kind == "no_restart":
        return encode_rgb(img, quality=75, subsampling=(2, 1))
    if kind == "4k":
        return _fixture("synth_3840x2160_s0_q85_rst1.jpg")
    return encode_rgb(img, quality=85, subsampling=(1, 2),
                      restart_interval_mcus=5)


KINDS = ["gray", "optimize", "no_restart", "4k", "restart_1x2"]


def _assert_same_value(a, b, where):
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _assert_same_value(getattr(a, f.name), getattr(b, f.name),
                               f"{where}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_value(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def assert_plans_equal(port: DecodePlan, ref) -> None:
    """Every DecodePlan field equal, recursing into tables and segments."""
    names = [f.name for f in dataclasses.fields(DecodePlan)]
    assert names == [f.name for f in dataclasses.fields(type(ref))]
    for name in names:
        _assert_same_value(getattr(port, name), getattr(ref, name), name)
    assert port.color_model == ref.color_model
    assert port.total_blocks == ref.total_blocks


@pytest.mark.parametrize("kind", KINDS)
def test_parse_matches_reference_field_by_field(kind):
    data = _stream(kind)
    assert_plans_equal(parse_jpeg(data), ref_parse(data))


@pytest.mark.parametrize("kind", KINDS)
def test_plan_from_reference_round_trips(kind):
    data = _stream(kind)
    ref = ref_parse(data)
    converted = plan_from_reference(ref)
    assert isinstance(converted, DecodePlan)
    assert_plans_equal(converted, ref)
    assert_plans_equal(converted, parse_jpeg(data))


def test_plan_from_reference_progressive():
    import io

    from PIL import Image

    from jpeg_tpu.io.corpus import synthetic_image

    buf = io.BytesIO()
    Image.fromarray(synthetic_image(64, 48, seed=9)).save(
        buf, "JPEG", quality=80, progressive=True)
    ref = ref_parse(buf.getvalue())
    assert ref.progressive and ref.prog_scans
    assert_plans_equal(plan_from_reference(ref), ref)
    assert_plans_equal(parse_jpeg(buf.getvalue()), ref)


def test_parse_errors_match_reference():
    for bad in (b"not a jpeg", _stream("gray")[:40]):
        with pytest.raises(JPEGError) as port_err:
            parse_jpeg(bad)
        from jpeg_tpu.io.container import JPEGError as RefError

        with pytest.raises(RefError) as ref_err:
            ref_parse(bad)
        assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("kind", ["gray", "optimize", "no_restart",
                                  "restart_1x2", "4k"])
def test_native_planes_match_reference(kind):
    """The port's binding of the C++ runtime == jpeg_tpu's, exactly."""
    data = _stream(kind)
    got = native_decode_planes(parse_jpeg(data), reuse_buffer=False)
    want = ref_planes(ref_parse(data), reuse_buffer=False)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.int16
        np.testing.assert_array_equal(g, w)


def test_native_speculative_single_segment_matches_reference():
    """A >= 64 KB single-segment scan takes the speculative path when the
    decode is multi-threaded; it must equal the sequential decode."""
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (256, 320, 3), dtype=np.uint8)
    data = encode_rgb(img, quality=95, subsampling=(2, 2))
    plan = parse_jpeg(data)
    assert len(plan.segments) == 1 and len(plan.scan_data) >= 65536
    spec = native_decode_planes(plan, n_threads=4, reuse_buffer=False)
    seq = native_decode_planes(plan, n_threads=1, reuse_buffer=False)
    want = ref_planes(ref_parse(data), n_threads=1, reuse_buffer=False)
    for a, b, w in zip(spec, seq, want):
        np.testing.assert_array_equal(a, w)
        np.testing.assert_array_equal(b, w)


def test_native_reused_buffers_are_rezeroed():
    """A thread's reused planes must not keep the previous frame's blocks."""
    a = parse_jpeg(_stream("restart_1x2"))
    first = [p.copy() for p in native_decode_planes(a, n_threads=1)]
    native_decode_planes(parse_jpeg(encode_rgb(
        np.zeros((80, 96, 3), np.uint8), quality=85, subsampling=(1, 2),
        restart_interval_mcus=5)), n_threads=1)
    again = native_decode_planes(a, n_threads=1)
    for f, g in zip(first, again):
        np.testing.assert_array_equal(f, g)


def test_import_never_loads_jax():
    code = ("import sys; import jpeg_tpu_torch; "
            "import jpeg_tpu_torch.parallel.pipeline; "
            "import jpeg_tpu_torch.entropy.device_huffman; "
            "import jpeg_tpu_torch.entropy.device_window; "
            "import jpeg_tpu_torch.entropy.device_kernel; "
            "import jpeg_tpu_torch.entropy.device_spec; "
            "import jpeg_tpu_torch.ops.idct_only; "
            "import jpeg_tpu_torch.bench; "
            "import jpeg_tpu_torch.tools.endurance; "
            "import jpeg_tpu_torch.tools.measure_approx_quality; "
            "import jpeg_tpu_torch.tools.ab_host_entropy; "
            "import jpeg_tpu_torch.tools.abench; "
            "import jpeg_tpu_torch.tools.dump_scan; "
            "import jpeg_tpu_torch.tools.dump_prog; "
            "import jpeg_tpu_torch.tools.microbench; "
            "import jpeg_tpu_torch.tools.arith_ref; "
            "import jpeg_tpu_torch.tools.asan_sweep; "
            "import jpeg_tpu_torch.tools.sentinel; "
            "from jpeg_tpu_torch import runtime; runtime.load(); "
            "assert runtime.pgo_status() == 'off'; "
            "assert runtime.spec_tuner_snapshot() == {}; "
            "assert 'jax' not in sys.modules, 'jax loaded'; "
            "assert 'jpeg_tpu' not in sys.modules, 'jpeg_tpu loaded'")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_port_sources_name_no_jax_import():
    """No module of the port imports jax or jpeg_tpu (the tests may)."""
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|jpeg_tpu)(\.|\s|$)", re.M)
    pkg = os.path.join(REPO, "jpeg_tpu_torch")
    for root, _dirs, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    assert not pat.search(fh.read()), f


def test_no_include_or_build_command_names_the_jax_package(monkeypatch):
    """No C, C++ or CUDA file of the port includes a file inside jpeg_tpu/,
    and every build the port's host tools run (the runtime's build, an A/B
    variant of it, its ASan builds, the microbenchmarks, the libjpeg
    harness) compiles only sources inside jpeg_tpu_torch/ and names no path
    inside jpeg_tpu/."""
    import re

    from jpeg_tpu_torch import runtime
    from jpeg_tpu_torch.tools import ab_host_entropy, arith_ref, microbench
    from jpeg_tpu_torch.utils import build

    pkg = os.path.realpath(os.path.join(REPO, "jpeg_tpu_torch")) + os.sep
    jax_pkg = os.path.realpath(os.path.join(REPO, "jpeg_tpu")) + os.sep
    include = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)
    n_includes = 0
    for root, _dirs, files in os.walk(pkg):
        for f in files:
            if f.endswith((".c", ".cc", ".cpp", ".cu", ".cuh", ".h")):
                with open(os.path.join(root, f)) as fh:
                    for name in include.findall(fh.read()):
                        target = os.path.realpath(os.path.join(root, name))
                        assert target.startswith(pkg), (f, name)
                        n_includes += 1
    assert n_includes >= 5

    seen = []

    class Stop(Exception):
        pass

    def spy(name, compiler, sources, headers=(), **kw):
        seen.append((name, [*compiler, *sources, *headers,
                            *kw.get("libs", ())], sources))
        raise Stop(name)

    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "build_library", spy)
    monkeypatch.setattr(build, "build_executable", spy)
    monkeypatch.setattr(arith_ref, "build_executable", spy)
    monkeypatch.setattr(runtime, "load_library", lambda name, compiler,
                        sources, configure, headers=(): spy(
                            name, compiler, sources, headers))
    monkeypatch.setattr(arith_ref, "find_header", lambda: "jpeglib.h")
    calls = [(False, runtime.load), (False, runtime.load_encoder),
             (False, lambda: ab_host_entropy.build_variant("plain", "")),
             (False, arith_ref.build),
             *((False, lambda n=n: microbench.build(n))
               for n in microbench.PROGRAMS),
             (True, runtime.load), (True, runtime.load_encoder)]
    for asan, call in calls:
        monkeypatch.setenv("JPEG_TPU_ASAN", "1" if asan else "0")
        with pytest.raises(Stop):
            call()
    assert {n for n, _, _ in seen} >= {
        "jpegtpu", "jpegtpu_enc", "jpegtpu.ab_plain", "jpeg_arith_ref",
        "jpegtpu_asan", "jpegtpu_enc_asan", *microbench.PROGRAMS}
    for name, args, sources in seen:
        for src in sources:
            assert os.path.realpath(src).startswith(pkg), (name, src)
        for arg in args:
            assert not os.path.realpath(arg).startswith(jax_pkg), (name, arg)
            assert "jpeg_tpu/" not in arg.replace("jpeg_tpu_torch/", ""), (
                name, arg)
