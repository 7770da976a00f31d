"""The port's C++ runtime build against the JAX package's runtime.

- every C++ decode the port makes of each stream kind (the plane and block
  decodes, speculative at 8 chunks and at the default ``4 * n_threads``,
  progressive and arithmetic) equals ``jpeg_tpu.runtime``'s function of the
  same name, bit for bit;
- the runtime is one plain g++ build: a first load into an empty build
  directory runs the compiler once, with no training child, and leaves only
  ``libjpegtpu-<hash>.so``;
- ``utils/build.py`` on a tiny source: builds publish under their hash
  names, and the hash covers the headers and the flags;
- ``JPEG_TPU_ASAN=1`` selects the AddressSanitizer builds.
"""

import ctypes
import os
import subprocess

import numpy as np
import pytest

import jpeg_tpu.runtime as jrt
from jpeg_tpu.io.container import parse_jpeg as ref_parse
from jpeg_tpu_torch import encode_rgb, runtime
from jpeg_tpu_torch.io.container import parse_jpeg
from jpeg_tpu_torch.io.corpus import synthetic_image
from jpeg_tpu_torch.utils import build

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "goldens", "torch")
GOLDENS = {"restart": "synth_512x384_s2_q85_rst1.jpg",
           "norestart": "synth_512x384_s3_q85_rst0.jpg",
           "gray": "synth_512x384_s4_q85_rst1_gray.jpg",
           "progressive": "synth_512x384_s12_q85_rst0_gray_prog.jpg",
           "sof10": "synth_512x384_s7_q85_rst0_sof10.jpg"}
TINY = 'extern "C" int jt_f(int x) { return x > 3 ? x * 2 : x + 1; }\n'
TINY_CMD = ["g++", "-O2", "-fPIC", "-shared"]


def _stream(kind: str) -> bytes:
    if kind == "sof9":
        return encode_rgb(synthetic_image(512, 384, 9), quality=85,
                          arithmetic=True, restart_interval_mcus=8)
    with open(os.path.join(FIXTURES, GOLDENS[kind]), "rb") as f:
        return f.read()


def _decode_all(rt, plan, default_chunks=None) -> list[np.ndarray]:
    """Every C++ decode of ``plan``'s kind through the runtime module
    ``rt``, copied out of scratch. The speculative decode runs at 8 chunks
    and at ``default_chunks`` (None: the runtime's default count)."""
    if plan.progressive:
        outs = [rt.native_decode_progressive(plan),
                *rt.native_decode_progressive_planes(plan)]
    elif plan.arith_code:
        outs = [*rt.native_decode_arith_planes(plan),
                rt.native_decode_arith_coefficients(plan)]
    else:
        outs = [*rt.native_decode_planes(plan, speculative=False),
                *rt.native_decode_planes(plan, speculative=True, n_chunks=8),
                *rt.native_decode_planes(plan, speculative=True,
                                         n_chunks=default_chunks),
                rt.native_decode_coefficients(plan)]
    return [np.array(o, copy=True) for o in outs]


@pytest.mark.parametrize("kind", ["restart", "norestart", "gray", "sof9",
                                  "progressive", "sof10"])
def test_runtime_decodes_as_the_jax_runtime(kind):
    """The port's default chunk count, ``4 * cores``, is given to the JAX
    runtime explicitly: without ``n_chunks`` its tuner would pick one."""
    data = _stream(kind)
    got = _decode_all(runtime, parse_jpeg(data))
    want = _decode_all(jrt, ref_parse(data), 4 * (os.cpu_count() or 1))
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_runtime_is_one_plain_build(tmp_path, monkeypatch):
    """A first load into an empty build directory runs g++ once, with the
    shipping flags and no training child, and leaves the library under its
    hash name and nothing beside it but the lock."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "_paths", {})
    monkeypatch.delenv("JPEG_TPU_ASAN", raising=False)
    commands = []
    real = subprocess.run

    def spy(cmd, *args, **kw):
        commands.append(list(cmd))
        return real(cmd, *args, **kw)

    monkeypatch.setattr(build.subprocess, "run", spy)
    runtime.load()
    compiler = ["g++", *build.GXX_FLAGS]
    digest = build._digest(compiler, [runtime.PORT_SOURCE, runtime.SOURCE])
    name = f"libjpegtpu-{digest}.so"
    assert len(commands) == 1
    assert commands[0][:len(compiler)] == compiler
    assert commands[0][-1] == runtime.PORT_SOURCE
    assert sorted(os.listdir(build.BUILD_DIR)) == ["jpegtpu.lock", name]
    assert build.loaded("jpegtpu")[1] == os.path.join(build.BUILD_DIR, name)
    runtime.load()
    assert len(commands) == 1, "the second load built again"
    assert runtime.pgo_status() == "off"
    assert runtime.spec_tuner_snapshot() == {}
    plan = parse_jpeg(_stream("restart"))
    np.testing.assert_array_equal(
        runtime.native_decode_coefficients(plan, reuse_buffer=False),
        jrt.native_decode_coefficients(ref_parse(_stream("restart")),
                                       reuse_buffer=False))


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """A tiny source, built into a private build directory."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "_paths", {})
    src = tmp_path / "tiny.cpp"
    src.write_text(TINY)
    return tmp_path, str(src)


def test_builds_publish_under_their_hash_names(tiny):
    """A first build, into an empty build directory, lands under its hash
    name and loads or runs from there; a second build reuses it."""
    tmp_path, src = tiny
    lib = build.build_library("tiny.plain", TINY_CMD, [src])
    assert os.path.basename(lib).startswith("libtiny.plain-")
    assert ctypes.CDLL(lib).jt_f(5) == 10
    main = tmp_path / "main.c"
    main.write_text("int main(void) { return 7; }\n")
    exe = build.build_executable("tiny_main", ["gcc", "-O2"], [str(main)])
    assert os.path.basename(exe).startswith("tiny_main-")
    assert subprocess.run([exe], timeout=60).returncode == 7
    assert build.build_executable("tiny_main", ["gcc", "-O2"],
                                  [str(main)]) == exe
    assert build.build_library("tiny.plain", TINY_CMD, [src]) == lib


def test_library_name_covers_its_headers_and_flags(tiny):
    """An edited header or an added flag gives a new hash name; the same
    inputs reuse the old library."""
    tmp_path, src = tiny
    header = tmp_path / "tiny.h"
    header.write_text("#define JT_K 2\n")
    with open(src, "w") as f:
        f.write('#include "tiny.h"\n'
                'extern "C" int jt_f(int x) { return x * JT_K; }\n')
    cmd = [*TINY_CMD, "-I", str(tmp_path)]
    first = build.build_library("tiny", cmd, [src], (str(header),))
    assert build.build_library("tiny", cmd, [src], (str(header),)) == first
    assert ctypes.CDLL(first).jt_f(5) == 10
    header.write_text("#define JT_K 3\n")
    edited = build.build_library("tiny", cmd, [src], (str(header),))
    assert edited != first and os.path.exists(first)
    assert ctypes.CDLL(edited).jt_f(5) == 15
    flagged = build.build_library("tiny", [*cmd, "-DJT_UNUSED"], [src],
                                  (str(header),))
    assert flagged not in (first, edited)
    assert build.build_library("tiny", cmd, [src], (str(header),)) == edited
    names = [os.path.basename(p) for p in (first, edited, flagged)]
    assert sorted(os.listdir(build.BUILD_DIR)) == sorted(["tiny.lock", *names])


def test_asan_flag_selects_the_sanitizer_builds(monkeypatch):
    seen = []

    def spy(name, compiler, sources, configure, headers=()):
        seen.append((name, compiler))
        raise build.BuildError("stop")

    monkeypatch.setenv("JPEG_TPU_ASAN", "1")
    monkeypatch.setattr(runtime, "load_library", spy)
    for load in (runtime.load, runtime.load_encoder):
        with pytest.raises(build.BuildError):
            load()
    assert [s[0] for s in seen] == ["jpegtpu_asan", "jpegtpu_enc_asan"]
    assert all("-fsanitize=address" in s[1] for s in seen)
    assert runtime.library_name() == "jpegtpu_asan"
