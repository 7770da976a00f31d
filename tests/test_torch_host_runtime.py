"""The port's C++ runtime build and chunk tuner against the JAX package's.

- the runtime loads as a profile-guided build (``pgo_status() == "on"``),
  whose file differs from a plain build's and whose planes and blocks are
  bit-identical to it on every stream kind;
- the profile-guided machinery of ``utils/build.py`` on a tiny source: a
  training child that exits non-zero gives a plain build and ``off``, kept
  under a name of its own so that the next build trains again, one that
  runs gives ``on``, and the library's hash covers the training inputs
  (``pgo_train.py`` and its streams);
- the chunk tuner gives ``jpeg_tpu.runtime``'s sequence of chunk counts and
  its snapshot under the same fed-back times (after
  ``tests/test_speculative.py``'s persistence test), and
  ``native_decode_planes`` drives it;
- ``JPEG_TPU_ASAN=1`` selects the AddressSanitizer builds.
"""

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jpeg_tpu.runtime as jrt
from jpeg_tpu.io.container import parse_jpeg as ref_parse
from jpeg_tpu_torch import bench, encode_rgb, runtime
from jpeg_tpu_torch.io.container import parse_jpeg
from jpeg_tpu_torch.io.corpus import synthetic_image
from jpeg_tpu_torch.tools import ab_host_entropy, pgo_train
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


def _decode_all(plan) -> list[np.ndarray]:
    """Every C++ decode of ``plan``'s kind, copied out of scratch."""
    if plan.progressive:
        outs = [runtime.native_decode_progressive(plan),
                *runtime.native_decode_progressive_planes(plan)]
    elif plan.arith_code:
        outs = [*runtime.native_decode_arith_planes(plan),
                runtime.native_decode_arith_coefficients(plan)]
    else:
        outs = [*runtime.native_decode_planes(plan, speculative=False),
                *runtime.native_decode_planes(plan, speculative=True,
                                              n_chunks=8),
                runtime.native_decode_coefficients(plan)]
    return [np.array(o, copy=True) for o in outs]


@pytest.fixture(scope="module")
def builds():
    """(shipping profile-guided library, plain library) paths."""
    runtime.load()
    return (build.loaded(runtime.library_name())[1],
            ab_host_entropy.build_variant("plain", ""))


def test_runtime_loads_the_profile_guided_build(builds):
    assert runtime.pgo_status() == "on"
    info = runtime.build_info()
    assert info["pgo"] == "on" and info["train_rc"] == 0
    for step in ("instrumented_s", "train_s", "final_s"):
        assert info[step] > 0
    shipping, plain = builds
    with open(shipping, "rb") as f, open(plain, "rb") as g:
        assert f.read() != g.read(), "the profile-guided .so is the plain one"


@pytest.mark.parametrize("kind", ["restart", "norestart", "gray", "sof9",
                                  "progressive", "sof10"])
def test_profile_guided_build_decodes_as_the_plain_build(builds, kind):
    plan = parse_jpeg(_stream(kind))
    shipping, plain = builds
    name = runtime.library_name()
    want = _decode_all(plan)
    try:
        build.use_library(name, plain, runtime._configure)
        got = _decode_all(plan)
    finally:
        build.use_library(name, shipping, runtime._configure)
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """A tiny source, built into a private build directory."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "_paths", {})
    src = tmp_path / "tiny.cpp"
    src.write_text(TINY)
    return tmp_path, str(src)


def _trainer(tmp_path, body: str) -> build.PGO:
    script = tmp_path / "train.py"
    script.write_text(body)
    return build.PGO((sys.executable, str(script)), (str(script),))


TRAIN = ("import ctypes, sys\n"
         "lib = ctypes.CDLL(sys.argv[1])\n"
         "print(sum(lib.jt_f(i) for i in range(100)))\n")


def test_failed_training_gives_a_plain_build_and_off(tiny):
    tmp_path, src = tiny
    fail = _trainer(tmp_path, "import sys\nsys.exit(3)\n")
    path = build.build_library("tiny", TINY_CMD, [src], pgo=fail)
    build.use_library("tiny", path, lambda lib: None)
    info = build.build_info("tiny")
    assert info["pgo"] == "off" and info["train_rc"] == 3
    assert path.endswith(".off.so")
    assert ctypes.CDLL(path).jt_f(5) == 10
    assert not [f for f in os.listdir(build.BUILD_DIR) if "work" in f]


def test_load_after_a_failed_training_trains_again(tiny):
    """A plain build from a failed training is not kept under the
    profile-guided name: the next build trains again and publishes."""
    tmp_path, src = tiny
    flag = tmp_path / "failed_once"
    flaky = _trainer(tmp_path, (
        f"import os, sys\nflag = {str(flag)!r}\n"
        "if not os.path.exists(flag):\n"
        "    open(flag, 'w').close()\n    sys.exit(3)\n") + TRAIN)
    off = build.build_library("tiny", TINY_CMD, [src], pgo=flaky)
    assert off.endswith(".off.so") and flag.exists()
    build.use_library("tiny", off, lambda lib: None)
    assert build.build_info("tiny")["pgo"] == "off"
    on = build.build_library("tiny", TINY_CMD, [src], pgo=flaky)
    assert on != off and not on.endswith(".off.so")
    build.use_library("tiny", on, lambda lib: None)
    assert build.build_info("tiny")["pgo"] == "on"
    assert build.build_library("tiny", TINY_CMD, [src], pgo=flaky) == on
    assert ctypes.CDLL(on).jt_f(2) == 3


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


def test_training_that_runs_gives_a_profile_guided_build(tiny):
    tmp_path, src = tiny
    path = build.build_library("tiny", TINY_CMD, [src],
                               pgo=_trainer(tmp_path, TRAIN))
    build.use_library("tiny", path, lambda lib: None)
    assert build.build_info("tiny")["pgo"] == "on"
    assert ctypes.CDLL(path).jt_f(2) == 3
    plain = build.build_library("tiny.plain", TINY_CMD, [src])
    assert os.path.basename(plain) != os.path.basename(path)
    assert build.build_info("tiny.plain") is None  # not loaded


def test_library_name_covers_the_training_inputs(tiny):
    """Editing the training script (or a stream it reads) rebuilds."""
    tmp_path, src = tiny
    pgo = _trainer(tmp_path, TRAIN)
    first = build.build_library("tiny", TINY_CMD, [src], pgo=pgo)
    assert build.build_library("tiny", TINY_CMD, [src], pgo=pgo) == first
    with open(pgo.inputs[0], "a") as f:
        f.write("# edited\n")
    second = build.build_library("tiny", TINY_CMD, [src], pgo=pgo)
    assert second != first and os.path.exists(second)


def test_runtime_training_hashes_its_script_and_streams():
    pgo = runtime.pgo()
    assert pgo.command[-1] == "jpeg_tpu_torch.tools.pgo_train"
    assert os.path.realpath(pgo.inputs[0]) == os.path.realpath(
        pgo_train.__file__)
    assert set(pgo.inputs[1:]) == set(pgo_train.STREAMS)
    assert all(os.path.exists(p) for p in pgo.inputs)


def test_asan_flag_selects_the_sanitizer_builds(monkeypatch):
    seen = []

    def spy(name, compiler, sources, configure, headers=(), pgo=None):
        seen.append((name, compiler, pgo))
        raise build.BuildError("stop")

    monkeypatch.setenv("JPEG_TPU_ASAN", "1")
    monkeypatch.setattr(runtime, "load_library", spy)
    for load in (runtime.load, runtime.load_encoder):
        with pytest.raises(build.BuildError):
            load()
    assert [s[0] for s in seen] == ["jpegtpu_asan", "jpegtpu_enc_asan"]
    assert all("-fsanitize=address" in s[1] and s[2] is None for s in seen)
    assert runtime.library_name() == "jpegtpu_asan"


# --------------------------------------------------------------------------
# The chunk tuner


def _norestart_plans():
    data = _stream("norestart")
    return parse_jpeg(data), ref_parse(data)


def _dt(k: int, i: int) -> float:
    """A fed-back wall time, the same for both tuners."""
    return 0.010 + 0.001 * ((k * 7 + i * 3) % 11)


@pytest.mark.parametrize("start", ["fresh", "persisted", "broken_file"])
@pytest.mark.parametrize("n_threads", [1, 2, 4])
def test_tuner_follows_the_jax_tuner(tmp_path, monkeypatch, start, n_threads):
    plan, ref_plan = _norestart_plans()
    jax_file = tmp_path / "jax.json"
    monkeypatch.setattr(jrt, "_SPEC_TUNER_PATH", str(jax_file))
    monkeypatch.setattr(jrt, "_spec_tuner", {})
    tuner = runtime.SpecTuner(str(tmp_path / "port.json"), lambda: "lib")
    assert tuner.key(plan) == jrt._spec_key(ref_plan)
    if start == "persisted":
        jrt._spec_persist_store(jrt._spec_key(ref_plan), 6 * n_threads)
        tuner.store(tuner.key(plan), 6 * n_threads)
    elif start == "broken_file":
        for f in (jax_file, tmp_path / "port.json"):
            f.write_text("{broken")
    got, want = [], []
    for i in range(12):
        k, kr = tuner.chunks(plan, n_threads), jrt._spec_chunks(ref_plan,
                                                                n_threads)
        got.append(k)
        want.append(kr)
        tuner.feedback(plan, k, _dt(k, i))
        jrt._spec_feedback(ref_plan, kr, _dt(kr, i))
    assert got == want
    assert tuner.snapshot() == jrt.spec_tuner_snapshot()
    assert tuner.snapshot()[str(tuner.key(plan))]["chosen"] is not None


def test_tuner_persists_its_pick_under_the_library_file(tmp_path):
    runtime.load()
    tuner = runtime.SpecTuner(str(tmp_path / "t.json"), runtime._library_file)
    plan, _ = _norestart_plans()
    for i in range(7):
        k = tuner.chunks(plan, 2)
        tuner.feedback(plan, k, _dt(k, i))
    (key, pick), = json.loads((tmp_path / "t.json").read_text()).items()
    lib = os.path.basename(build.loaded(runtime.library_name())[1])
    assert key == f"{tuner.key(plan)}|cores={os.cpu_count()}|so={lib}"
    assert pick == tuner.snapshot()[str(tuner.key(plan))]["chosen"]
    # A new tuner (a new process) starts on the persisted pick.
    again = runtime.SpecTuner(str(tmp_path / "t.json"), runtime._library_file)
    again.chunks(plan, 2)
    assert again.snapshot()[str(again.key(plan))]["chosen"] == pick


def test_native_decode_planes_drives_the_tuner(tmp_path, monkeypatch):
    """Without ``n_chunks`` each speculative call takes the tuner's count
    and feeds back its time; the planes at every candidate equal the
    segment-sequential decode's, and the bench reports the pick."""
    tuner = runtime.SpecTuner(str(tmp_path / "t.json"), lambda: "test")
    monkeypatch.setattr(runtime, "_TUNER", tuner)
    plan, _ = _norestart_plans()
    want = _decode_all(plan)[:len(plan.components)]
    for _ in range(7):
        got = runtime.native_decode_planes(plan, n_threads=2, speculative=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    snap = tuner.snapshot()[str(tuner.key(plan))]
    assert snap["chosen"] in (8, 12, 16)
    assert all(v is not None for v in snap["best_ms"].values())
    for k in (8, 12, 16):
        got = runtime.native_decode_planes(plan, n_threads=2, n_chunks=k,
                                           speculative=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    detail = bench.spec_tuner_detail(plan)
    assert detail["spec_chunks"] == snap["chosen"] and detail["pgo"] == "on"
    assert detail["spec_tuner"] == tuner.snapshot()
