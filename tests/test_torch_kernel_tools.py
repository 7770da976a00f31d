"""The kernel-study tools of ``jpeg_tpu_torch/tools/`` on the CPU, where no
kernel builds: K7's ladder (``bench_device_spec``), K3's pass-1 ablation
(``ablate_kernel``), K1's cell sweep (``sweep_tiles``), and the build
layer's variant key under them. The repo-root tools they answer are read
as source (``ast``), never imported.

- a variant build is a library of its own: the shipping command lines are
  unchanged, two variants get two library paths, a variant's ``-D`` flags
  reach nvcc's command, and the ablation builds its own source with the
  shared header on the include path and in the hash;
- the ladder's configs and argument parsing are the JAX tool's, and it
  runs on the CPU (the twin) exactly at small sizes;
- the ablation's stream is the JAX tool's recipe (2,025 lanes), its one
  symbol a step table walks the same records, and its parsing;
- the sweep admits the layout's shapes and refuses the others with a
  ``ValueError`` before anything is built; its bound is chip_smoke.py's.
"""

import ast
import json
import os

import numpy as np
import pytest

import chip_smoke
from jpeg_tpu_torch.entropy import device_huffman, device_kernel, device_spec
from jpeg_tpu_torch.ops import fused_encode, fused_plane, idct_only
from jpeg_tpu_torch.tools import ablate_kernel, bench_device_spec, sweep_tiles
from jpeg_tpu_torch.utils import build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool_ast(name):
    with open(os.path.join(REPO, "tools", name)) as f:
        return ast.parse(f.read())


@pytest.fixture
def captured(monkeypatch):
    """Every build_library call, stopped before a compiler runs."""
    calls = []

    def fake_build(lib, compiler, sources, headers=()):
        calls.append((lib, compiler, sources, headers))
        raise build.BuildError("stop before compiling")

    monkeypatch.setattr(build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build, "build_library", fake_build)
    monkeypatch.setattr(build, "_loaded", {})
    return calls


# The shipping libraries' commands as they were before variants existed.
SHIPPING = [(fused_plane.load_kernel, "fused_plane", ("--fmad=false",)),
            (fused_encode.load_kernel, "fused_encode", ("--fmad=false",)),
            (device_huffman.load_kernel, "huffman_lanes", ()),
            (device_kernel.load_kernel, "huffman_words", ()),
            (device_spec.load_kernel, "huffman_spec", ()),
            (idct_only.load_kernel, "idct_only", ("--fmad=false",))]


@pytest.mark.parametrize("load,name,flags", SHIPPING)
def test_shipping_command_lines_are_unchanged(captured, load, name, flags):
    with pytest.raises(build.BuildError):
        load()
    (lib, compiler, sources, _), = captured
    assert lib == name
    assert compiler == ["nvcc", *build.NVCC_FLAGS, "-I", build.CSRC_DIR,
                        *flags]
    assert sources == [os.path.join(build.CSRC_DIR, f"{name}.cu")]


def test_the_shipping_cell_is_the_plain_build(captured):
    for cell in (None, fused_plane.CELL):
        with pytest.raises(build.BuildError):
            fused_plane.load_kernel(cell)
    assert captured[0][:2] == captured[1][:2]
    assert captured[0][0] == "fused_plane"


def test_variant_flags_reach_the_command_and_the_name(captured):
    with pytest.raises(build.BuildError):
        fused_plane.load_kernel((128, 64))
    (lib, compiler, sources, headers), = captured
    assert lib == "fused_plane.t128_n64"
    assert compiler[-3:] == ["--fmad=false", "-DJT_K1_TILE_W=128",
                             "-DJT_K1_THREADS=64"]
    assert sources == [os.path.join(build.CSRC_DIR, "fused_plane.cu")]
    assert headers == (os.path.join(build.CSRC_DIR, "idct8x8.cuh"),)
    with open(sources[0]) as f:
        text = f.read()
    for macro in ("JT_K1_TILE_W", "JT_K1_THREADS"):
        assert f"#ifndef {macro}" in text


def test_two_variants_get_two_libraries(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build, "_loaded", {})
    paths = {}

    def fake_load(name, compiler, sources, configure, headers=()):
        digest = build._digest(compiler, [*sources, *headers])
        paths[name] = tmp_path / f"lib{name}-{digest}.so"
        return name

    monkeypatch.setattr(build, "load_library", fake_load)
    for cell in ((64, 64), (256, 256), None):
        fused_plane.load_kernel(cell)
    assert set(paths) == {"fused_plane.t64_n64", "fused_plane.t256_n256",
                          "fused_plane"}
    assert len({p.name for p in paths.values()}) == 3


def test_a_loaded_variant_is_cached_under_its_own_key(monkeypatch):
    monkeypatch.setattr(build, "_loaded", {"fused_plane": "shipping"})
    monkeypatch.setattr(build, "load_library",
                        lambda name, *a, **k: f"built {name}")
    monkeypatch.setattr(build, "find_nvcc", lambda: "nvcc")
    assert fused_plane.load_kernel() == "shipping"
    assert fused_plane.load_kernel((64, 128)) == "built fused_plane.t64_n128"


def test_the_ablation_builds_its_own_source_with_the_shared_header(captured):
    with pytest.raises(build.BuildError):
        ablate_kernel.load_kernel()
    (lib, compiler, sources, headers), = captured
    assert lib == "k3_ablate"
    assert sources == [ablate_kernel.SOURCE]
    assert headers == (os.path.join(build.CSRC_DIR, "huffman_common.cuh"),)
    assert compiler[compiler.index("-I") + 1] == build.CSRC_DIR
    with open(ablate_kernel.SOURCE) as f:
        text = f.read()
    assert '#include "huffman_common.cuh"' in text and "walk_lane(" in text


# --------------------------------------------------------------------------
# K7's ladder


def test_ladder_configs_are_the_jax_tools():
    tree = _tool_ast("bench_device_spec.py")
    default = next(n.value for n in ast.walk(tree)
                   if isinstance(n, ast.Assign)
                   and getattr(n.targets[0], "id", None) == "configs"
                   and isinstance(n.value, ast.List) and n.value.elts)
    assert tuple(ast.literal_eval(default)) == bench_device_spec.CONFIGS
    assert bench_device_spec.parse_config("1024:16") == (1024, 16)


def test_ladder_frames_are_the_bench_frames():
    from jpeg_tpu_torch import bench

    (t0, rst), (t1, norst) = bench_device_spec.frames((64, 48))
    img = bench.synthetic_image(64, 48, 0)
    assert (t0, t1) == ("rst", "norst")
    assert rst == bench.restart_frame((64, 48), 0)
    assert norst == bench.norestart_stream(img)


def test_ladder_runs_on_the_cpu(capsys):
    rc = bench_device_spec.main(["--device", "cpu", "--size", "64x32",
                                 "16:8", "8:2", "--repeats", "1"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert rc == 0 and len(lines) == 4
    assert [ln["tag"] for ln in lines] == ["rst", "rst", "norst", "norst"]
    for ln in lines:
        assert ln["exact"] and ln["fps"] > 0 and ln["k7_ms"] is None
        assert ln["device"] == "cpu"
        assert set(ln) >= {"lanes", "overlap", "cap", "gap_mcus", "ms"}


# --------------------------------------------------------------------------
# K3's pass-1 ablation


def test_ablation_stream_is_the_jax_tools_recipe():
    tree = _tool_ast("ablate_kernel.py")
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "encode_rgb")
    kw = {k.arg: ast.literal_eval(k.value) for k in call.keywords}
    assert kw == {"quality": ablate_kernel.QUALITY, "subsampling": (2, 2),
                  "restart_interval_mcus": ablate_kernel.RESTART_MCUS}
    plans = ablate_kernel.stream_plans("rst16", "cpu")
    assert len(plans) == 1 and len(plans[0].segments) == 2025
    main8 = ablate_kernel.stream_plans("main8", "cpu")
    assert sum(len(p.segments) for p in main8) == 1080


def test_one_symbol_a_step_walks_the_same_records():
    """Variant (d) clears the pair bit: every step takes one symbol, so the
    walk takes more steps and writes the same records (K3's NumPy model of
    pass 1, tests/test_torch_k3_two_pass.py)."""
    from test_torch_k3_two_pass import _Model

    from jpeg_tpu_torch.bench import restart_frame
    from jpeg_tpu_torch.io.container import parse_jpeg

    batch = device_huffman.prepare_lane_batch(
        [parse_jpeg(restart_frame((64, 32), s)) for s in (0, 1)])
    one = ablate_kernel.one_symbol_pairs(batch.pair)
    assert not (one & (1 << 26)).any() and (batch.pair & (1 << 26)).any()
    np.testing.assert_array_equal(one & ~(0x3FFF << 13), batch.pair & ~(0x3FFF << 13))
    model = _Model(batch)
    rec, err = model.boundary_pass()
    steps = sum(model.walk_lane(lane, rec.copy())[2]
                for lane in range(len(batch.lane_start)))
    model.pair = one.tolist()
    rec1, err1 = model.boundary_pass()
    steps1 = sum(model.walk_lane(lane, rec1.copy())[2]
                 for lane in range(len(batch.lane_start)))
    np.testing.assert_array_equal(rec1, rec)
    np.testing.assert_array_equal(err1, err)
    assert steps1 > steps


def test_ablation_arguments():
    args = ablate_kernel.parse_args([])
    assert args.streams == list(ablate_kernel.STREAMS)
    assert args.variants == ["a", "b", "c", "d", "e", "f"]
    keys = [v[0] for v in ablate_kernel.VARIANTS]
    assert keys[:5] == ["a", "b", "c", "d", "e"]
    assert [v[4] for v in ablate_kernel.VARIANTS if v[0] == "f"] == [
        1, 2, 4, 8, 32]
    with pytest.raises(SystemExit):
        ablate_kernel.parse_args(["--variants", "a,z"])


# --------------------------------------------------------------------------
# K1's cell sweep


def test_sweep_admits_the_layouts_shapes():
    assert sweep_tiles.parse_args([]).shapes == list(sweep_tiles.SHAPES)
    assert len(sweep_tiles.SHAPES) == 9 and fused_plane.CELL in sweep_tiles.SHAPES
    for tile in fused_plane.CELL_TILES:
        assert fused_plane.TILE_W % tile == 0
    assert sweep_tiles.parse_shape("64:256") == (64, 256)


@pytest.mark.parametrize("shape", [(512, 128), (32, 128), (128, 96),
                                   (256, 512), (192, 128)])
def test_sweep_refuses_what_the_layout_cannot_take(monkeypatch, shape):
    def no_build(*_):
        raise AssertionError("built a refused shape")

    monkeypatch.setattr(sweep_tiles, "build", no_build)
    monkeypatch.setattr(build, "build_library", no_build)
    with pytest.raises(ValueError, match="fit the plane layout"):
        sweep_tiles.sweep([(256, 128), shape], (1,), 1, "cpu")
    with pytest.raises(ValueError):
        fused_plane.fused_plane_decode_cuda([], None, None, cell=shape)


def test_sweep_bound_is_the_smokes():
    import torch

    from jpeg_tpu_torch.bench import restart_frame
    from jpeg_tpu_torch.io.container import parse_jpeg
    from jpeg_tpu_torch.models.decoder import PipelineGeometry

    for name in ("K1_OPS_PER_BLOCK", "K1A_TC_OPS_PER_BLOCK", "HBM_BYTES_PER_S",
                 "FP32_OPS_PER_S", "BF16_TC_OPS_PER_S"):
        assert getattr(sweep_tiles, name) == getattr(chip_smoke, name)
    geom = PipelineGeometry.of(parse_jpeg(restart_frame((64, 32), 0)))
    planes = [torch.zeros((2, *s), dtype=torch.int16)
              for s in fused_plane.padded_plane_shapes(geom)]
    qtabs = torch.zeros((2, 3, 64), dtype=torch.float32)
    h_pad, w_pad = fused_plane.padded_size(geom)
    pixels, blocks = 2 * h_pad * w_pad, sum(p.numel() for p in planes) // 64
    n_bytes = sum(p.numel() * 2 for p in planes) + qtabs.numel() * 4 + 3 * pixels
    assert sweep_tiles.bound_ms(planes, qtabs, geom, False) == pytest.approx(
        chip_smoke.bound(n_bytes, blocks * chip_smoke.K1_OPS_PER_BLOCK
                         + 12 * pixels)["bound_ms"])
    assert sweep_tiles.bound_ms(planes, qtabs, geom, True) == pytest.approx(
        chip_smoke.bound(n_bytes, blocks * 64 + 12 * pixels,
                         blocks * chip_smoke.K1A_TC_OPS_PER_BLOCK)["bound_ms"])
