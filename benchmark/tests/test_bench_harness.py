"""The harness on the CPU: the small cells run end to end through the
program's plain twins, the result line has the contract's keys, a cell,
configuration, traffic mix and metric are found from new files alone, and
runs without a card or with JAX loaded print no result."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
import types

import pytest

from benchmark import run
from benchmark.entries.common import CallRecord
from benchmark.trace import Event, Trace, breakdown
from conftest import CELLS, ROOT, make_root, run_tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_runs_correct(tiny_root, cell, trace):
    res = run_tiny(tiny_root, cell, trace=trace)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    want = KEYS + (["breakdown"] if trace else []) + ["check"]
    assert list(res) == want
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert res["device"]["window_s"] > 0
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in res["metrics"] and "peak_rss_gb" in res["metrics"]
        rate = "decode_fps" if cell == CELLS[0] else "encode_fps"
        assert res["metrics"][rate]["value"] > 0


def test_last_line_is_the_result(tiny_root, capsys):
    res = run_tiny(tiny_root, CELLS[0])
    run.emit(res)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == KEYS + ["check"]
    assert err.strip().splitlines()[-1].startswith("check differ_over1 ")


def _digests(root: str) -> dict:
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in base and f != "BENCHMARK.json":
                with open(os.path.join(base, f), "rb") as fh:
                    out[os.path.join(base, f)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_cell_from_new_files_only(tmp_path):
    root = make_root(str(tmp_path))
    before = _digests(root)
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "configs/tiny_rst.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(bench, "configs/dummy_rst.json"), "w") as f:
        json.dump(dict(cfg, base_frames=cfg["base_frames"][:2]), f)
    with open(os.path.join(bench, "traffic/tiny24.json")) as f:
        traffic = json.load(f)
    with open(os.path.join(bench, "traffic/dummy8.json"), "w") as f:
        json.dump(dict(traffic, frames_per_call=8, trace_calls=1), f)
    with open(os.path.join(bench, "metrics/frames_per_call.dummy.py"), "w") as f:
        f.write("def read(ctx):\n"
                "    return ctx.frames / len(ctx.calls) if ctx.calls else None\n")
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "dummy_rst", "source": "test",
                            "file": "benchmark/configs/dummy_rst.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "dummy_rst.dummy8", "config": "dummy_rst",
                              "traffic": "dummy8", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "frames_per_call.dummy", "unit": "frames",
                              "better": "higher", "source": "program_counter",
                              "layer": "corpus route", "moves": "decode_fps",
                              "workloads": ["dummy_rst.dummy8"]})
    for m in spec["end_to_end"]:
        if m["name"] == "decode_fps":
            m["workloads"].append("dummy_rst.dummy8")
    with open(path, "w") as f:
        json.dump(spec, f)
    res = run_tiny(root, "dummy_rst.dummy8", trace=True)
    assert res["correct"]
    assert res["metrics"]["frames_per_call.dummy"]["value"] == 8.0
    res = run_tiny(root, "dummy_rst.dummy8")
    assert res["metrics"]["decode_fps"]["value"] > 0
    after = _digests(root)
    assert {k: after[k] for k in before} == before


def test_main_refuses_without_a_card(capsys, monkeypatch):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_bare_directory_prints_no_result(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "uhd4k_rst.chunk64", "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode != 0 and proc.stdout == ""


def test_jax_in_process_refuses(tiny_root, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(run.RunError, match="jax"):
        run_tiny(tiny_root, CELLS[1])


@pytest.mark.parametrize("command", ["run", "control"])
def test_jax_loaded_by_the_check_prints_no_result(tiny_root, monkeypatch,
                                                  capsys, command):
    """JAX loaded after the window, while the reference judges the
    answers: ``main`` of the run and of the control print nothing on
    stdout and exit non-zero. The look for a card is skipped and the run
    made on the CPU."""
    import torch

    from benchmark import control
    from benchmark.entries import decode_all

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    real_run = run.run_cell

    def on_cpu(cell, seed, seconds, trace, device, *rest):
        return real_run(cell, seed, seconds, trace, torch.device("cpu"), *rest)

    monkeypatch.setattr(run, "run_cell", on_cpu)
    monkeypatch.setattr(control, "run_cell", on_cpu)
    real_check = decode_all.Entry.check

    def loads_jax(self, device):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return real_check(self, device)

    monkeypatch.setattr(decode_all.Entry, "check", loads_jax)
    monkeypatch.chdir(tiny_root)
    args = ["--workload", CELLS[0], "--seconds", "0.5"]
    if command == "run":
        rc = run.main(args + ["--seed", "5", "--trace", "0"])
    else:
        rc = control.main(args + ["--seeds", "5"])
    assert rc != 0 and "jax" in sys.modules
    assert capsys.readouterr().out == ""


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jpeg_tpu_torch_like", types.ModuleType("x"))
    assert "jpeg_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jpeg_tpu.ops", types.ModuleType("y"))
    assert "jpeg_tpu" in run.forbidden_modules()


def _trace() -> Trace:
    k1 = ("void (anonymous namespace)::fused_plane_kernel<false>((anonymous "
          "namespace)::Geometry, float const*, Basis, unsigned char*)")
    k3a = "(anonymous namespace)::boundary_pass(unsigned char const*, long const*, int)"
    k4 = "(anonymous namespace)::boundary_pass(unsigned int const*, int, int)"
    ev = [Event("bench.call", "cpu", 0.0, 1.0), Event("bench.call", "cpu", 1.0, 2.0),
          Event(k1, "kernel", 0.10, 0.11), Event(k1, "kernel", 1.10, 1.11),
          Event(k3a, "kernel", 0.20, 0.22), Event(k4, "kernel", 0.30, 0.31),
          Event("Memcpy HtoD (Pageable -> Device)", "memcpy", 0.5, 0.6),
          Event("Memcpy DtoH (Device -> Pageable)", "memcpy", 0.55, 0.7),
          Event("aten::copy_", "cpu", 0.8, 0.9)]
    calls = [CallRecord(0.0, 1.0, 8, 0, {"device_frames": 8, "device_scan_bytes": 10**6}),
             CallRecord(1.0, 2.0, 8, 0, {"device_frames": 0, "device_scan_bytes": 0})]
    return Trace(ev, (0.0, 2.0), calls)


def test_readers_on_a_synthetic_trace(tiny_root):
    from benchmark.peaks import k1_bound_s, k3_bound_s
    from benchmark.spec import load_cell, reader

    cell = load_cell(tiny_root, CELLS[0])
    tr = _trace()
    ctx = run.Context(cell, 1.0, 0.0, tr.calls, {"device_frames": 8}, 10**9, tr)
    read = lambda name: reader(tiny_root, name)(ctx)  # noqa: E731
    assert read("device_idle_pct.decode") == pytest.approx(100 * (1 - 0.25 / 2.0))
    assert read("copy_ms_per_frame.decode") == pytest.approx(1e3 * 0.25 / 16)
    assert read("k1_roofline_pct") == pytest.approx(
        100 * 2 * k1_bound_s(cell.config, 8) / 0.02)
    assert read("k3_roofline_pct") == pytest.approx(
        100 * k3_bound_s(cell.config, 8, 10**6) / 0.02)
    assert read("k3_frame_share.decode") == pytest.approx(50.0)
    assert read("device_idle_pct.encode") is None
    assert read("k2_roofline_pct") is None  # no encode entry, no K2 kernel
    bd = breakdown(tr)
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10
    assert bd["idle_gaps"][0][1] == pytest.approx(0.89)
    assert bd["idle_gaps"][0][0].endswith("-> end | host: bench.call")
    assert sum(s for _, s in bd["idle_gaps"]) == pytest.approx(2.0 - tr.busy_s())


def test_rss_peak_samples_the_window():
    base = run.RssPeak.rss()
    peak = run.RssPeak()
    peak.start()
    block = b"\x01" * (64 << 20)  # written: resident
    time.sleep(0.1)
    del block
    assert peak.peak() >= base + (48 << 20)
