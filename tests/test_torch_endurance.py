"""The port's endurance tool (``jpeg_tpu_torch/tools/endurance.py``) against
the repo-root ``tools/endurance.py``, which is loaded from its file (its
top level imports the standard library alone) and never run:

- the manifest readers, the steady frames/s, the decay, the control's
  plateau growth and the gate equal the JAX tool's, whose inline formulas
  are read from its ``main`` with ``ast`` and evaluated on the same data;
- a CPU run (``--device cpu``, 24 64x48 images, chunks of 2) is killed at
  a fixed count (its corpus child blocks there until the SIGKILL, so the
  kill never races the child's end), resumes in recycled segments until
  the manifest holds every image once with no failure, and records every
  key of the committed ``SUSTAINED_r05.json``;
- a child that exits non-zero, ends before its kill or reports a failed
  image makes the tool raise (exit non-zero) with no ``PASS``.
"""

import ast
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import pytest
import torch

from jpeg_tpu_torch.tools import endurance

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOL = os.path.join(REPO, "tools", "endurance.py")
SUSTAINED = os.path.join(REPO, "SUSTAINED_r05.json")
N, SHORT, KILL_AT, LIMIT, CHUNK = 24, 4, 8, 8, 2
# The corpus child of the killed pass blocks once the manifest holds
# KILL_AT lines, so only the tool's SIGKILL ends it.
BLOCKING_CHILD = f"""
import sys, time
from jpeg_tpu_torch import cli
from jpeg_tpu_torch.utils import manifest

if "--limit" not in sys.argv and "_run" in sys.argv[2]:
    mark_done = manifest.Manifest.mark_done

    def blocking_mark_done(self, item, **info):
        mark_done(self, item, **info)
        if self.done_count >= {KILL_AT}:
            time.sleep(600)

    manifest.Manifest.mark_done = blocking_mark_done
sys.exit(cli.main(sys.argv[1:]))
"""


def jax_tool():
    spec = importlib.util.spec_from_file_location("jax_endurance", JAX_TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_main_exprs() -> dict:
    """The JAX tool's inline formulas in ``main``, compiled by target name."""
    tree = ast.parse(open(JAX_TOOL).read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    out = {}
    for node in ast.walk(main):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id in ("steady", "steadies", "decay",
                                           "ctrl_growth", "ok")):
            out[node.targets[0].id] = compile(
                ast.Expression(node.value), JAX_TOOL, "eval")
    return out


def test_jax_tool_imports_only_the_standard_library():
    tree = ast.parse(open(JAX_TOOL).read())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split(".")[0])
    assert names and names <= set(sys.stdlib_module_names), names


def write_manifest(stem, ts, torn=False):
    with open(stem + ".0.jsonl", "w") as f:
        for i, t in enumerate(ts):
            f.write(json.dumps({"item": f"img_{i:05d}.jpg", "ts": t}) + "\n")
        if torn:
            f.write('{"item": "img_99999.jpg", "t')


@pytest.mark.parametrize("torn", [False, True])
def test_manifest_readers_equal_jax(tmp_path, torn):
    ref = jax_tool()
    stem = str(tmp_path / "m")
    assert endurance.manifest_done(stem) == ref.manifest_done(stem) == 0
    ts = [1000.0 + 0.25 * i for i in range(70)]
    write_manifest(stem, ts, torn)
    assert endurance.manifest_done(stem) == ref.manifest_done(stem) == 70 + torn
    assert endurance.manifest_ts(stem) == ref.manifest_ts(stem) == ts


@pytest.mark.parametrize("n_ts", [64, 128, 129, 200, 340])
def test_steady_fps_at_chunk_64_equals_jax(n_ts):
    exprs = jax_main_exprs()
    ts = [500.0 + 0.02 * i + 0.0001 * i * i for i in range(n_ts)]
    want = eval(exprs["steady"], {"round": round, "max": max, "len": len},
                {"ts": ts})
    assert endurance.steady_fps(ts, 64) == want
    assert (want is None) == (n_ts <= 128)


@pytest.mark.parametrize("steadies", [[0.458, 0.598], [10.0, None, 9.2],
                                      [31.5], [None, None], [30.0, 28.0, 26.9]])
def test_decay_equals_jax(steadies):
    exprs = jax_main_exprs()
    segments = [{"fps_steady": s} for s in steadies]
    ns = {"segments": segments}
    ns["steadies"] = eval(exprs["steadies"], {}, ns)
    want = eval(exprs["decay"], {"round": round, "len": len}, ns)
    assert endurance.decay_of(steadies) == want


@pytest.mark.parametrize("ctrl", [[449, 721, 674, 674], [300, 310],
                                  [100, 140, 180, 220], None])
def test_control_growth_and_gate_equal_jax(ctrl):
    exprs = jax_main_exprs()
    want = eval(exprs["ctrl_growth"], {"round": round, "len": len},
                {"ctrl": ctrl})
    assert endurance.plateau_growth(ctrl, 16) == want
    for decay in (None, 0.74, 0.9, 1.306):
        ok = eval(exprs["ok"], {}, {"decay": decay, "ctrl_growth": want})
        assert endurance.passes(decay, want) == ok


@pytest.mark.parametrize("n_ts, want", [(8, [2.0]), (10, [2.0, 1.0]),
                                         (4, []), (3, [])])
def test_chunk_fps_by_chunk_end(n_ts, want):
    # Chunks of 4 landing every 2 s, a partial chunk 2 s after the last.
    ts = [2.0 * (i // 4) for i in range(n_ts)]
    if n_ts == 10:
        ts[8:] = [4.0, 4.0]
    assert endurance.chunk_fps(ts, 4) == want


def test_rss_growth_over_the_killed_pass():
    s = endurance.Samples(rss=[20.0, 300.0, 310.0, 305.0, 420.0, 430.0, 999.0],
                          done=[0, 0, 64, 64, 128, 128, 300])
    # Counts 64 and 128: peaks 310 and 430; 0 (warm-up) and 300 (the kill)
    # are left out.
    assert endurance.rss_growth(s, 300) == round(120.0 / 64, 3)
    assert endurance.rss_growth(endurance.Samples(rss=[5.0], done=[8]), 16) is None


FAKE_SMI = """#!/usr/bin/env python3
import sys
if sys.argv[1].startswith("--query-compute-apps"):
    print("1234, 700\\n999, 5")
else:
    print("4096")
"""


@pytest.mark.parametrize("pid, want", [
    (1234, (700.0, "query-compute-apps used_memory")),
    (42, (4096.0, "query-gpu memory.used")),
    (None, (4096.0, "query-gpu memory.used"))])
def test_gpu_memory_reads_the_childs_line_or_the_card(tmp_path, monkeypatch,
                                                      pid, want):
    smi = tmp_path / "nvidia-smi"
    smi.write_text(FAKE_SMI)
    smi.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    assert endurance._gpu_mem_mb(pid) == want


def test_write_corpus_copies_seeds_and_keeps_files(tmp_path):
    d = str(tmp_path / "c")
    os.makedirs(d)
    kept = os.path.join(d, "img_00004.jpg")
    with open(kept, "wb") as f:
        f.write(b"kept")
    _, written = endurance.write_corpus(d, 6, 3, size=(32, 16))
    assert written == 5
    files = [os.path.join(d, f"img_{i:05d}.jpg") for i in range(6)]
    data = [open(p, "rb").read() for p in files]
    assert not any(os.path.islink(p) for p in files)
    assert data[4] == b"kept" and data[3] == data[0] and data[5] == data[2]
    assert len({data[0], data[1], data[2]}) == 3
    assert sorted(os.listdir(d)) == [os.path.basename(p) for p in files]


@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
    """One CPU run of the tool: (exit code, stdout lines, record, corpus)."""
    tmp = tmp_path_factory.mktemp("endurance")
    corpus = str(tmp / "corpus")
    endurance.write_corpus(corpus, N, 5, size=(64, 48))
    child = tmp / "blocking_child.py"
    child.write_text(BLOCKING_CHILD)
    out = str(tmp / "sustained.json")
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
        mp.setattr(endurance, "CLI", [sys.executable, str(child)])
        rc = endurance.main([
            "--device", "cpu", "--images", str(N), "--corpus", corpus,
            "--short", str(SHORT), "--kill-after", str(KILL_AT),
            "--limit", str(LIMIT), "--chunk-size", str(CHUNK),
            "--control-images", "8", "--control-chunk", "2", "--out", out,
            "--timeout", "300"])
    with open(out) as f:
        record = json.load(f)
    return rc, buf.getvalue().strip().splitlines(), record, corpus


def test_cpu_run_is_killed_inside_the_corpus(cpu_run):
    _, _, record, _ = cpu_run
    assert record["killed_after_images"] == KILL_AT == record["kill_at"]
    assert 0 < record["killed_after_images"] < N
    assert record["killed_pass"]["rss_samples"] > 0


def test_cpu_run_resumes_every_image_once(cpu_run):
    _, _, record, corpus = cpu_run
    run_dir = f"{corpus}_run{N}"
    items = endurance.manifest_items(corpus + "_m_big")
    assert sorted(items) == sorted(os.path.join(run_dir, f"img_{i:05d}.jpg")
                                   for i in range(N))
    segs = record["segments"]
    assert [s["decoded"] for s in segs] == [LIMIT, N - KILL_AT - LIMIT]
    assert all(s["failed"] == 0 for s in segs)
    assert record["fps_short_100"] > 0 and record["short_images"] == SHORT


def test_cpu_run_records_the_jax_keys(cpu_run):
    _, _, record, _ = cpu_run
    with open(SUSTAINED) as f:
        jax_record = json.load(f)
    assert set(jax_record) <= set(record)
    jax_seg = set().union(*(s.keys() for s in jax_record["segments"]))
    assert all(jax_seg | {"gpu_mem_max_mb", "failed"} <= set(s)
               for s in record["segments"])
    assert record["resolution"] == "64x48" and record["device"] == "cpu"
    assert record["card"] is None and record["segments"][0]["gpu_mem_max_mb"] is None
    assert len(record["control_cpu_rss_mb"]) == 4


def test_cpu_run_verdict_follows_the_gate(cpu_run):
    rc, lines, record, _ = cpu_run
    ok = endurance.passes(record["steady_state_decay"],
                          record["control_cpu_rss_plateau_mb_per_image"])
    assert lines[-1] == ("ENDURANCE PASS" if ok else "ENDURANCE FAIL")
    assert rc == (0 if ok else 1)
    assert json.loads(lines[-2]) == record


def test_failing_child_raises(tmp_path, monkeypatch, capsys):
    corpus = str(tmp_path / "c")
    endurance.write_corpus(corpus, 4, 2, size=(32, 16))
    monkeypatch.setattr(endurance, "CLI",
                        [sys.executable, "-c", "import sys; sys.exit(3)"])
    with pytest.raises(RuntimeError, match="exited 3"):
        endurance.main(["--device", "cpu", "--images", "4", "--corpus", corpus,
                        "--kill-after", "2", "--out", str(tmp_path / "o.json")])
    assert "PASS" not in capsys.readouterr().out


def test_child_ending_before_its_kill_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(endurance, "CLI", [sys.executable, "-c", "pass"])
    with pytest.raises(RuntimeError, match="before the kill"):
        endurance.run_pass(str(tmp_path), str(tmp_path / "m"), "cpu", 2,
                           str(tmp_path / "err.log"), kill_after_done=5,
                           timeout_s=60)


def test_failed_image_exits_nonzero(tmp_path):
    corpus = str(tmp_path / "c")
    endurance.write_corpus(corpus, 6, 2, size=(32, 16))
    with open(os.path.join(corpus, "img_00001.jpg"), "wb") as f:
        f.write(b"\xff\xd8 not a jpeg")
    proc = subprocess.run(
        [sys.executable, "-m", "jpeg_tpu_torch.tools.endurance", "--device",
         "cpu", "--images", "6", "--corpus", corpus, "--short", "3",
         "--kill-after", "2", "--out", str(tmp_path / "o.json")],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0
    assert "ENDURANCE PASS" not in proc.stdout
    assert "short pass" in proc.stderr and "'failed': 1" in proc.stderr


def test_no_card_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        endurance.main(["--images", "4"])
