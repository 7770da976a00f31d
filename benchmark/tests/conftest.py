"""Fixtures of the benchmark's CPU tests: a checkout-like root in a
temporary directory holding a copy of ``benchmark/`` and ``BENCHMARK.json``
with one small configuration added, its cells running the program's plain
CPU twins."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {"width": 64, "height": 48, "sampling": [2, 2], "quality": 85,
        "restart_rows": 1}
TINY_DECODE = {
    "entry": "decode_all", "loop": "closed", "clients": 1,
    "frames_per_call": 24,
    "decoder": {"hybrid_device": True, "idct_mode": "exact", "workers": 2},
    "warmup_calls": 1, "trace_calls": 2, "check": {"sample_per_route": 4},
    "limits": {"differ_share": 0.001, "differ_over1": 0}}
TINY_ENCODE = {
    "entry": "encode_rgb_device", "loop": "closed", "clients": 1,
    "frames_per_call": 1, "pool": 3, "quality": 85, "restart_rows": 1,
    "warmup_calls": 1, "trace_calls": 2, "check": {"sample": 3},
    "limits": {"coef_differ_share": 0.0001, "coef_over1": 0}}
CELLS = ("tiny_rst.tiny24", "tiny_rst.tiny_encode")


def tiny_frames(directory: str, count: int = 3) -> list[dict]:
    """Base frames of the small configuration, through the program's
    encoder (a test's own inputs; the benchmark's are committed files)."""
    from jpeg_tpu_torch.io.corpus import synthetic_image
    from jpeg_tpu_torch.models.encoder import encode_rgb

    out = []
    for i in range(count):
        data = encode_rgb(synthetic_image(TINY["width"], TINY["height"], i),
                          quality=85, restart_interval_mcus=4)
        name = f"benchmark/configs/frames/tiny_s{i}.jpg"
        with open(os.path.join(directory, name), "wb") as f:
            f.write(data)
        out.append({"file": name,
                    "sha256": hashlib.sha256(data).hexdigest()})
    return out


def make_root(directory: str) -> str:
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(directory, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "*.jpg"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), directory)
    cfg = dict(TINY, base_frames=tiny_frames(directory))
    with open(os.path.join(directory, "benchmark/configs/tiny_rst.json"), "w") as f:
        json.dump(cfg, f)
    for name, traffic in (("tiny24", TINY_DECODE), ("tiny_encode", TINY_ENCODE)):
        with open(os.path.join(directory, f"benchmark/traffic/{name}.json"), "w") as f:
            json.dump(traffic, f)
    path = os.path.join(directory, "BENCHMARK.json")
    with open(path) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "tiny_rst", "source": "test",
                            "file": "benchmark/configs/tiny_rst.json",
                            "reduced": [], "why": "test"})
    spec["workloads"] += [
        {"name": CELLS[0], "config": "tiny_rst", "traffic": "tiny24",
         "chips": 1, "why": "test"},
        {"name": CELLS[1], "config": "tiny_rst", "traffic": "tiny_encode",
         "chips": 1, "why": "test"}]
    decode = {"decode_fps", "k3_frame_share.decode",
              "device_idle_pct.decode", "copy_ms_per_frame.decode",
              "k1_roofline_pct", "k3_roofline_pct"}
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(CELLS[0] if m["name"] in decode else CELLS[1])
    with open(path, "w") as f:
        json.dump(spec, f)
    return directory


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> str:
    return make_root(str(tmp_path_factory.mktemp("bench_root")))


def run_tiny(root: str, cell: str, seed: int = 7, seconds: float = 1.0,
             trace: bool = False, entry_options: dict | None = None,
             judge: str = "check") -> dict:
    from benchmark.run import run_cell
    from benchmark.spec import load_cell

    return run_cell(load_cell(root, cell), seed, seconds, trace,
                    torch.device("cpu"), time.perf_counter(), entry_options,
                    judge)
