"""The control comes out not correct: the program's bf16 tier (K1a's twin)
for decode, the reference in bfloat16 in the program's place for encode.
On the CPU at a small size; on the card at each cell's own size, over
three seeds (``-m cuda``: ``python3 -m pytest -m cuda benchmark/tests`` on
the card, ~3 min)."""

from __future__ import annotations

import json
import os
import time

import pytest
import torch

from benchmark.control import CONTROL
from benchmark.run import run_cell
from benchmark.spec import load_cell
from conftest import CELLS, ROOT, run_tiny

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    CARD_CELLS = [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_cpu(tiny_root, cell):
    entry = "decode_all" if cell == CELLS[0] else "encode_rgb_device"
    options, judge = CONTROL[entry]
    res = run_tiny(tiny_root, cell, seed=11, entry_options=options, judge=judge)
    assert not res["correct"]
    sound = run_tiny(tiny_root, cell, seed=11)
    name = next(k for k in res["check"] if k != "failed")
    assert res["check"][name]["value"] > 10 * max(
        sound["check"][name]["value"], 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CARD_CELLS)
def test_control_fails_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is read at the cell's size")
    c = load_cell(ROOT, cell)
    options, judge = CONTROL[c.traffic["entry"]]
    for seed in (101, 202, 303):
        res = run_cell(c, seed, 8.0, False, torch.device("cuda", 0),
                       time.perf_counter(), options, judge)
        assert not res["correct"], (cell, seed, res["check"])
