"""What ``BENCHMARK.json`` says about one cell, and the files it names.

A cell's configuration is the file its ``configs`` entry names; its traffic
mix is ``benchmark/traffic/<traffic>.json``; each metric is read by
``benchmark/metrics/<metric name>.py``, whose ``read(ctx)`` returns a number
or None. Nothing here knows a cell, configuration, mix or metric by name.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = "benchmark"


@dataclasses.dataclass
class Cell:
    root: str
    name: str
    chips: int
    config: dict      # the configuration's file, with "name" added
    traffic: dict     # the traffic mix's file, with "name" added
    end_to_end: list  # metric entries of BENCHMARK.json this cell reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: str, name: str) -> Cell:
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = dict(load_json(os.path.join(root, cfg_entry["file"])),
                  name=w["config"])
    traffic = dict(load_json(os.path.join(root, HERE, "traffic",
                                          f"{w['traffic']}.json")),
                   name=w["traffic"])
    return Cell(root, name, int(w["chips"]), config, traffic,
                [m for m in spec["end_to_end"] if _reports(m, name)],
                [m for m in spec["per_layer"] if _reports(m, name)])


def reader(root: str, metric: str):
    """The ``read`` function of ``benchmark/metrics/<metric>.py``."""
    path = os.path.join(root, HERE, "metrics", f"{metric}.py")
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
