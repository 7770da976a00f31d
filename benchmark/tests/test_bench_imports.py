"""The import rule: no module of the benchmark imports JAX or the JAX
package (top-level names compared whole: the program's name begins with
the JAX package's), and the reference imports nothing of the program."""

from __future__ import annotations

import ast
import os

from conftest import ROOT

BENCH = os.path.join(ROOT, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "flax", "jpeg_tpu"}


def imported(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", "")) in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def modules(sub: str = "") -> list:
    out = []
    for base, _, files in os.walk(os.path.join(BENCH, sub)):
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return out


def test_no_jax_anywhere():
    found = {p: imported(p) & FORBIDDEN for p in modules()}
    assert not {p: n for p, n in found.items() if n}
    assert len(found) > 20


def test_reference_is_independent():
    for p in modules("reference"):
        assert imported(p) <= {"__future__", "dataclasses", "re", "numpy",
                               "torch"}, p


def test_rule_compares_whole_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import jpeg_tpu_torch.ops\nfrom jpeg_tpu.io import x\n")
    assert imported(str(p)) & FORBIDDEN == {"jpeg_tpu"}
