"""The benchmark's inputs: deterministic from the seed, distinct within and
across calls, valid streams of the configuration."""

from __future__ import annotations

import hashlib
import os

import numpy as np
import pytest

from benchmark.inputs import (SpliceSource, base_paths, load_base, rgb_pool,
                              stamp)
from benchmark.reference import jpeg as ref
from benchmark.spec import load_json
from conftest import ROOT

SEED = 2**31 + 12345  # the driver's seeds run past 32 signed bits
FRAMES_SHA = "e8faba4a32ec9c3df5baeb190d70c9634b91800efe719c28280d8c121eae6c04"


def hd1080_bases():
    cfg = load_json(os.path.join(ROOT, "benchmark/configs/hd1080_rst.json"))
    return cfg, [load_base(p, h) for p, h in base_paths(ROOT, cfg)]


def test_frames_pinned_by_hash():
    _, bases = hd1080_bases()
    src = SpliceSource(bases, SEED)
    h = hashlib.sha256()
    for n in range(6):
        h.update(src.frame(n))
    assert h.hexdigest() == FRAMES_SHA


def test_frames_distinct_and_valid():
    cfg, bases = hd1080_bases()
    src = SpliceSource(bases, SEED)
    frames = [src.frame(n) for n in range(32)]
    assert len(set(frames)) == len(frames)
    scans = {f[f.index(b"\xff\xda"):] for f in frames}
    assert len(scans) == len(frames)  # distinct beyond the COM tag too
    other = SpliceSource(bases, SEED + 1).frame(0)
    assert other != frames[0]
    for f in frames[:3]:
        fr = ref.parse(f)
        assert (fr.width, fr.height) == (cfg["width"], cfg["height"])
        assert fr.restart_interval == cfg["restart_interval_mcus"]
        assert len(fr.segments) == 68
        ref.Decoder().coefficients(fr)  # every segment decodes


def test_base_hash_checked(tmp_path):
    p = tmp_path / "x.jpg"
    p.write_bytes(b"\xff\xd8")
    with pytest.raises(ValueError, match="sha256"):
        load_base(str(p), "0" * 64)


def test_rgb_pool_from_seed():
    a = rgb_pool(40, 24, 2, SEED)
    b = rgb_pool(40, 24, 2, SEED)
    c = rgb_pool(40, 24, 2, SEED + 1)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0]) and not np.array_equal(a[0], a[1])
    assert a[0].shape == (24, 40, 3) and a[0].dtype == np.uint8
    x, y = a[0].copy(), a[0].copy()
    stamp(x, 5)
    stamp(y, 6)
    assert not np.array_equal(x, y)
    stamp(y, 5)
    assert np.array_equal(x, y)
