"""Multi-process coordination of jpeg_tpu_torch on ``torch.distributed``
(gloo), against ``jpeg_tpu.parallel.distributed``.

The two-process cases mirror ``tests/test_multiprocess.py``: two real
processes join a group over 127.0.0.1, each decodes its shard of five
items, and the metrics sum across them: once through the library
(``initialize``, ``shard_items``, ``decode_bytes(device="cpu")``,
``aggregate_metrics``, and ``decode_batch_with_metrics`` whose counts sum
over the group) and once through ``python -m jpeg_tpu_torch corpus
--distributed --device cpu``. The workers import neither ``jax`` nor
``jpeg_tpu``. Each group waits 60 s at most for its peer and each process
is given 120 s, so a hang fails the test rather than the suite.
"""

import json
import os
import socket
import subprocess
import sys

import pytest
import torch.distributed as dist

from jpeg_tpu.parallel import distributed as ref
from jpeg_tpu_torch.io.corpus import synthetic_image
from jpeg_tpu_torch.models.encoder import encode_rgb
from jpeg_tpu_torch.parallel import distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ITEMS = 5

WORKER = r"""
import json, os, sys

import numpy as np

from jpeg_tpu_torch.io.container import parse_jpeg
from jpeg_tpu_torch.io.corpus import shard_items, synthetic_image
from jpeg_tpu_torch.models.decoder import (
    PipelineGeometry, decode_bytes, decode_coefficients_host, plan_matrices)
from jpeg_tpu_torch.models.encoder import encode_rgb
from jpeg_tpu_torch.parallel.batch import decode_batch_with_metrics
from jpeg_tpu_torch.parallel.distributed import (
    aggregate_metrics, initialize, shutdown)
from jpeg_tpu_torch.parallel.mesh import make_mesh

idx, count = initialize(coordinator_address=os.environ["COORD"],
                        num_processes=2, process_id=int(sys.argv[1]))
assert count == 2, count
items = [("img%d" % i, 48 + 16 * i) for i in range(5)]
mine = shard_items(items, idx, count)
frames = 0
for i, (name, size) in enumerate(mine):
    data = encode_rgb(synthetic_image(size, 48, seed=10 * idx + i))
    rgb = decode_bytes(data, device="cpu")
    assert rgb.shape == (48, size, 3), rgb.shape
    frames += 1
total = aggregate_metrics({"frames": float(frames)})
plan = parse_jpeg(encode_rgb(synthetic_image(32, 16, seed=idx)))
coeffs = np.stack([decode_coefficients_host(plan)] * 2)
mats = np.stack([plan_matrices(plan)] * 2)
_, batch_frames, blocks = decode_batch_with_metrics(
    coeffs, mats, PipelineGeometry.of(plan),
    make_mesh(2, devices=["cpu", "cpu"]))
shutdown()
assert not any(m == "jax" or m.startswith(("jax.", "jpeg_tpu."))
               or m == "jpeg_tpu" for m in sys.modules)
print(json.dumps({"idx": idx, "local": frames, "total": total["frames"],
                  "batch_frames": batch_frames, "blocks": blocks}))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(var, None)
    return env


def _run_pair(argvs, envs) -> list[str]:
    """Start two processes, wait for both (120 s each at most), kill both on
    a timeout; returns their standard outputs."""
    procs = [subprocess.Popen(argv, env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for argv, env in zip(argvs, envs)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def test_two_process_distributed(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = _env()
    env["COORD"] = f"127.0.0.1:{_free_port()}"
    outs = _run_pair([[sys.executable, str(script), str(i)] for i in range(2)],
                     [env, env])
    reports = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    assert {r["idx"] for r in reports} == {0, 1}
    assert sorted(r["local"] for r in reports) == [2, 3]
    # Every process saw the totals across the group.
    assert all(r["total"] == N_ITEMS for r in reports)
    assert all(r["batch_frames"] == 4 and r["blocks"] == 4 * 2 * 6
               for r in reports)


def test_two_process_distributed_corpus_cli(tmp_path):
    """``corpus --distributed`` in two processes configured by torchrun's
    variables: the items split 2 / 3 and every report aggregates 5."""
    corpus_dir = tmp_path / "corpus"
    corpus_dir.mkdir()
    for i in range(N_ITEMS):
        (corpus_dir / f"img{i}.jpg").write_bytes(
            encode_rgb(synthetic_image(48 + 16 * i, 48, seed=i)))
    port = _free_port()
    envs = []
    for rank in range(2):
        env = _env()
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE="2", RANK=str(rank))
        envs.append(env)
    argv = [sys.executable, "-m", "jpeg_tpu_torch", "corpus", str(corpus_dir),
            "--distributed", "--device", "cpu"]
    outs = _run_pair([argv, argv], envs)
    reports = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    assert sorted(r["decoded"] for r in reports) == [2, 3]
    assert sorted(r["process_index"] for r in reports) == [0, 1]
    for r in reports:
        assert r["process_count"] == 2
        assert r["aggregate"]["decoded"] == float(N_ITEMS)
        assert r["aggregate"]["failed"] == 0.0
        assert r["aggregate"]["frames_per_s"] > 0


def test_single_process_without_configuration(monkeypatch):
    """No address and no torchrun variables: one process of one, no group,
    and the metrics pass through, as in the JAX package."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize() == (0, 1) == ref.initialize()
    assert not dist.is_initialized()
    metrics = {"frames": 3.0, "failed": 1.0}
    assert distributed.aggregate_metrics(metrics) == metrics
    assert ref.aggregate_metrics(metrics) == metrics


def test_unreachable_coordinator_raises():
    """A configured coordinator that nobody serves raises once the wait
    runs out; the process does not go on alone."""
    with pytest.raises(RuntimeError, match="timed out"):
        distributed.initialize(f"127.0.0.1:{_free_port()}", num_processes=2,
                               process_id=1, timeout_s=2)
    assert not dist.is_initialized()


@pytest.mark.parametrize("args", [(400.0, 4, 100.0), (90.0, 2, 50.0),
                                  (10.0, 0, 5.0), (10.0, 2, 0.0)])
def test_scaling_efficiency_matches_jax(args):
    assert distributed.scaling_efficiency(*args) == ref.scaling_efficiency(
        *args)
