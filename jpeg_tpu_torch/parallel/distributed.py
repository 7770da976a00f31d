"""Multi-process coordination on ``torch.distributed``.

Counterpart of ``jpeg_tpu/parallel/distributed.py``: static sharding of a
corpus over processes (images across hosts, no collective in the decode
itself; ``io/corpus.py::shard_items``) and a sum across processes for the
metrics alone. The group uses the gloo backend: its one collective adds a
few float64 host numbers, as the JAX version gathers them on the host, so
no device needs to take part.

Configuration comes from the arguments or from torchrun's variables
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) where the JAX
version reads ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
``JAX_PROCESS_ID``. Without either the process runs alone, ``(0, 1)``,
and no group is made. A configured coordinator that cannot be reached
raises; it never turns into a single-process run.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

# Seconds a process waits for the others to join the group.
TIMEOUT_S = 60.0


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               timeout_s: float = TIMEOUT_S) -> tuple[int, int]:
    """Join the process group when one is configured; returns (index,
    count). ``coordinator_address`` is ``host:port``; process 0 listens
    there."""
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if coordinator_address and not dist.is_initialized():
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}",
            world_size=(num_processes if num_processes is not None
                        else int(env.get("WORLD_SIZE", "1"))),
            rank=(process_id if process_id is not None
                  else int(env.get("RANK", "0"))),
            timeout=datetime.timedelta(seconds=timeout_s))
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def aggregate_metrics(metrics: dict[str, float]) -> dict[str, float]:
    """Sum numeric metrics across every process of the group (frames/s
    accounting for a corpus run). Without a group, or alone in one: the
    identity."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return dict(metrics)
    keys = sorted(metrics)
    local = torch.tensor([float(metrics[k]) for k in keys],
                         dtype=torch.float64)
    dist.all_reduce(local, op=dist.ReduceOp.SUM)
    return {k: float(v) for k, v in zip(keys, local.tolist())}


def scaling_efficiency(total_fps: float, n_hosts: int,
                       single_host_fps: float) -> float:
    """Frames/s scaling efficiency at N hosts (1.0 = perfect linear
    scaling)."""
    if single_host_fps <= 0 or n_hosts <= 0:
        return 0.0
    return total_fps / (single_host_fps * n_hosts)
