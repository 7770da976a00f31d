"""The (data, seg) device grid the sharded batch functions run on.

Counterpart of ``jpeg_tpu/parallel/mesh.py``. Axes, as there:

- ``data``: images across devices (data parallelism, no collective in the
  decode itself);
- ``seg``: horizontal bands of each image across devices (MCU rows are
  independent in pixel space, so each band decodes with a local geometry).

A :class:`Mesh` is one process's devices, as a JAX mesh is in a
single-process run; it is not a ``torch.distributed`` device mesh, which
needs a process group as large as the grid. Unlike a JAX mesh, a grid may
name one device more than once (PyTorch has one CPU device, and several
shards may share one card): shards on the same device run one after the
other. Across processes the only collective is the metrics sum of
:mod:`jpeg_tpu_torch.parallel.distributed`.
"""

from __future__ import annotations

import dataclasses

import torch

AXES = ("data", "seg")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices[i][j]``: the device of data shard ``i``, band ``j``."""

    devices: tuple[tuple[torch.device, ...], ...]
    axis_names = AXES  # a class constant, not a field

    def __post_init__(self):
        rows = self.devices
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError(f"a mesh is a non-empty [n_data, n_seg] grid, got "
                             f"row lengths {[len(r) for r in rows]}")

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.devices), "seg": len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    @property
    def first(self) -> torch.device:
        """The device the sharded functions gather their result on."""
        return self.devices[0][0]


def make_mesh(n_data: int | None = None, n_seg: int = 1,
              devices=None) -> Mesh:
    """A (data, seg) grid of the first ``n_data * n_seg`` of ``devices``
    (default: every visible CUDA device, all on the data axis). Raises when
    no CUDA device is visible and none are given: a mesh is never made of
    the CPU unless the caller names it."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "make_mesh: no CUDA device (torch.cuda.is_available() is "
                "False); pass devices= to build a mesh of other devices")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_seg
    if n_data < 1 or n_seg < 1 or n_data * n_seg > len(devices):
        raise ValueError(f"cannot make a ({n_data}, {n_seg}) mesh of "
                         f"{len(devices)} devices")
    return Mesh(tuple(tuple(devices[i * n_seg : (i + 1) * n_seg])
                      for i in range(n_data)))


@dataclasses.dataclass(frozen=True)
class DataSharding:
    """Dimension ``spec.index("data")`` of a tensor split over the mesh's
    data axis, replicated over ``seg`` (each shard runs once, on the first
    device of its row). ``spec`` is the JAX ``PartitionSpec``'s tuple."""

    mesh: Mesh
    spec: tuple

    @property
    def axis(self) -> int:
        return self.spec.index("data")

    def split(self, x: torch.Tensor) -> list[torch.Tensor]:
        """One contiguous shard of ``x`` on each data row's device. A size
        that ``n_data`` does not divide raises ``ValueError``, as a JAX
        sharded ``jit`` does."""
        n = self.mesh.shape["data"]
        if x.shape[self.axis] % n:
            raise ValueError(
                f"dimension {self.axis} of size {x.shape[self.axis]} is not "
                f"evenly divisible by the mesh's data axis ({n})")
        return [s.to(row[0]).contiguous()
                for s, row in zip(torch.chunk(x, n, self.axis),
                                  self.mesh.devices)]

    def gather(self, shards) -> torch.Tensor:
        """The shards joined again on the mesh's first device (one shard is
        returned as it is, not copied)."""
        shards = [s.to(self.mesh.first) for s in shards]
        return shards[0] if len(shards) == 1 else torch.cat(shards, self.axis)


def data_sharding(mesh: Mesh, rank: int, axis: int = 0) -> DataSharding:
    """Shard dimension ``axis`` of a rank-``rank`` tensor over the data axis."""
    spec = [None] * rank
    spec[axis] = "data"
    return DataSharding(mesh, tuple(spec))
