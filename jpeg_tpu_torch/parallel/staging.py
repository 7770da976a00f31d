"""Reused host memory for the corpus decoder's transfers: K1's input
staged one slot per frame, and the RGB it returns, one buffer per geometry.

:class:`~jpeg_tpu_torch.parallel.pipeline.BatchedCorpusDecoder` writes each
frame's int16 coefficient planes into the next free slot of its geometry's
buffer as soon as they exist (a host worker copies them out of the
runtime's thread scratch, the device thread copies K3's relayouted planes
down from the card), and marks the slot filled once the copy returns
(:meth:`Staging.fill`). Slots are taken in the order frames finish and
never left empty, so the filled slots from 0 form a prefix that only
grows: a run of consecutive filled slots is K1's input as it stands,
while the workers fill the slots after it. Nothing is gathered, and the
buffer's pages were touched once, not once a call. The caller waits on
:meth:`Staging.wait_runs` for such runs during the entropy phase (the
slots the buffer held at the call's start), and takes the rest of each
bucket, ``0..n-1`` less what ran, once every slot is filled
(:meth:`Staging.bucket`).

A buffer is page-locked by registering its exact allocation with the CUDA
runtime (``cudaHostRegister``; a caching pinned allocation would round
1.6 GB up to 2 GB), so K1's input goes up by DMA. Where there is no CUDA
device, or the runtime refuses, the same buffer serves unpinned.

Life of a buffer: it is made in the pixel stage of the first call that
holds its geometry, grows only when a call holds more frames of its geometry than it
has slots, and is given up at the end of a call that holds none. A frame
whose slot the buffer does not have yet keeps its own copy of its planes,
which :meth:`Staging.bucket` moves into the grown buffer. One call at a
time: slots belong to the call in progress.

The RGB comes down the same way, by DMA into a page-locked
``[frames, height, width, 3]`` u8 buffer of its geometry
(:meth:`Staging.results`), whose views are the call's results. The caller
owns them for as long as it holds them, so a result buffer is reused only
once nothing refers to it any more. While it is still held (a caller that
keeps one call's results through the next) a second is made; while both
are held, a call's RGB goes to fresh pageable memory. Result buffers are
given up like the slots.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import weakref

import numpy as np
import torch

from jpeg_tpu_torch.ops.fused_plane import padded_plane_shapes

# cudaHostRegisterPortable: page-locked for every card's context, as a
# mesh's data shards upload from one buffer to several cards.
_PORTABLE = 1

# Page-locked result buffers a geometry: the call's, and the one a caller
# still holds from the call before.
RESULT_BUFFERS = 2


def page_lock(array: np.ndarray, device: torch.device):
    """Page-lock ``array``'s memory, exactly its bytes, for DMA to and from
    ``device``'s card. Returns the callable that unlocks it now (it also
    runs when the array is collected), or None where ``device`` is not a
    CUDA device or the runtime refuses (the array then stays pageable)."""
    if device.type != "cuda":
        return None
    rt = torch.cuda.cudart()
    ptr = array.ctypes.data
    with torch.cuda.device(device):
        if int(rt.cudaHostRegister(ptr, array.nbytes, _PORTABLE)):
            # The runtime keeps the refusal as this thread's last error,
            # which PyTorch's next launch check would raise as its own
            # failure: consume it with a launch of ours.
            with contextlib.suppress(RuntimeError):
                torch.ones(1, device=device)
            return None
    unlock = weakref.finalize(array, rt.cudaHostUnregister, ptr)
    unlock.atexit = False  # the process's end frees it; CUDA may be gone
    return unlock


class _Buffer:
    """One geometry's slots: per component a [capacity, rows, stride] int16
    view of one allocation."""

    def __init__(self, geom, capacity: int, device: torch.device):
        shapes = padded_plane_shapes(geom)
        sizes = [capacity * r * s for r, s in shapes]
        self.base = np.empty(sum(sizes), np.int16)
        offsets = np.cumsum([0] + sizes)
        self.planes = [self.base[a:b].reshape(capacity, *shape)
                       for a, b, shape in zip(offsets, offsets[1:], shapes)]
        self.capacity = capacity
        self._unlock = page_lock(self.base, device)
        self.pinned = self._unlock is not None

    def release(self) -> None:
        if self._unlock is not None:
            self._unlock()
        self.base = self.planes = None


class _Results:
    """One geometry's RGB: a [capacity, height, width, 3] u8 allocation."""

    def __init__(self, geom, capacity: int, device: torch.device):
        self.array = np.empty((capacity, geom.height, geom.width, 3), np.uint8)
        self.capacity = capacity
        self._unlock = page_lock(self.array, device)
        self.pinned = self._unlock is not None
        self._own_refs = sys.getrefcount(self.array)

    def held(self) -> bool:
        """Whether anything but this buffer refers to its array: every
        result, every view of one and every tensor made from one does."""
        return sys.getrefcount(self.array) > self._own_refs

    def release(self) -> None:
        """Unlock the pages and drop the array; a caller that still holds
        results keeps them, pageable."""
        if self._unlock is not None:
            self._unlock()
        self.array = None


class Staging:
    """The per-geometry buffers of one decoder, K1's input slots and the
    RGB results (``device``: the card K1 runs on, whose runtime page-locks
    them)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.buffers: dict = {}  # geometry -> _Buffer
        self.rgb: dict = {}      # geometry -> [_Results], at most RESULT_BUFFERS
        self._taken: dict = {}   # geometry -> slots taken in this call
        self._filled: dict = {}  # geometry -> {slot: frame}, not yet in a run
        self._ran: dict = {}     # geometry -> slots handed out in runs
        self._lock = threading.Lock()
        self._changed = threading.Condition(self._lock)

    def begin(self) -> None:
        """Start a call: no slot taken, filled or run."""
        self._taken, self._filled, self._ran = {}, {}, {}

    def take(self, geom) -> tuple[int, list | None]:
        """The next free slot of ``geom`` in this call, with its
        per-component [rows, stride] views; the views are None where the
        buffer has no such slot yet. Any thread; take a slot only for planes
        that exist, so that a bucket's slots have no holes, and
        :meth:`fill` it once they are copied into the views."""
        with self._lock:
            slot = self._taken.get(geom, 0)
            self._taken[geom] = slot + 1
            buf = self.buffers.get(geom)
        if buf is None or slot >= buf.capacity:
            return slot, None
        return slot, [p[slot] for p in buf.planes]

    def fill(self, geom, slot: int, frame) -> None:
        """Mark ``geom``'s ``slot`` filled with the planes of ``frame`` (the
        caller's name for it, handed back by :meth:`wait_runs`). Any thread,
        after the copy into the slot's views has returned."""
        with self._changed:
            self._filled.setdefault(geom, {})[slot] = frame
            self._changed.notify_all()

    def wake(self, *_) -> None:
        """Wake :meth:`wait_runs` to test its ``done`` again (a future's
        done callback)."""
        with self._changed:
            self._changed.notify_all()

    def wait_runs(self, least: int, done) -> list | None:
        """Block until some geometry has at least ``least`` consecutive
        filled slots after the last run handed out, and hand out every such
        run whole: ``[(geom, frames in slot order)]``, its first slot the
        geometry's first not yet run. None, at once, when ``done()`` holds
        (tested under the lock; whatever makes it true calls :meth:`wake`).
        The caller's thread."""
        with self._changed:
            while not done():
                runs = []
                for geom, filled in self._filled.items():
                    lo = hi = self._ran.get(geom, 0)
                    while hi in filled:
                        hi += 1
                    if hi - lo >= least:
                        runs.append((geom, [filled.pop(s)
                                            for s in range(lo, hi)]))
                        self._ran[geom] = hi
                if runs:
                    return runs
                self._changed.wait()
            return None

    def bucket(self, geom, unslotted: dict) -> tuple[_Buffer, int]:
        """``geom``'s buffer with a slot for every frame of this call, and
        the bytes copied to make it. The caller's thread, once every slot
        is filled (runs handed out by :meth:`wait_runs` read the buffer as
        it stands before then). Where the call took more slots than the
        buffer has, a buffer of the call's size replaces it: the old slots
        are copied over, and so are ``unslotted`` (slot -> planes: the
        frames whose slot the old buffer lacked)."""
        n = self._taken.get(geom, 0)
        old = self.buffers.get(geom)
        if old is not None and old.capacity >= n:
            return old, 0
        new = _Buffer(geom, n, self.device)
        copied = 0
        if old is not None:
            for dst, src in zip(new.planes, old.planes):
                dst[: old.capacity] = src
                copied += src.nbytes
            old.release()
        for slot, planes in unslotted.items():
            for dst, p in zip(new.planes, planes):
                dst[slot] = p
                copied += p.nbytes
        self.buffers[geom] = new
        return new, copied

    def results(self, geom, n: int) -> tuple[np.ndarray, bool]:
        """An ``[n, height, width, 3]`` u8 array for this call's RGB of
        ``geom``, one row a slot, and whether it is page-locked; once a call
        and geometry, on the caller's thread. A buffer of the geometry that
        nothing refers to any more is reused, grown to ``n`` where it is
        smaller; while every buffer is held a new one is made, up to
        ``RESULT_BUFFERS``, and past them the array is fresh pageable
        memory."""
        pool = self.rgb.setdefault(geom, [])
        buf = max((b for b in pool if not b.held()), default=None,
                  key=lambda b: b.capacity)
        if buf is not None and buf.capacity < n:
            pool.remove(buf)
            buf.release()
            buf = None
        if buf is None and len(pool) < RESULT_BUFFERS:
            buf = _Results(geom, n, self.device)
            pool.append(buf)
        if buf is None:
            return np.empty((n, geom.height, geom.width, 3), np.uint8), False
        return buf.array[:n], buf.pinned

    def end(self, geoms) -> None:
        """End a call: give up the buffers of geometries it did not hold."""
        for geom in [g for g in self.buffers if g not in geoms]:
            self.buffers.pop(geom).release()
        for geom in [g for g in self.rgb if g not in geoms]:
            for buf in self.rgb.pop(geom):
                buf.release()

    def close(self) -> None:
        for buf in self.buffers.values():
            buf.release()
        for pool in self.rgb.values():
            for buf in pool:
                buf.release()
        self.buffers, self.rgb = {}, {}
