"""The encoder's Huffman pack (``ops/huffman_encode.py``, the kernels of
``csrc/huffman_encode.cu``): its plain twin and, on the card, its kernels
give the C++ packer's bytes (``runtime.native_encode_scan`` joined with RST
markers, as ``pack_planes`` packs) for the same planes; ``encode_rgb_device`` packs on the card only
on a CUDA device without ``optimize``, with the spans and the
``device_packed`` count the benchmark reads.

Imports no JAX: the ``cuda`` tests run on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_huffman_encode.py
"""

from __future__ import annotations

import os
import re
import types

import numpy as np
import pytest
import torch

from jpeg_tpu_torch import encode_rgb_device
from jpeg_tpu_torch.io.corpus import synthetic_image
from jpeg_tpu_torch.models import encoder
from jpeg_tpu_torch.models.decoder import PipelineGeometry
from jpeg_tpu_torch.ops import huffman_encode as he
from jpeg_tpu_torch.ops.fused_plane import padded_plane_shapes
from jpeg_tpu_torch.ops.zigzag import ZIGZAG_INDICES
from jpeg_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = [torch.profiler.ProfilerActivity.CPU]
SAMPLINGS = {"420": (2, 2), "422": (2, 1), "444": (1, 1), "gray": None}
RESTARTS = ["none", "1", "7", "row"]  # MCUs a segment; 7 ends mid-row


def _geom(width, height, sampling) -> PipelineGeometry:
    s = ((1, 1),) if sampling is None else (tuple(sampling), (1, 1), (1, 1))
    h_max, v_max = max(h for h, _ in s), max(v for _, v in s)
    return PipelineGeometry(
        width=width, height=height, mcus_x=-(-width // (8 * h_max)),
        mcus_y=-(-height // (8 * v_max)), h_max=h_max, v_max=v_max,
        sampling=s, color_model="gray" if sampling is None else "ycbcr")


def _restart(name, geom) -> int:
    return {"none": 0, "1": 1, "7": 7, "row": geom.mcus_x}[name]


def _planes(geom, seed, kind="dense") -> list[np.ndarray]:
    """Random int16 planes in K2's padded layout. ``dense``: each block
    holds few, half or nearly all nonzero values up to +-1023 (long zero
    runs give ZRLs, dense blocks many 0xFF bytes), and a few at +-32767,
    whose size has no code in the Annex K tables; ``sparse``: a q85 frame's
    share of small values."""
    rng = np.random.default_rng(seed)
    out = []
    for rows, cols in padded_plane_shapes(geom):
        if kind == "dense":
            share = rng.choice([0.05, 0.5, 0.95], (rows // 8, cols // 8))
            keep = rng.random((rows, cols)) < np.kron(share, np.ones((8, 8)))
            x = np.where(keep, rng.integers(-1023, 1024, (rows, cols)), 0)
            x[rng.random((rows, cols)) < 0.002] = 32767
            x[rng.random((rows, cols)) < 0.002] = -32767
        else:
            x = np.where(rng.random((rows, cols)) < 0.08,
                         rng.integers(-40, 41, (rows, cols)), 0)
        out.append(x.astype(np.int16))
    return out


def _tables(geom) -> tuple[list, list]:
    dc_t, ac_t = encoder._huffman_tables(len(geom.sampling) == 1, False)
    return ([encoder._build_encode_maps(t) for t in dc_t],
            [encoder._build_encode_maps(t) for t in ac_t])


def _native(planes, geom, restart) -> bytes:
    """The C++ packer's scan, as ``pack_planes`` makes it."""
    return encoder._native_scan(planes, list(geom.sampling), *_tables(geom),
                                geom.mcus_x, geom.mcus_y, restart)


def _packed(planes, geom, restart, device="cpu") -> bytes:
    return he.huffman_encode([torch.from_numpy(p).to(device) for p in planes],
                             geom, restart,
                             he.pack_tables(*_tables(geom)).to(device))


@pytest.mark.parametrize("restart", RESTARTS)
@pytest.mark.parametrize("size", [(1, 1), (17, 13), (40, 24)])
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
def test_plain_equals_native(sampling, size, restart):
    geom = _geom(*size, SAMPLINGS[sampling])
    r = _restart(restart, geom)
    planes = _planes(geom, seed=size[0] * 31 + len(sampling) + r)
    want = _native(planes, geom, r)
    assert _packed(planes, geom, r) == want
    if size == (40, 24):  # the planes do what the docstring says
        n_mcus = geom.mcus_x * geom.mcus_y
        assert b"\xff\x00" in want
        assert (b"\xff\xd0" in want) == (n_mcus > (r or n_mcus))


@pytest.mark.parametrize("size,sampling,restart", [
    ((1920, 1080), "420", "row"), ((1920, 1080), "422", "none"),
    ((1920, 1080), "444", "7"), ((1920, 1080), "gray", "1"),
    ((3840, 2160), "420", "row"), ((3840, 2160), "420", "none"),
])
def test_plain_equals_native_large(size, sampling, restart):
    geom = _geom(*size, SAMPLINGS[sampling])
    r = _restart(restart, geom)
    planes = _planes(geom, seed=r + 5, kind="sparse")
    assert _packed(planes, geom, r) == _native(planes, geom, r)


def test_kernel_walks_the_zigzag_order():
    """The kernel's list of AC natural indices is ZIGZAG_INDICES[1:]."""
    with open(os.path.join(ROOT, "jpeg_tpu_torch", "csrc",
                           "huffman_encode.cu")) as f:
        src = f.read()
    body = re.search(r"#define JT_ZIGZAG_AC\(X\)(.*?)\n\n", src, re.S).group(1)
    assert [int(n) for n in re.findall(r"X\((\d+)\)", body)] == list(
        ZIGZAG_INDICES[1:])


def test_pack_tables_layout():
    dc_maps, ac_maps = _tables(_geom(8, 8, None))
    t = he.pack_tables(dc_maps, ac_maps)
    assert t.dtype == torch.int32 and t.shape == (2, 2, 256)
    assert torch.equal(t[0], t[1])  # gray: one table in both ids
    code, length = ac_maps[0]
    assert np.array_equal((t[0, 1] >> 16).numpy(), length)
    assert np.array_equal((t[0, 1] & 0xFFFF).numpy(), code)


def test_pack_refuses_what_it_does_not_take():
    geom = _geom(16, 16, (2, 2))
    planes = [torch.from_numpy(p) for p in _planes(geom, 1)]
    tables = he.pack_tables(*_tables(geom))
    with pytest.raises(ValueError, match="components"):
        he.huffman_encode(planes[:2], geom, 0, tables)
    with pytest.raises(ValueError, match="int16"):
        he.huffman_encode([p.int() for p in planes], geom, 0, tables)
    with pytest.raises(ValueError, match="tables"):
        he.huffman_encode(planes, geom, 0, tables.long())
    with pytest.raises(ValueError, match="restart"):
        he.huffman_encode(planes, geom, -1, tables)


class _OnCard:
    """A CPU tensor that says it lies on a CUDA device: drives
    ``encode_rgb_device``'s card route on a machine without one."""

    def __init__(self, t):
        self.t = t
        self.device = types.SimpleNamespace(type="cuda")

    def __getitem__(self, i):
        return _OnCard(self.t[i])

    def cpu(self):
        return self.t


@pytest.fixture
def on_card(monkeypatch):
    """The frame's upload kept on the CPU (laid out there by the card
    route's own ``planar_layout``), K2's planes handed back as if on a
    card; the device pack gets the real CPU tensors (its plain twin).
    Returns the packs' calls."""
    import jpeg_tpu_torch.parallel.batch as batch

    real_k2, real_pack = batch.encode_batch_device, encoder.pack_planes_device
    calls = {"device": 0, "host": 0}
    real_host = encoder.pack_planes

    def k2(*args, device, **kwargs):
        planes = real_k2(*args, device="cpu", **kwargs)
        return [_OnCard(p) for p in planes] if device == "cuda" else planes

    def device_pack(planes, *args):
        calls["device"] += 1
        return real_pack([p.t for p in planes], *args)

    def host_pack(*args):
        calls["host"] += 1
        return real_host(*args)

    monkeypatch.setattr(encoder, "upload_frame",
                        lambda rgb, device: torch.from_numpy(rgb))
    monkeypatch.setattr(batch, "encode_batch_device", k2)
    monkeypatch.setattr(encoder, "pack_planes_device", device_pack)
    monkeypatch.setattr(encoder, "pack_planes", host_pack)
    return calls


def _profiled(fn):
    before = {c.id for c in profiling.recorded_calls()}
    with torch.profiler.profile(activities=CPU):
        data = fn()
    (call,) = [c for c in profiling.recorded_calls() if c.id not in before]
    spans = profiling.recorded_spans([call.id])
    root = next(s for s in spans if s.parent == 0)
    kids = sorted((s for s in spans if s.parent == root.id),
                  key=lambda s: s.start_ns)
    return data, call, root, [s.name for s in kids]


@pytest.mark.parametrize("kwargs", [
    dict(restart_interval_mcus=3),
    dict(subsampling=(1, 1)),
    dict(grayscale=True, restart_interval_mcus=2),
])
def test_card_route_packs_on_the_card(on_card, kwargs):
    """On a card without ``optimize``: the frame laid out on the card, the
    device pack, the same bytes as the CPU route, no ``encode.d2h``,
    ``device_packed`` 1."""
    img = synthetic_image(72, 40, 5)
    if kwargs.get("grayscale"):
        img = img[..., 0]
    want = encode_rgb_device(img, device="cpu", **kwargs)
    assert on_card == {"device": 0, "host": 1}
    data, _, root, kids = _profiled(
        lambda: encode_rgb_device(img, device="cuda", **kwargs))
    assert data == want and on_card == {"device": 1, "host": 1}
    assert kids == ["encode.prepare", "encode.upload", "encode.k2",
                    "encode.pack"]
    assert root.counts == {"frames": 1, "bytes_in": img.nbytes,
                           "bytes_out": len(data), "device_packed": 1}


def test_card_route_with_optimize_packs_on_the_host(on_card):
    img = synthetic_image(72, 40, 6)
    want = encode_rgb_device(img, device="cpu", optimize=True)
    data, _, root, kids = _profiled(
        lambda: encode_rgb_device(img, device="cuda", optimize=True))
    assert data == want and on_card == {"device": 0, "host": 2}
    assert kids == ["encode.prepare", "encode.upload", "encode.k2",
                    "encode.d2h", "encode.pack"]
    assert root.counts["device_packed"] == 0


@pytest.mark.parametrize("optimize", [False, True])
def test_cpu_route_packs_on_the_host(on_card, optimize):
    img = synthetic_image(72, 40, 7)
    _, _, root, kids = _profiled(
        lambda: encode_rgb_device(img, device="cpu", optimize=optimize))
    assert on_card == {"device": 0, "host": 1}
    assert kids == ["encode.prepare", "encode.k2", "encode.d2h", "encode.pack"]
    assert "device_packed" not in root.counts


def test_device_pack_share_reads_the_count(on_card):
    """``device_pack_share.encode`` reads 100 where the calls packed on the
    card, 0 where ``optimize`` kept the pack on the host, and nothing where
    no call carries the count (the CPU route, a program without it)."""
    from benchmark.spec import reader

    read = reader(ROOT, "device_pack_share.encode")
    img = synthetic_image(72, 40, 8)
    shares = []
    for kw in (dict(device="cuda"), dict(device="cuda", optimize=True),
               dict(device="cpu")):
        _, call, root, _ = _profiled(lambda: encode_rgb_device(img, **kw))
        window = (call.to_unix_ns(root.start_ns) * 1e-9,
                  call.to_unix_ns(root.end_ns) * 1e-9)
        shares.append(read(types.SimpleNamespace(
            entry="encode_rgb_device",
            trace=types.SimpleNamespace(window=window))))
    assert shares == [100.0, 0.0, None]


# ---- on the card ----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("restart", RESTARTS)
@pytest.mark.parametrize("size,kind", [((1, 1), "dense"), ((17, 13), "dense"),
                                       ((1920, 1080), "dense"),
                                       ((3840, 2160), "sparse")])
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
def test_kernels_equal_native(cuda, sampling, size, kind, restart):
    geom = _geom(*size, SAMPLINGS[sampling])
    r = _restart(restart, geom)
    planes = _planes(geom, seed=size[0] + r, kind=kind)
    before = he.LAUNCHES.value
    got = _packed(planes, geom, r, cuda)
    torch.cuda.synchronize()
    assert he.LAUNCHES.value == before + 1
    assert got == _native(planes, geom, r)
    assert got == _packed(planes, geom, r, cuda)  # the scratch was left clean


@pytest.mark.cuda
@pytest.mark.parametrize("restart", ["row", "none"])
def test_pool_frames_pack_on_the_card(cuda, restart):
    """Four frames of the encode cell's pool at q85: ``encode_rgb_device``
    on the card gives ``pack_planes``' bytes for K2's own planes, moves the
    pack's counter once a frame, records ``device_packed`` 1 and the card
    route's spans."""
    from benchmark.inputs import rgb_pool

    from jpeg_tpu_torch.parallel.batch import encode_batch_device

    seed = 2500 + RESTARTS.index(restart)
    for n, img in enumerate(rgb_pool(3840, 2160, 4, seed, cuda)):
        geom, planar, iq, quant_zz = encoder.device_inputs(img, 85, (2, 2))
        r = _restart(restart, geom)
        k2 = encode_batch_device(planar[None], iq[None], geom, device=cuda)
        want = encoder.pack_planes([p[0].cpu().numpy() for p in k2], geom,
                                   quant_zz, r)
        before = he.LAUNCHES.value
        data, _, root, kids = _profiled(lambda: encode_rgb_device(
            img, quality=85, subsampling=(2, 2), restart_interval_mcus=r,
            device=cuda))
        torch.cuda.synchronize()
        assert data == want, f"frame {n}"
        assert he.LAUNCHES.value == before + 1
        assert root.counts["device_packed"] == 1
        assert kids == ["encode.prepare", "encode.upload", "encode.k2",
                        "encode.pack"]


@pytest.mark.cuda
def test_one_scratch_serves_every_geometry(cuda):
    """One scratch a card, remade larger only when a call needs more blocks
    or segments than it holds: smaller geometries pack in it (and leave its
    words clean for the next), a larger one grows it once."""
    cases = [((1920, 1080), "420", "row"), ((17, 13), "444", "1"),
             ((40, 24), "gray", "7"), ((1920, 1080), "422", "none"),
             ((1920, 1080), "420", "row")]
    he._scratch.clear()
    held = []
    for size, sampling, restart in cases:
        geom = _geom(*size, SAMPLINGS[sampling])
        r = _restart(restart, geom)
        planes = _planes(geom, seed=size[1] + r)
        assert _packed(planes, geom, r, cuda) == _native(planes, geom, r)
        (sc,) = he._scratch.values()
        held.append(sc)
    assert held[0] is held[1] is held[2]
    assert held[3] is not held[2] and held[4] is held[3]
    # 1080p 4:2:2: 120 x 135 MCUs of 4 blocks; 4:2:0's 68 row segments
    assert (held[3].n_blocks, held[3].n_segs) == (120 * 135 * 4, 68)
