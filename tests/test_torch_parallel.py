"""Scale-out in jpeg_tpu_torch against jpeg_tpu: the (data, seg) mesh, the
sharded batch decoders and encoder, the corpus decoder under a mesh and
``dryrun_multichip``.

One case for each case of ``tests/test_parallel.py``, on seeded frames (the
JAX tests' lena is not in the repository). JAX runs on the 8-device virtual
CPU mesh of ``tests/conftest.py``, its Pallas kernels in interpret mode;
the port runs its plain twins on grids of ``torch.device("cpu")``, which a
port mesh may name more than once.

Tolerances: the port's sharded output equals its own unsharded output bit
for bit; against JAX it keeps the bar of the port's unsharded test of the
same function: +-1 u8 on under 5% of pixels (``test_torch_corpus.py``,
``test_torch_fused_plane.py``), and for K2's planes |diff| <= 1 on under
1e-4 of the coefficients (``test_torch_encoder.py``). Counts are exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from jpeg_tpu.io.container import parse_jpeg as ref_parse
from jpeg_tpu.io.corpus import synthetic_image
from jpeg_tpu.models.decoder import PipelineGeometry as RefGeometry
from jpeg_tpu.models.decoder import decode_coefficients_host, plan_matrices
from jpeg_tpu.models.encoder import encode_rgb
from jpeg_tpu.ops.pallas_kernels import plan_inv_quant_patterns
from jpeg_tpu.ops.pallas_kernels import plan_quant_patterns as ref_qpats
from jpeg_tpu.parallel import batch as ref
from jpeg_tpu.parallel import mesh as ref_mesh
from jpeg_tpu.parallel.pipeline import BatchedCorpusDecoder as RefDecoder
from jpeg_tpu.runtime import native_decode_planes
from jpeg_tpu_torch import BatchedCorpusDecoder
from jpeg_tpu_torch.io.container import parse_jpeg
from jpeg_tpu_torch.models import encoder as enc
from jpeg_tpu_torch.models.decoder import PipelineGeometry
from jpeg_tpu_torch.ops import fused_plane
from jpeg_tpu_torch.ops.fused_encode import plan_inv_quant_tables
from jpeg_tpu_torch.parallel import batch
from jpeg_tpu_torch.parallel.dryrun import dryrun_multichip
from jpeg_tpu_torch.parallel.mesh import data_sharding, make_mesh

CPU8 = [torch.device("cpu")] * 8


def _mesh(n_data, n_seg=1):
    return make_mesh(n_data, n_seg, devices=CPU8)


def _within_one(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.05


def _frame(width, height, seed, quality=85):
    """A seeded 4:2:0 frame with a restart marker per MCU row."""
    return encode_rgb(synthetic_image(width, height, seed=seed),
                      quality=quality, subsampling=(2, 2),
                      restart_interval_mcus=-(-width // 16))


@pytest.fixture(scope="module")
def compat_batch():
    """Eight frames of one geometry (mcus_y 4), different quality each:
    (port geometry, JAX geometry, coefficients, matrices)."""
    refs = [ref_parse(_frame(48, 64, seed=s, quality=60 + 4 * s))
            for s in range(8)]
    coeffs = np.stack([decode_coefficients_host(p).copy() for p in refs])
    mats = np.stack([plan_matrices(p) for p in refs])
    geom = PipelineGeometry.of(parse_jpeg(_frame(48, 64, seed=0)))
    return geom, RefGeometry.of(refs[0]), coeffs, mats


def _fast_batch(width, height, n):
    """K1's inputs for ``n`` seeded frames of one geometry: planes, the
    port's tables, JAX's patterns, the two geometries."""
    datas = [_frame(width, height, seed=s, quality=70 + 3 * s)
             for s in range(n)]
    refs = [ref_parse(d) for d in datas]
    rgeom = RefGeometry.of(refs[0])
    planes = [np.stack([native_decode_planes(p)[c].copy() for p in refs])
              for c in range(3)]
    qpats = [np.stack([ref_qpats(p, rgeom)[c] for p in refs])
             for c in range(3)]
    ports = [parse_jpeg(d) for d in datas]
    geom = PipelineGeometry.of(ports[0])
    qtabs = np.stack([fused_plane.plan_quant_patterns(p, geom) for p in ports])
    return planes, qtabs, qpats, geom, rgeom


@pytest.mark.parametrize("n_data,n_seg", [(4, 2), (8, 1), (2, 4), (None, 2)])
def test_mesh_shape(n_data, n_seg):
    ours = make_mesh(n_data=n_data, n_seg=n_seg, devices=CPU8)
    theirs = ref_mesh.make_mesh(n_data=n_data, n_seg=n_seg)
    assert ours.shape == dict(theirs.shape)
    assert ours.axis_names == theirs.axis_names == ("data", "seg")
    assert ours.size == theirs.devices.size
    assert ours.first == torch.device("cpu")


def test_mesh_rejects_what_jax_rejects():
    with pytest.raises(ValueError):
        ref_mesh.make_mesh(n_data=8, n_seg=2)
    with pytest.raises(ValueError):
        make_mesh(n_data=8, n_seg=2, devices=CPU8)


@pytest.mark.parametrize("n_data,n_seg", [(8, 1), (4, 2)])
def test_batch_sharded_matches(compat_batch, n_data, n_seg):
    geom, rgeom, coeffs, mats = compat_batch
    got = batch.decode_batch(coeffs, mats, geom, mesh=_mesh(n_data, n_seg))
    assert got.device.type == "cpu" and got.shape == (8, 64, 48, 3)
    assert torch.equal(got, batch.decode_batch(coeffs, mats, geom,
                                               device="cpu"))
    want = ref.decode_batch(coeffs, mats, rgeom,
                            mesh=ref_mesh.make_mesh(n_data, n_seg))
    _within_one(got.numpy(), want)


def test_batch_metrics_sum(compat_batch):
    geom, rgeom, coeffs, mats = compat_batch
    out, frames, blocks = batch.decode_batch_with_metrics(
        coeffs, mats, geom, _mesh(8))
    rout, rframes, rblocks = ref.decode_batch_with_metrics(
        coeffs, mats, rgeom, ref_mesh.make_mesh(8, 1))
    assert frames == int(rframes) == 8
    assert blocks == int(rblocks) == 8 * geom.total_blocks
    assert torch.equal(out, batch.decode_batch(coeffs, mats, geom,
                                               device="cpu"))
    _within_one(out.numpy(), rout)


def test_rows_sp_matches(compat_batch):
    """Images over the data axis AND MCU-row bands over seg."""
    geom, rgeom, coeffs, mats = compat_batch
    out, frames = batch.decode_batch_rows_sp(coeffs[:4], mats[:4], geom,
                                             _mesh(4, 2))
    rout, rframes = ref.decode_batch_rows_sp(coeffs[:4], mats[:4], rgeom,
                                             ref_mesh.make_mesh(4, 2))
    assert frames == int(rframes) == 4
    assert torch.equal(out, batch.decode_batch(coeffs[:4], mats[:4], geom,
                                               device="cpu"))
    _within_one(out.numpy(), rout)


def _bad(geom):
    """Geometries row sharding refuses: mcus_y not divisible by n_seg 4, and
    a partial bottom MCU row."""
    return [dataclasses.replace(geom, mcus_y=geom.mcus_y - 1),
            dataclasses.replace(geom, height=geom.height - 1)]


@pytest.mark.parametrize("case", [0, 1])
def test_rows_sp_rejects_bad_geometry(compat_batch, case):
    geom, rgeom, coeffs, mats = compat_batch
    with pytest.raises(ValueError, match="row sharding"):
        ref.decode_batch_rows_sp(coeffs[:2], mats[:2], _bad(rgeom)[case],
                                 ref_mesh.make_mesh(2, 4))
    with pytest.raises(ValueError, match="row sharding"):
        batch.decode_batch_rows_sp(coeffs[:2], mats[:2], _bad(geom)[case],
                                   _mesh(2, 4))


@pytest.mark.parametrize("fn", ["decode_batch", "decode_batch_with_metrics",
                                "decode_batch_rows_sp"])
def test_indivisible_batch_raises_value_error(compat_batch, fn):
    """Six frames over four data shards: a sharded JAX jit and shard_map
    raise ValueError, and so does the port."""
    geom, rgeom, coeffs, mats = compat_batch
    with pytest.raises(ValueError):
        getattr(ref, fn)(coeffs[:6], mats[:6], rgeom,
                         mesh=ref_mesh.make_mesh(4, 2))
    with pytest.raises(ValueError, match="divisible"):
        getattr(batch, fn)(coeffs[:6], mats[:6], geom, mesh=_mesh(4, 2))


def test_indivisible_fast_and_encode_batches_raise_value_error():
    planes, qtabs, qpats, geom, rgeom = _fast_batch(64, 32, 6)
    with pytest.raises(ValueError):
        ref.decode_batch_fast(planes, qpats, rgeom,
                              mesh=ref_mesh.make_mesh(4, 1))
    with pytest.raises(ValueError, match="divisible"):
        batch.decode_batch_fast(planes, qtabs, geom, mesh=_mesh(4))
    with pytest.raises(ValueError, match="divisible"):
        batch.decode_batch_rows_sp_fast(planes, qtabs, geom, _mesh(4))
    rgb = np.zeros((6, 3, 128, 256), np.uint8)
    with pytest.raises(ValueError, match="divisible"):
        batch.encode_batch_device(rgb, np.ones((6, 3, 64), np.float32),
                                  geom, mesh=_mesh(4))


@pytest.mark.parametrize("idct_mode", ["exact", "approx"])
def test_batch_fast_path_sharded(idct_mode):
    """K1's twin sharded over the data axis: equal to the unsharded launch;
    the exact tier within +-1 u8 of JAX's sharded Pallas kernel. (The
    approx twin rounds to bf16 as the TPU does, which JAX's CPU run does
    not: its JAX comparison is tests/test_torch_approx.py's.)"""
    planes, qtabs, qpats, geom, rgeom = _fast_batch(128, 96, 8)
    got = batch.decode_batch_fast(planes, qtabs, geom, idct_mode=idct_mode,
                                  mesh=_mesh(8))
    assert got.shape == (8, 3, 128, 256)
    assert torch.equal(got, batch.decode_batch_fast(
        planes, qtabs, geom, device="cpu", idct_mode=idct_mode))
    if idct_mode == "exact":
        want = ref.decode_batch_fast(planes, qpats, rgeom,
                                     mesh=ref_mesh.make_mesh(8, 1))
        _within_one(got.numpy(), want)


@pytest.mark.parametrize("rank,axis", [(3, 0), (4, 1), (2, 0)])
def test_data_sharding_spec(rank, axis):
    sh = data_sharding(_mesh(4, 2), rank=rank, axis=axis)
    want = ref_mesh.data_sharding(ref_mesh.make_mesh(4, 2), rank, axis)
    assert sh.spec == tuple(want.spec)
    shape = (4, 8, 3, 5)[:rank]
    x = torch.arange(int(np.prod(shape))).reshape(shape)
    shards = sh.split(x)
    assert len(shards) == 4 and all(s.shape[axis] == x.shape[axis] // 4
                                    for s in shards)
    assert torch.equal(sh.gather(shards), x)


def test_rows_sp_fast_matches():
    """K1's twin over (data, seg): each band at its own geometry. mcus_y
    must be divisible by band_mcus * n_seg = 8 * 2 (4:2:0)."""
    planes, qtabs, qpats, geom, rgeom = _fast_batch(256, 16 * 16 * 2, 4)
    got = batch.decode_batch_rows_sp_fast(planes, qtabs, geom, _mesh(4, 2))
    assert got.shape == (4, 3, 512, 256)
    assert torch.equal(got, batch.decode_batch_fast(planes, qtabs, geom,
                                                    device="cpu"))
    want = ref.decode_batch_rows_sp_fast(planes, qpats, rgeom,
                                         ref_mesh.make_mesh(4, 2))
    _within_one(got.numpy(), want)


def test_rows_sp_fast_rejects_partial_bands():
    """A 4K frame's 135 MCU rows hold no whole 8-row bands per shard."""
    planes, qtabs, qpats, geom, rgeom = _fast_batch(64, 16 * 16, 2)
    g4k, r4k = (dataclasses.replace(g, mcus_y=135, height=2160)
                for g in (geom, rgeom))
    with pytest.raises(ValueError, match="fast row sharding"):
        ref.decode_batch_rows_sp_fast(planes, qpats, r4k,
                                      ref_mesh.make_mesh(2, 2))
    with pytest.raises(ValueError, match="fast row sharding"):
        batch.decode_batch_rows_sp_fast(planes, qtabs, g4k, _mesh(2, 2))


def test_encode_batch_device_sharded():
    """K2's twin sharded over data equals the unsharded launch, and is
    within K2's bar of JAX's sharded Pallas kernel."""
    parts = []
    for i, q in enumerate((50, 85, 92, 97)):
        img = synthetic_image(128, 96, seed=91 + i)
        geom, planar, _, quant_zz = enc.device_inputs(img, q, (2, 2), False)
        parts.append((planar, [quant_zz[min(c, len(quant_zz) - 1)]
                               for c in range(3)]))
    rgeom = RefGeometry(width=geom.width, height=geom.height,
                        mcus_x=geom.mcus_x, mcus_y=geom.mcus_y,
                        h_max=geom.h_max, v_max=geom.v_max,
                        sampling=geom.sampling)
    planar = np.stack([p for p, _ in parts])
    iq = np.stack([plan_inv_quant_tables(q) for _, q in parts])
    pats = [plan_inv_quant_patterns(q, rgeom) for _, q in parts]
    got = batch.encode_batch_device(planar, iq, geom, mesh=_mesh(4))
    single = batch.encode_batch_device(planar, iq, geom, device="cpu")
    want = ref.encode_batch_device(
        planar, [np.stack([pt[c] for pt in pats]) for c in range(3)], rgeom,
        mesh=ref_mesh.make_mesh(4, 1))
    for g, s, w in zip(got, single, want):
        assert torch.equal(g, s)
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == np.int16 and g.shape == w.shape
        diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-4


@pytest.mark.parametrize("hybrid", [False, True])
def test_corpus_decoder_under_a_mesh(hybrid):
    """Eleven frames of one geometry and one of another over a 4-shard mesh:
    8 sharded and 3 spilled to the unsharded launch, the odd frame alone
    (unsharded). Equal to the port without a mesh, within +-1 u8 of the JAX
    decoder with a mesh of the same size."""
    items = [_frame(96, 64, seed=s) for s in range(11)] + [_frame(64, 48, 3)]
    dec = BatchedCorpusDecoder(workers=2, hybrid_device=hybrid, device_batch=2,
                               device="cpu", mesh=_mesh(4))
    got = dec.decode_all(items)
    assert dec.pixel_launches == 4 + 1 + 1
    if hybrid:
        assert dec.device_frames > 0 and dec.entropy_launches > 0
    plain = BatchedCorpusDecoder(workers=2, device="cpu").decode_all(items)
    want = RefDecoder(workers=2, mesh=ref_mesh.make_mesh(4, 1)).decode_all(
        items)
    for g, p, w in zip(got, plain, want):
        assert g.ok and p.ok and w.ok
        np.testing.assert_array_equal(g.rgb, p.rgb)
        _within_one(g.rgb, w.rgb)


def test_dryrun_multichip_on_cpu():
    out = dryrun_multichip(8, devices=CPU8)
    assert out["mesh"] == (4, 2) and out["frames"] == 8
    assert out["rgb_shape"] == (8, 64, 32, 3) and out["items"] == 9
    with pytest.raises(RuntimeError, match="need 8 devices"):
        dryrun_multichip(8, devices=CPU8[:4])


def test_make_mesh_without_a_card_raises(monkeypatch):
    """No mesh is quietly made of the CPU: without a CUDA device and
    without ``devices=``, make_mesh (and so dryrun_multichip) raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(1)


def test_a_failed_shard_raises(monkeypatch):
    """A shard whose kernel fails to build or launch raises out of every
    sharded route and out of the corpus decoder; no shard gives way to
    another route."""
    def boom(*args, **kwargs):
        raise RuntimeError("simulated: K1 launch failed: CUDA error 700")

    def boom2(*args, **kwargs):
        raise RuntimeError("simulated: K2 build failed")

    planes, qtabs, _, geom, _ = _fast_batch(256, 512, 2)
    monkeypatch.setattr(batch, "fused_plane_decode", boom)
    monkeypatch.setattr(batch, "fused_plane_encode", boom2)
    with pytest.raises(RuntimeError, match="K1 launch failed"):
        batch.decode_batch_fast(planes, qtabs, geom, mesh=_mesh(2))
    with pytest.raises(RuntimeError, match="K1 launch failed"):
        batch.decode_batch_rows_sp_fast(planes, qtabs, geom, _mesh(2, 2))
    with pytest.raises(RuntimeError, match="K2 build failed"):
        batch.encode_batch_device(np.zeros((2, 3, 512, 256), np.uint8),
                                  np.ones((2, 3, 64), np.float32), geom,
                                  mesh=_mesh(2))
    dec = BatchedCorpusDecoder(workers=2, device="cpu", mesh=_mesh(2))
    with pytest.raises(RuntimeError, match="K1 launch failed"):
        dec.decode_all([_frame(96, 64, seed=s) for s in range(4)])
    dec.close()
