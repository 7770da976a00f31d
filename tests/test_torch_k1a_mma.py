"""K1a's tensor-core IDCT on the CPU: a NumPy model of the kernel's pair
packing, shared-memory staging and fragment maps (``csrc/fused_plane.cu``,
kFragment, ``stage_at``, ``chunk_at``; the same index formulas), held to
the plain twin ``idct_blocks_plain(bf16=True)``; the proof that pairs and
groups of four blocks never straddle a component on any sampling K1 takes;
and the bank pattern of every shared-memory access K1 and K1a make.

The model's products are exact (bf16 x bf16) and summed in float64, then
rounded to fp32: a sum in another order than the twin's, which rounds
after each term. That order is the only difference the kernel may have
from the twin, so the model's vertical pass is held to the twin's within
a relative 1e-6 before the bf16 rounding of T.
"""

import numpy as np
import pytest
import torch

from jpeg_tpu.io.corpus import synthetic_image
from jpeg_tpu.models.encoder import encode_rgb
from jpeg_tpu_torch.io.container import parse_jpeg
from jpeg_tpu_torch.models.decoder import PipelineGeometry
from jpeg_tpu_torch.ops import fused_plane as k1
from jpeg_tpu_torch.ops.color import grayscale_to_rgb, ycbcr_to_rgb
from jpeg_tpu_torch.ops.idct import (
    bf16_round,
    dct_basis_1d_bf16,
    idct_blocks_plain,
    idct_columns_plain,
)
from jpeg_tpu_torch.runtime import native_decode_planes

SAMPLINGS = {"1x1": (1, 1), "2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2),
             "4x1": (4, 1), "4x4": (4, 4), "gray": None}
TILE_W = 256
BLOCK_BYTES = 128
ORDER_REL_TOL = 1e-6  # the order of exact-product sums, relative to max |T|
# The kernel against its twin (the card's acceptance bound, here for the
# model): u8 values at most 2 apart, at most 1e-3 of them differing.
TWIN_MAX_DIFF = 2
TWIN_MAX_SHARE = 1e-3

# ---- the kernel's index formulas (fused_plane.cu) ------------------------


def chunk_at(c, rs):
    """Float offset of 16-byte chunk c of a pixel-tile row whose row term
    is rs."""
    return (c ^ ((c >> 3) & 3) ^ rs) * 4


def row_swizzle(y, approx=True):
    """The row term of pixel-tile row y: K1a's, or K1's (none)."""
    return (y & 3) << 1 if approx else 0


def stage_at(blk, v):
    """Byte offset of row v of staged block blk."""
    return blk * BLOCK_BYTES + ((v ^ (blk & 7)) << 4)


def cell_comps(geom):
    """The launcher's per-component cell layout: (v, nbx, fx, fy, first
    block, float offset of its pixels), and the cell's block and float
    counts."""
    comps, blocks, floats = [], 0, 0
    for h, v in geom.sampling:
        fx, fy = geom.h_max // h, geom.v_max // v
        nbx = TILE_W // fx // 8
        comps.append(dict(v=v, nbx=nbx, fx=fx, fy=fy, first=blocks, tile=floats))
        blocks += v * nbx
        floats += 8 * v * nbx * 8
    return comps, blocks, floats


def comp_of(comps, blk):
    return max(i for i, c in enumerate(comps) if blk >= c["first"])


def lanes():
    """(lane, g, t) of a warp."""
    return [(l, l >> 2, l & 3) for l in range(32)]


# ---- the PTX fragment layouts (mma.sync / ldmatrix, as documented) ---------


def a16_positions(g, t):
    """m16n8k16 A registers a0..a3: (row, col) of their low and high half."""
    return [((g, 2 * t), (g, 2 * t + 1)), ((g + 8, 2 * t), (g + 8, 2 * t + 1)),
            ((g, 2 * t + 8), (g, 2 * t + 9)),
            ((g + 8, 2 * t + 8), (g + 8, 2 * t + 9))]


def b16_positions(g, t):
    """m16n8k16 B registers b0, b1: (k, n) of their low and high half."""
    return [((2 * t, g), (2 * t + 1, g)), ((2 * t + 8, g), (2 * t + 9, g))]


def c_positions(g, t):
    """C / D registers c0..c3 (both shapes): (row, col)."""
    return [(g, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t), (g + 8, 2 * t + 1)]


def a8_positions(g, t):
    """m16n8k8 A registers a0, a1."""
    return [((g, 2 * t), (g, 2 * t + 1)), ((g + 8, 2 * t), (g + 8, 2 * t + 1))]


def b8_positions(g, t):
    """m16n8k8 B register b0."""
    return [((2 * t, g), (2 * t + 1, g))]


def ldmatrix_x4_trans(smem: bytes, addr):
    """ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16: lane l supplies
    ``addr[l]``, the address of row l & 7 of matrix l >> 3; lane (g, t)
    receives from matrix k the elements [2t][g] and [2t + 1][g]."""
    rows = [np.frombuffer(smem, np.int16, 8, addr[l]) for l in range(32)]
    return [[(rows[8 * k + 2 * t][g], rows[8 * k + 2 * t + 1][g])
             for k in range(4)] for _, g, t in lanes()]


def mma(a, b):
    """D = A @ B: exact products summed in float64, rounded to fp32."""
    return (a.astype(np.float64) @ b.astype(np.float64)).astype(np.float32)


def bf16(x):
    return bf16_round(torch.from_numpy(np.asarray(x, np.float32))).numpy()


def scatter(regs, positions, shape):
    """Assemble the matrix the lanes' fragment registers hold."""
    m = np.full(shape, np.nan, np.float32)
    for lane_regs, lane_pos in zip(regs, positions):
        for pair, where in zip(lane_regs, lane_pos):
            for value, (r, c) in zip(pair, where):
                m[r, c] = value
    return m


def basis_register(a, g, t):
    """{A[2t][g], A[2t+1][g]}: vertical a0 = a3, horizontal b0."""
    return (a[2 * t, g], a[(2 * t + 1), g])


# ---- the model ---------------------------------------------------------------


def model_cell(planes, q, geom, b, mcu_row, tile, a):
    """K1a's IDCT stage for one cell as the kernel computes it: returns the
    pixel tile (float32, n_floats) and the cell's vertical-pass values T
    (fp32, before the bf16 rounding) per block."""
    comps, n_blocks, n_floats = cell_comps(geom)
    # 1. Staging: block rows copied as 16 bytes to stage_at(blk, v).
    stage = bytearray(n_blocks * BLOCK_BYTES)
    for blk in range(n_blocks):
        ci = comp_of(comps, blk)
        c = comps[ci]
        i = blk - c["first"]
        by, bx = divmod(i, c["nbx"])
        for v in range(8):
            row = (mcu_row * 8 * c["v"] + by * 8 + v)
            col = tile * c["nbx"] * 8 + bx * 8
            stage[stage_at(blk, v):stage_at(blk, v) + 16] = (
                planes[ci][b, row, col:col + 8].tobytes())
    stage = bytes(stage)
    px = np.full(n_floats, np.nan, np.float32)
    t_cell = {}
    a16 = [[basis_register(a, g, t), (0.0, 0.0), (0.0, 0.0),
            basis_register(a, g, t)] for _, g, t in lanes()]
    m16 = scatter(a16, [a16_positions(g, t) for _, g, t in lanes()], (16, 16))
    b8 = [[basis_register(a, g, t)] for _, g, t in lanes()]
    m8 = scatter(b8, [b8_positions(g, t) for _, g, t in lanes()], (8, 8))
    for j in range(n_blocks // 4):
        blk0 = 4 * j
        regs = ldmatrix_x4_trans(stage, [stage_at(blk0 + (l >> 3), l & 7)
                                         for l in range(32)])
        ci = comp_of(comps, blk0)
        c = comps[ci]
        cols = c["nbx"] * 8
        for p in range(2):
            bfrag = []
            for _, g, t in lanes():
                qlo, qhi = q[b, ci, 2 * t * 8 + g], q[b, ci, (2 * t + 1) * 8 + g]
                lane_b = []
                for r in regs[4 * g + t][2 * p:2 * p + 2]:
                    lane_b.append(tuple(bf16([np.float32(r[0]) * qlo,
                                              np.float32(r[1]) * qhi])))
                bfrag.append(lane_b)
            fb = scatter(bfrag, [b16_positions(g, t) for _, g, t in lanes()],
                         (16, 8))
            tt = mma(m16, fb)  # C fragments: rows (block, y), cols u
            cfrag = [[tt[r, cc] for r, cc in c_positions(g, t)]
                     for _, g, t in lanes()]
            afrag = [[tuple(bf16(cf[0:2])), tuple(bf16(cf[2:4]))]
                     for cf in cfrag]
            ta = scatter(afrag, [a8_positions(g, t) for _, g, t in lanes()],
                         (16, 8))
            s = mma(ta, m8)
            i = blk0 + 2 * p - c["first"]
            by, bx = divmod(i, c["nbx"])
            t_cell[blk0 + 2 * p] = tt[:8]
            t_cell[blk0 + 2 * p + 1] = tt[8:]
            for _, g, t in lanes():
                d = [s[r, cc] for r, cc in c_positions(g, t)]
                row = c["tile"] + (by * 8 + g) * cols + 2 * (t & 1)
                for half, (x0, x1) in enumerate(((d[0], d[1]), (d[2], d[3]))):
                    o = row + chunk_at(2 * bx + 2 * half + (t >> 1),
                                       row_swizzle(g))
                    px[o:o + 2] = (x0, x1)
    return px, t_cell, comps


def read_component(px, c):
    """The colour stage's view of one component's cell pixels (load4 at
    fx = 1): [8 v, nbx * 8]."""
    cols = c["nbx"] * 8
    out = np.empty((8 * c["v"], cols), np.float32)
    for y in range(8 * c["v"]):
        for x in range(cols):
            out[y, x] = px[c["tile"] + y * cols
                           + chunk_at(x >> 2, row_swizzle(y)) + (x & 3)]
    return out


def _stream(sampling, seed=3, size=(136, 200), quality=92):
    rng = np.random.default_rng(seed)
    img = synthetic_image(size[1], size[0], seed=seed).astype(np.int16)
    img = np.clip(img + rng.integers(-30, 30, img.shape), 0, 255).astype(np.uint8)
    sub = SAMPLINGS[sampling]
    if sub is None:
        return encode_rgb(img[..., 0], quality=quality, grayscale=True)
    return encode_rgb(img, quality=quality, subsampling=sub)


def _planes(sampling):
    plan = parse_jpeg(_stream(sampling))
    geom = PipelineGeometry.of(plan)
    planes = [p.copy()[None] for p in native_decode_planes(plan)]
    q = k1.plan_quant_patterns(plan, geom)[None]
    return planes, q, geom


def model_plane(planes, q, geom):
    """Every cell of image 0 through the model: per component the spatial
    plane and the vertical pass T [R, 8, C, 8] (block row, y, block column,
    u)."""
    a = dct_basis_1d_bf16()
    comps, _, _ = cell_comps(geom)
    h_pad, w_pad = k1.padded_size(geom)
    spatial = [np.empty(p.shape[1:], np.float32) for p in planes]
    t_all = [np.empty((p.shape[1] // 8, 8, p.shape[2] // 8, 8), np.float32)
             for p in planes]
    for mcu_row in range(h_pad // (8 * geom.v_max)):
        for tile in range(w_pad // TILE_W):
            px, t_cell, comps = model_cell(planes, q, geom, 0, mcu_row, tile, a)
            for ci, c in enumerate(comps):
                r0, c0 = mcu_row * 8 * c["v"], tile * c["nbx"] * 8
                spatial[ci][r0:r0 + 8 * c["v"], c0:c0 + c["nbx"] * 8] = (
                    read_component(px, c))
                for i in range(c["v"] * c["nbx"]):
                    by, bx = divmod(i, c["nbx"])
                    t_all[ci][mcu_row * c["v"] + by, :,
                              tile * c["nbx"] + bx, :] = t_cell[c["first"] + i]
    return spatial, t_all


@pytest.mark.parametrize("sampling", ["2x2", "4x1", "gray"])
def test_fragment_model_equals_twin_up_to_the_order_of_sums(sampling):
    """The model's vertical pass is the twin's within 1e-6 of max |T|
    (before the bf16 rounding of T); its output is the twin's within the
    same tolerance wherever the rounded T agree; and through the colour
    stage its u8 pixels are the twin's within the kernel's bound."""
    planes, q, geom = _planes(sampling)
    a = torch.from_numpy(dct_basis_1d_bf16())
    spatial, t_model = model_plane(planes, q, geom)
    twin_s, flips, total = [], 0, 0
    for ci, p in enumerate(planes):
        _, rows, cols = p.shape
        f = torch.from_numpy(p[0].astype(np.float32)).view(
            rows // 8, 8, cols // 8, 8) * torch.from_numpy(q[0, ci]).view(
                1, 8, 1, 8)
        t_twin = idct_columns_plain(bf16_round(f), a).numpy()
        bar = ORDER_REL_TOL * float(np.abs(t_twin).max())
        assert float(np.abs(t_model[ci] - t_twin).max()) <= bar
        same = bf16(t_model[ci]) == bf16(t_twin)
        flips += int((~same).sum())
        total += same.size
        s_twin = idct_blocks_plain(f, a, bf16=True).numpy()
        twin_s.append(s_twin.reshape(rows, cols))
        ok = same.all(axis=(1, 3))  # blocks whose rounded T agree
        s_model = spatial[ci].reshape(rows // 8, 8, cols // 8, 8)
        bar = ORDER_REL_TOL * float(np.abs(s_twin).max())
        assert float(np.abs(s_model - s_twin).max(axis=(1, 3))[ok].max()) <= bar
    assert flips <= 1e-3 * total

    def colour(sp):
        ups = []
        for s, (h, v) in zip(sp, geom.sampling):
            t = torch.from_numpy(np.ascontiguousarray(s))[None]
            ups.append(t.repeat_interleave(geom.v_max // v, 1)
                       .repeat_interleave(geom.h_max // h, 2))
        return (grayscale_to_rgb(ups[0], "truncate") if len(ups) == 1
                else ycbcr_to_rgb(*ups, rounding="truncate")).numpy()

    got, want = colour(spatial)[0], colour(twin_s)[0]
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= TWIN_MAX_DIFF and (diff != 0).mean() <= TWIN_MAX_SHARE
    # The twin's whole decode is the one the model's colour stage fed.
    twin = k1.fused_plane_decode_plain(
        [torch.from_numpy(p) for p in planes], torch.from_numpy(q), geom,
        idct_mode="approx")[0].numpy()
    np.testing.assert_array_equal(want, twin)


def test_fragments_hold_the_pair_products():
    """The fragment maps of kFragment put kron(I2, A^T) in the vertical
    product's A, [F0; F1] in its B (ldmatrix.trans of the staged blocks),
    and A [u][x] in the horizontal product's B, from one register."""
    a = dct_basis_1d_bf16()
    a16 = [[basis_register(a, g, t), (0.0, 0.0), (0.0, 0.0),
            basis_register(a, g, t)] for _, g, t in lanes()]
    m16 = scatter(a16, [a16_positions(g, t) for _, g, t in lanes()], (16, 16))
    np.testing.assert_array_equal(m16, np.kron(np.eye(2, dtype=np.float32), a.T))
    m8 = scatter([[basis_register(a, g, t)] for _, g, t in lanes()],
                 [b8_positions(g, t) for _, g, t in lanes()], (8, 8))
    np.testing.assert_array_equal(m8, a)
    blocks = np.random.default_rng(1).integers(-2048, 2048, (4, 8, 8)).astype(
        np.int16)
    stage = bytearray(4 * BLOCK_BYTES)
    for blk in range(4):
        for v in range(8):
            stage[stage_at(blk, v):stage_at(blk, v) + 16] = blocks[blk, v].tobytes()
    regs = ldmatrix_x4_trans(bytes(stage), [stage_at(l >> 3, l & 7)
                                            for l in range(32)])
    for p in range(2):
        fb = scatter([r[2 * p:2 * p + 2] for r in regs],
                     [b16_positions(g, t) for _, g, t in lanes()], (16, 8))
        np.testing.assert_array_equal(
            fb, np.concatenate([blocks[2 * p], blocks[2 * p + 1]]))


@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_pairs_never_straddle_a_component(sampling):
    """Blocks 2i, 2i + 1 (a pair) and 4j .. 4j + 3 (one ldmatrix.x4) of a
    cell lie in one component and one block row, the pair's first at an
    even block column, on every sampling K1 takes."""
    sub = SAMPLINGS[sampling]
    data = (encode_rgb(synthetic_image(40, 24, seed=0)[..., 0], grayscale=True)
            if sub is None else encode_rgb(synthetic_image(40, 24, seed=0),
                                           subsampling=sub))
    geom = PipelineGeometry.of(parse_jpeg(data))
    comps, n_blocks, _ = cell_comps(geom)
    assert n_blocks % 4 == 0

    def where(blk):
        ci = comp_of(comps, blk)
        by, bx = divmod(blk - comps[ci]["first"], comps[ci]["nbx"])
        return ci, by, bx

    for j in range(n_blocks // 4):
        at = [where(4 * j + k) for k in range(4)]
        assert len({(ci, by) for ci, by, _ in at}) == 1
        assert at[0][2] % 4 == 0 and [x for _, _, x in at] == list(
            range(at[0][2], at[0][2] + 4))


def _banks(byte_addrs, width):
    """Wavefronts of one shared-memory access phase: the largest number of
    distinct 4-byte words mapped to one bank."""
    words = {}
    for addr in byte_addrs:
        for w in range(addr // 4, (addr + width) // 4):
            words.setdefault(w % 32, set()).add(w)
    return max(len(s) for s in words.values())


@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_shared_memory_accesses_are_free_of_bank_conflicts(sampling):
    """Every phase of K1a's staging copies (8 lanes x 16 bytes), its
    ldmatrix reads (8 rows per matrix), its float2 pixel stores (16 lanes x
    8 bytes), K1's float4 pixel stores and the colour stage's float4 reads
    in either layout (8 lanes each) touches each bank once (one word, or
    one word read by several lanes)."""
    sub = SAMPLINGS[sampling]
    data = (encode_rgb(synthetic_image(40, 24, seed=0)[..., 0], grayscale=True)
            if sub is None else encode_rgb(synthetic_image(40, 24, seed=0),
                                           subsampling=sub))
    geom = PipelineGeometry.of(parse_jpeg(data))
    comps, n_blocks, _ = cell_comps(geom)
    for v in range(8):  # staging: a quarter-warp copies row v of 8 blocks
        for b0 in range(0, n_blocks, 8):
            assert _banks([stage_at(b, v) for b in range(b0, b0 + 8)], 16) == 1
    for blk in range(n_blocks):  # ldmatrix: one matrix's eight rows
        assert _banks([stage_at(blk, r) for r in range(8)], 16) == 1
    for c in comps:
        cols = c["nbx"] * 8
        for by in range(c["v"]):
            for bx in range(0, c["nbx"], 2):  # K1a: half-warps, block bx, bx+1
                for blk_off in (0, 2):
                    for half in (range(0, 4), range(4, 8)):
                        addrs = [4 * (c["tile"] + (by * 8 + g) * cols + 2 * (t & 1)
                                      + chunk_at(2 * bx + blk_off + (t >> 1),
                                                 row_swizzle(g)))
                                 for g in half for t in range(4)]
                        assert _banks(addrs, 8) == 1
            for y in range(8):  # K1: a quarter-warp stores row y of 8 blocks
                for b0 in range(0, c["nbx"], 8):
                    for h in (0, 1):
                        addrs = [4 * (c["tile"] + (by * 8 + y) * cols
                                      + chunk_at(2 * bx + h, 0))
                                 for bx in range(b0, b0 + 8)]
                        assert _banks(addrs, 16) == 1
    for yy in range(8 * geom.v_max):  # colour stage: 8 lanes of row yy
        for lane0 in (0, 8):
            for k in range(4):
                for c in comps:
                    y = yy // c["fy"]
                    for approx in (False, True):  # K1's rows, K1a's
                        addrs = {4 * (c["tile"] + y * c["nbx"] * 8 + chunk_at(
                            (((lane0 + j) * 16 + 4 * k) // c["fx"]) >> 2,
                            row_swizzle(y, approx))) for j in range(8)}
                        assert _banks(sorted(addrs), 16) == 1


def test_hoisted_addresses_are_stage_at_and_chunk_at():
    """idct_stage_mma's loop addresses, with the lane's and the component's
    parts taken out of the loop (byte addresses), are stage_at's and
    chunk_at's: the ldmatrix row of block 4j + (l >> 3), and the float2
    of row g, x = 2t of blocks bx0 .. bx0 + 3 for any bx0 a multiple of 4
    of a row 32 blocks wide."""
    for lane, g, t in lanes():
        ld = (lane >> 3) * BLOCK_BYTES
        ld_even = ld + (((lane & 7) ^ (lane >> 3)) << 4)
        ld_odd = ld + (((lane & 7) ^ (4 | (lane >> 3))) << 4)
        for j in range(96):
            got = (ld_odd if j & 1 else ld_even) + 4 * j * BLOCK_BYTES
            assert got == stage_at(4 * j + (lane >> 3), lane & 7)
        h16, r32 = (t >> 1) << 4, (g & 3) << 5
        for bx0 in range(0, 32, 4):
            w = ((bx0 & 12) << 2) ^ r32
            px = 4 * (8 * bx0 + 2 * (t & 1))
            for p in range(2):
                for half in range(2):
                    k = 2 * p + half
                    got = px + ((64 * p + 32 * half + h16) ^ w)
                    want = 4 * (chunk_at(2 * (bx0 + k) + (t >> 1), row_swizzle(g))
                                + 2 * (t & 1))
                    assert got == want


def test_stage_probe_cuts_apply_to_the_kernel_source():
    """tools/probe_k1a_stages.py finds each anchor it cuts at exactly once in
    csrc/fused_plane.cu, so its variants follow the kernel as it changes."""
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "probe_k1a_stages", os.path.join(root, "tools", "probe_k1a_stages.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    with open(os.path.join(root, "jpeg_tpu_torch", "csrc", "fused_plane.cu")) as f:
        src = f.read()
    for name, cuts in probe.VARIANTS.items():
        out = probe.variant_source(src, cuts)
        assert (out == src) == (not cuts), name
