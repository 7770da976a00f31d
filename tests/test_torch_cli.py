"""The port's command line (``python -m jpeg_tpu_torch``) against the JAX
package's (``jpeg_tpu/cli.py``), in process on the same inputs, and the host
copies it runs on (``io/ppm.py``, ``io/corpus.py``, ``utils/manifest.py``).

The port runs with ``--device cpu`` (the kernels' plain versions); the JAX
CLI with its compile cache off. Bars: ``info`` equal; ``encode`` bytes
equal; ``decode`` within +-1 u8 and under 5% of values differing on both
paths, the bar between the port's twins and the JAX package's kernels
(tests/test_torch_fused_plane.py, tests/test_torch_compat.py); ``corpus``
the same counts and report keys; ``diff`` within 0.05 dB and 1 u8.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from jpeg_tpu import cli as ref_cli
from jpeg_tpu.io import corpus as ref_corpus
from jpeg_tpu.io import ppm as ref_ppm
from jpeg_tpu.models.encoder import encode_rgb, encode_rgb_progressive
from jpeg_tpu.utils.manifest import Manifest as RefManifest
from jpeg_tpu_torch import cli
from jpeg_tpu_torch.io import corpus, ppm
from jpeg_tpu_torch.models.decoder import decode_bytes
from jpeg_tpu_torch.ops import fused_plane as k1
from jpeg_tpu_torch.utils.manifest import Manifest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_xla_cache(monkeypatch):
    monkeypatch.setenv("JPEG_TPU_COMPILE_CACHE", "")


def _run(main, argv, capsys):
    """(exit code, stdout) of one in-process CLI call."""
    capsys.readouterr()
    rc = main(argv)
    return rc, capsys.readouterr().out


def _ours(argv, capsys):
    return _run(cli.main, argv, capsys)


def _theirs(argv, capsys):
    return _run(ref_cli.main, argv, capsys)


def _within_one(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.05


def _write(path, data: bytes) -> str:
    with open(path, "wb") as f:
        f.write(data)
    return str(path)


def _image(seed=1, size=(72, 120)):
    return ref_corpus.synthetic_image(size[1], size[0], seed=seed)


def _streams(tmp_path) -> dict:
    """name -> path of a small stream of each kind the CLI meets."""
    img = _image()
    cmyk = Image.fromarray(img).convert("CMYK")
    out = {}
    for name, data in {
        "baseline420": encode_rgb(img, quality=85),
        "rst422": encode_rgb(img, quality=90, subsampling=(2, 1),
                             restart_interval_mcus=3),
        "gray": encode_rgb(img[..., 0], quality=85, grayscale=True),
        "progressive": encode_rgb_progressive(img, quality=85),
        "sof9": encode_rgb(img, quality=85, arithmetic=True),
        "cmyk": _pil_bytes(cmyk, quality=90),
    }.items():
        out[name] = _write(tmp_path / f"{name}.jpg", data)
    return out


def _pil_bytes(im, **kw) -> bytes:
    import io

    buf = io.BytesIO()
    im.save(buf, "JPEG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("name", ["baseline420", "rst422", "gray",
                                  "progressive", "sof9", "cmyk"])
def test_info_equal(tmp_path, capsys, name):
    path = _streams(tmp_path)[name]
    rc, got = _ours(["info", path], capsys)
    assert rc == 0
    assert json.loads(got) == json.loads(_theirs(["info", path], capsys)[1])


@pytest.mark.parametrize("opts", [
    [], ["--path", "fast"], ["--path", "fast", "--rounding", "round"],
    ["--rounding", "round", "--p3"], ["--upsample", "fancy"],
    ["--engine", "oracle"], ["--engine", "native", "--exif-orientation"],
    ["--path", "fast", "--idct", "approx"],
])
@pytest.mark.parametrize("name", ["baseline420", "gray", "progressive"])
def test_decode_ppm_matches_jax_cli(tmp_path, capsys, name, opts):
    """Same PPM header and pixels within the bar; the same message. The JAX
    package's approx tier is its exact tier on the CPU, so there K1a's twin
    is held to the quality gate instead (max |diff| <= 2 u8, >= 50 dB)."""
    src = _streams(tmp_path)[name]
    ours, theirs = str(tmp_path / "ours.ppm"), str(tmp_path / "theirs.ppm")
    rc, msg = _ours(["decode", src, ours, "--device", "cpu", *opts], capsys)
    assert rc == 0
    assert msg.replace(ours, "OUT") == _theirs(
        ["decode", src, theirs, *opts], capsys)[1].replace(theirs, "OUT")
    got, want = ppm.read_ppm(ours), ref_ppm.read_ppm(theirs)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read(16) == g.read(16)
    if "approx" in opts:
        diff = np.abs(got.astype(float) - want.astype(float))
        assert diff.max() <= 2
        assert 10 * np.log10(255.0**2 / max((diff**2).mean(), 1e-12)) >= 50
        np.testing.assert_array_equal(got, decode_bytes(
            open(src, "rb").read(), path="fast", idct_mode="approx",
            device="cpu"))
    else:
        _within_one(got, want)


def test_decode_fast_path_ignores_exif_orientation(tmp_path, capsys):
    """As ``cmd_decode`` of the JAX CLI: ``--path fast`` does not rotate."""
    img = _image(3, (40, 64))
    exif = Image.Exif()
    exif[0x0112] = 6
    buf_img = Image.fromarray(img)
    src = _write(tmp_path / "rot.jpg", _pil_bytes(buf_img, quality=90,
                                                  exif=exif.tobytes()))
    for path, shape in (("fast", (40, 64, 3)), ("compat", (64, 40, 3))):
        out = str(tmp_path / f"{path}.ppm")
        assert _ours(["decode", src, out, "--path", path, "--device", "cpu",
                      "--exif-orientation"], capsys)[0] == 0
        theirs = str(tmp_path / f"{path}_ref.ppm")
        _theirs(["decode", src, theirs, "--path", path, "--exif-orientation"],
                capsys)
        assert ppm.read_ppm(out).shape == shape
        _within_one(ppm.read_ppm(out), ref_ppm.read_ppm(theirs))


@pytest.mark.parametrize("opts", [
    [], ["--optimize"], ["--restart-interval", "2"],
    ["--subsampling", "444", "--quality", "93"],
    ["--subsampling", "422", "--optimize", "--restart-interval", "5"],
    ["--color", "cmyk"], ["--color", "ycck", "--restart-interval", "4"],
    ["--precision", "12", "--subsampling", "422", "--restart-interval", "3"],
    ["--precision", "12", "--arithmetic"],
    ["--arithmetic", "--restart-interval", "2"],
    ["--progressive", "--arithmetic"], ["--progressive", "--precision", "12"],
    ["--progressive", "--subsampling", "444"],
    ["--lossless", "--predictor", "5", "--restart-interval", "7"],
    ["--lossless", "--precision", "12", "--predictor", "2"],
])
def test_encode_bytes_equal(tmp_path, capsys, opts):
    """A P6 written by ``write_ppm`` (the port reads it with ``read_ppm``,
    the JAX CLI with PIL; ``--color`` takes PIL on both) encodes to the same
    bytes, with the same message."""
    src = str(tmp_path / "src.ppm")
    ppm.write_ppm(src, _image(2, (50, 84)))
    ours, theirs = str(tmp_path / "o.jpg"), str(tmp_path / "t.jpg")
    rc, msg = _ours(["encode", src, ours, *opts], capsys)
    assert rc == 0
    assert msg.replace(ours, "X") == _theirs(
        ["encode", src, theirs, *opts], capsys)[1].replace(theirs, "X")
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()


def test_encode_reads_other_formats_through_pil(tmp_path, capsys):
    src = str(tmp_path / "src.png")
    Image.fromarray(_image(4, (24, 40))).save(src)
    ours, theirs = str(tmp_path / "o.jpg"), str(tmp_path / "t.jpg")
    assert _ours(["encode", src, ours], capsys)[0] == 0
    _theirs(["encode", src, theirs], capsys)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("opts,item", [
    (["--precision", "12"], "item 3c"), (["--progressive"], "item 3c"),
    (["--arithmetic"], "item 3c"), (["--lossless"], "item 7"),
    (["--predictor", "3"], "item 7"),
])
def test_unported_encode_options_raise_their_item(tmp_path, capsys, opts, item):
    """The options that raised their ROADMAP item (``item``) until it was
    ported now write the JAX CLI's bytes with its message. (``--predictor``
    alone selects nothing without ``--lossless``, as in the JAX CLI.)"""
    src = str(tmp_path / "src.ppm")
    ppm.write_ppm(src, _image(2, (16, 16)))
    ours, theirs = str(tmp_path / "o.jpg"), str(tmp_path / "t.jpg")
    rc, msg = _ours(["encode", src, ours, *opts], capsys)
    assert rc == 0, item
    assert msg.replace(ours, "X") == _theirs(
        ["encode", src, theirs, *opts], capsys)[1].replace(theirs, "X")
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()


def test_distributed_corpus_raises_its_item(tmp_path, capsys, monkeypatch):
    """``corpus --distributed`` raised its ROADMAP item (8) until it was
    ported; now it runs. With no group configured it is one process of one,
    as in the JAX CLI, and its report has the JAX report's keys,
    ``aggregate`` and ``process_count`` among them."""
    for var in ("MASTER_ADDR", "JAX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(var, raising=False)
    d = _corpus_dir(tmp_path)
    ours = _report(_ours(["corpus", d, "--distributed", "--device", "cpu"],
                         capsys)[1])
    theirs = _report(_theirs(["corpus", d, "--distributed"], capsys)[1])
    assert ours.keys() == theirs.keys()
    assert ours["process_count"] == theirs["process_count"] == 1
    assert ours["aggregate"]["decoded"] == theirs["aggregate"]["decoded"] == 6
    assert ours["aggregate"]["failed"] == theirs["aggregate"]["failed"] == 1


def test_corpus_raises_a_device_not_implemented_error(tmp_path, capsys,
                                                     monkeypatch):
    """The per-image loop records an image's own error as FAILED, but a
    ``NotImplementedError`` from PyTorch (an op with no CUDA kernel for a
    dtype) is a device failure and raises."""
    from jpeg_tpu_torch.models import decoder

    def boom(*args, **kwargs):
        raise NotImplementedError("simulated: no CUDA kernel for UInt16")

    monkeypatch.setattr(decoder, "decode_file", boom)
    d = _corpus_dir(tmp_path, n=1)
    with pytest.raises(NotImplementedError, match="UInt16"):
        _ours(["corpus", d, "--device", "cpu"], capsys)


def _corpus_dir(tmp_path, n=6):
    d = tmp_path / "corpus"
    d.mkdir()
    for i in range(n):
        _write(d / f"img_{i:03d}.jpg", encode_rgb(
            _image(10 + i, (48, 64)), quality=85, restart_interval_mcus=2))
    _write(d / "img_bad.jpg", b"\xff\xd8 not a jpeg")
    return str(d)


def _report(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("opts", [[], ["--batched"], ["--engine", "oracle"],
                                  ["--batched", "--chunk-size", "4"]])
def test_corpus_reports_match(tmp_path, capsys, opts):
    """Same decoded and failed counts (one corrupt file), the same report
    and stage keys, and ``--strict`` exits 1 on the failure in both."""
    d = _corpus_dir(tmp_path)
    ours = _report(_ours(["corpus", d, "--device", "cpu", *opts], capsys)[1])
    theirs = _report(_theirs(["corpus", d, *opts], capsys)[1])
    assert (ours["decoded"], ours["failed"]) == (theirs["decoded"],
                                                 theirs["failed"]) == (6, 1)
    assert ours.keys() == theirs.keys()
    assert ours["stages"].keys() == theirs["stages"].keys() == {"decode"}
    assert ours["stages"]["decode"].keys() == theirs["stages"]["decode"].keys()
    assert ours["stages"]["decode"]["calls"] == theirs["stages"]["decode"]["calls"]
    assert _ours(["corpus", d, "--device", "cpu", "--strict", *opts],
                 capsys)[0] == 1
    assert _theirs(["corpus", d, "--strict", *opts], capsys)[0] == 1


def test_corpus_hybrid_approx_runs_the_twins(tmp_path, capsys):
    """``--batched --hybrid-device --idct approx`` on the CPU: every item
    decoded, nothing launched (CPU tensors take the plain versions)."""
    d = _corpus_dir(tmp_path, 8)
    os.remove(os.path.join(d, "img_bad.jpg"))
    rc, out = _ours(["corpus", d, "--device", "cpu", "--batched",
                     "--hybrid-device", "--idct", "approx"], capsys)
    assert rc == 0 and _report(out)["decoded"] == 8
    assert k1.LAUNCHES_APPROX.value == 0


@pytest.mark.parametrize("first", ["ours", "theirs"])
def test_manifest_resumes_across_packages(tmp_path, capsys, first):
    """A manifest written by one package's ``corpus --limit`` is resumed by
    the other's; together they cover every item once."""
    d = _corpus_dir(tmp_path)
    os.remove(os.path.join(d, "img_bad.jpg"))
    m = str(tmp_path / "m")
    runs = [(_ours, ["--device", "cpu"]), (_theirs, [])]
    if first == "theirs":
        runs.reverse()
    (a, a_opts), (b, b_opts) = runs
    assert _report(a(["corpus", d, "--manifest", m, "--limit", "4", "--batched",
                      *a_opts], capsys)[1])["decoded"] == 4
    assert _report(b(["corpus", d, "--manifest", m, *b_opts],
                     capsys)[1])["decoded"] == 2
    assert _report(a(["corpus", d, "--manifest", m, *a_opts],
                     capsys)[1])["decoded"] == 0
    with open(f"{m}.0.jsonl") as f:
        items = [json.loads(line)["item"] for line in f]
    assert sorted(items) == corpus.list_corpus(d)
    assert Manifest(m).done_count == RefManifest(m).done_count == 6


def test_manifest_copy_equals_jax(tmp_path):
    """The same records, a torn final line skipped by both."""
    m = str(tmp_path / "m")
    man = Manifest(m, 3)
    man.mark_done("a.jpg", h=1, w=2)
    man.mark_done("b.jpg")
    man.close()
    with open(f"{m}.3.jsonl", "a") as f:
        f.write('{"item": "c.j')
    ours, theirs = Manifest(m, 3), RefManifest(m, 3)
    assert ours._done == theirs._done and ours.done_count == 2
    assert ours.pending(["a.jpg", "c.jpg"]) == theirs.pending(["a.jpg", "c.jpg"])
    assert ours.is_done("b.jpg") and not ours.is_done("c.jpg")
    ours.close()
    theirs.close()


@pytest.mark.parametrize("opts", [[], ["--upsample", "fancy"],
                                  ["--rounding", "truncate"]])
@pytest.mark.parametrize("name", ["baseline420", "gray", "cmyk"])
def test_diff_within_bar(tmp_path, capsys, name, opts):
    src = _streams(tmp_path)[name]
    ours = json.loads(_ours(["diff", src, "--device", "cpu", *opts], capsys)[1])
    theirs = json.loads(_theirs(["diff", src, *opts], capsys)[1])
    assert ours["input"] == theirs["input"] and ours["shape"] == theirs["shape"]
    assert abs(ours["psnr_vs_libjpeg_db"] - theirs["psnr_vs_libjpeg_db"]) <= 0.05
    assert abs(ours["max_abs_diff"] - theirs["max_abs_diff"]) <= 1


def test_diff_output_image(tmp_path, capsys):
    src = _streams(tmp_path)["baseline420"]
    out = str(tmp_path / "d.png")
    assert _ours(["diff", src, "--device", "cpu", "--diff-output", out,
                  "--amplify", "8"], capsys)[0] == 0
    assert np.asarray(Image.open(out)).shape == (72, 120, 3)


def test_missing_pil_is_an_error_naming_it(tmp_path, capsys, monkeypatch):
    """Without Pillow: a non-PPM input, ``--color cmyk`` and ``diff`` raise
    an ImportError naming it; a PPM input still encodes."""
    src_png = str(tmp_path / "src.png")
    Image.fromarray(_image(4, (16, 24))).save(src_png)
    src_ppm = str(tmp_path / "src.ppm")
    ppm.write_ppm(src_ppm, _image(4, (16, 24)))
    jpg = _streams(tmp_path)["baseline420"]
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    out = str(tmp_path / "o.jpg")
    for argv in (["encode", src_png, out], ["encode", src_ppm, out, "--color",
                                            "cmyk"],
                 ["diff", jpg, "--device", "cpu"]):
        with pytest.raises(ImportError, match="Pillow"):
            _ours(argv, capsys)
    assert _ours(["encode", src_ppm, out], capsys)[0] == 0
    with pytest.raises(ImportError, match="Pillow"):
        corpus.synthetic_jpeg(16, 16)


def test_cuda_device_without_a_card_raises(tmp_path, capsys, monkeypatch):
    """``--device cuda`` (the default) where no card is: an error, not the
    CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = _streams(tmp_path)["baseline420"]
    d = _corpus_dir(tmp_path, 1)
    for argv in (["decode", src, str(tmp_path / "o.ppm")],
                 ["decode", src, str(tmp_path / "o.ppm"), "--path", "fast"],
                 ["corpus", d, "--batched"], ["corpus", d],
                 ["diff", src, "--device", "cuda:0"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _ours(argv, capsys)


def test_host_copies_equal_jax(tmp_path):
    """ppm, corpus: the same bytes, arrays and lists as the JAX package."""
    img = _image(5, (9, 7))
    for binary in (True, False):
        a, b = str(tmp_path / f"a{binary}.ppm"), str(tmp_path / f"b{binary}.ppm")
        ppm.write_ppm(a, img, binary=binary)
        ref_ppm.write_ppm(b, img, binary=binary)
        with open(a, "rb") as f, open(b, "rb") as g:
            assert f.read() == g.read()
        np.testing.assert_array_equal(ppm.read_ppm(b), img)
    deep = (img.astype(np.uint16) << 4)
    ppm.write_ppm(a, deep)
    got, maxval = ppm.read_ppm(a, return_maxval=True)
    assert maxval == 4095
    np.testing.assert_array_equal(got, ref_ppm.read_ppm(a))
    np.testing.assert_array_equal(corpus.synthetic_image(33, 17, 3),
                                  ref_corpus.synthetic_image(33, 17, 3))
    assert corpus.synthetic_jpeg(48, 32, seed=2) == ref_corpus.synthetic_jpeg(
        48, 32, seed=2)
    paths = corpus.generate_corpus(str(tmp_path / "g"), 3, 32, 16)
    assert paths == corpus.list_corpus(str(tmp_path / "g")) == \
        ref_corpus.list_corpus(str(tmp_path / "g"))
    items = list(range(11))
    assert corpus.shard_items(items, 2, 3) == ref_corpus.shard_items(items, 2, 3)


def test_python_m_runs_the_port_without_jax(tmp_path):
    """``python -m jpeg_tpu_torch info`` in a fresh interpreter: the same
    JSON, and neither jax nor jpeg_tpu loaded by the CLI's modules."""
    src = _streams(tmp_path)["rst422"]
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-m", "jpeg_tpu_torch", "info", src],
                          cwd=str(tmp_path), env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)["entropy_segments"] == 24  # 72 MCUs / 3
    code = ("import sys; import jpeg_tpu_torch.cli as c; "
            "import jpeg_tpu_torch.utils.profiling, jpeg_tpu_torch.utils.manifest; "
            "import jpeg_tpu_torch.io.ppm, jpeg_tpu_torch.io.corpus; "
            "import jpeg_tpu_torch.entropy.oracle, jpeg_tpu_torch.entropy.arith; "
            "import jpeg_tpu_torch.entropy.progressive; "
            "c.main(['info', sys.argv[1]]); "
            "assert 'jax' not in sys.modules, 'jax loaded'; "
            "assert 'jpeg_tpu' not in sys.modules, 'jpeg_tpu loaded'; "
            "assert 'PIL' not in sys.modules, 'PIL loaded'")
    proc = subprocess.run([sys.executable, "-c", code, src], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_twelve_bit_ppm_encode_and_decode(tmp_path, capsys):
    """A maxval-4095 P6 encodes at ``--precision 12`` to the JAX CLI's
    bytes; ``decode`` writes the 16-bit P6 the JAX CLI writes, within +-1
    of its samples; a maxval-65535 P6 is refused by both."""
    rng = np.random.default_rng(12)
    img = (rng.integers(0, 4096, (24, 40, 3))).astype(np.uint16)
    src = str(tmp_path / "src12.ppm")
    ppm.write_ppm(src, img, maxval=4095)
    ours, theirs = str(tmp_path / "o.jpg"), str(tmp_path / "t.jpg")
    assert _ours(["encode", src, ours, "--precision", "12"], capsys)[0] == 0
    _theirs(["encode", src, theirs, "--precision", "12"], capsys)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    out_o, out_t = str(tmp_path / "o.ppm"), str(tmp_path / "t.ppm")
    assert _ours(["decode", ours, out_o, "--device", "cpu"], capsys)[0] == 0
    _theirs(["decode", theirs, out_t], capsys)
    got, gmax = ppm.read_ppm(out_o, return_maxval=True)
    want, wmax = ref_ppm.read_ppm(out_t, return_maxval=True)
    assert gmax == wmax and got.dtype == np.uint16
    _within_one(got, want)
    wide = str(tmp_path / "wide.ppm")
    ppm.write_ppm(wide, img * 16, maxval=65535)
    for run in (_ours, _theirs):
        with pytest.raises(SystemExit, match="maxval-4095"):
            run(["encode", wide, str(tmp_path / "x.jpg"), "--precision", "12"],
                capsys)
