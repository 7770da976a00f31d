"""The build helper's library hash: a header that a CUDA source includes is
part of it, so editing the header rebuilds the library instead of loading a
stale one. No compiler runs here."""

import os

import pytest

from jpeg_tpu_torch.entropy import device_huffman, device_kernel, device_spec
from jpeg_tpu_torch.ops import fused_plane, idct_only
from jpeg_tpu_torch.utils import build


def test_digest_changes_when_a_header_changes(tmp_path):
    src, hdr = tmp_path / "k.cu", tmp_path / "k.cuh"
    src.write_text('#include "k.cuh"\n')
    hdr.write_text("// one\n")
    cmd = ["nvcc", "-I", str(tmp_path)]
    before = build._digest(cmd, [str(src), str(hdr)])
    assert before == build._digest(cmd, [str(src), str(hdr)])
    hdr.write_text("// two\n")
    assert build._digest(cmd, [str(src), str(hdr)]) != before
    assert build._digest(cmd, [str(src)]) != before


@pytest.mark.parametrize("module,name", [(device_huffman, "huffman_lanes"),
                                         (device_kernel, "huffman_words"),
                                         (device_spec, "huffman_spec")])
def test_huffman_kernels_hash_their_shared_header(monkeypatch, tmp_path,
                                                  module, name):
    """K3, K4 and K7 include csrc/huffman_common.cuh: their loaders compile the
    .cu alone, with csrc on the include path, and name the library after a
    hash that covers the header."""
    _check_loader_hashes_header(monkeypatch, tmp_path, module, name,
                                "huffman_common.cuh")


@pytest.mark.parametrize("module,name", [(fused_plane, "fused_plane"),
                                         (idct_only, "idct_only")])
def test_idct_kernels_hash_their_shared_header(monkeypatch, tmp_path, module,
                                               name):
    """K1 and K5/K6 include csrc/idct8x8.cuh, the register IDCT they share."""
    _check_loader_hashes_header(monkeypatch, tmp_path, module, name,
                                "idct8x8.cuh")


def _check_loader_hashes_header(monkeypatch, tmp_path, module, name, header):
    calls = []

    def fake_build(lib, compiler, sources, headers=()):
        calls.append((lib, compiler, sources, headers))
        raise build.BuildError("stop before compiling")

    monkeypatch.setattr(build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build, "build_library", fake_build)
    monkeypatch.setattr(build, "_loaded", {})
    with pytest.raises(build.BuildError):
        module.load_kernel()
    (lib, compiler, sources, headers), = calls
    assert lib == name
    assert sources == [os.path.join(build.CSRC_DIR, f"{name}.cu")]
    assert headers == (os.path.join(build.CSRC_DIR, header),)
    assert compiler[compiler.index("-I") + 1] == build.CSRC_DIR
    with open(sources[0]) as f:
        assert f'#include "{header}"' in f.read()
    # The library's name moves with the header's text.
    monkeypatch.undo()
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    copy = tmp_path / header
    with open(headers[0]) as f:
        copy.write_text(f.read())
    names = []
    for text in ("", "// edited\n"):
        with open(copy, "a") as f:
            f.write(text)
        digest = build._digest(compiler, [*sources, str(copy)])
        lib_path = tmp_path / f"lib{name}-{digest}.so"
        lib_path.write_bytes(b"")  # as if built: build_library returns it
        assert build.build_library(name, compiler, sources,
                                   (str(copy),)) == str(lib_path)
        names.append(lib_path.name)
    assert names[0] != names[1]
