"""Corpus utilities: synthetic corpora, loaders, and the batch feeder.

SURVEY.md C1/C10 TPU-equivalents: corpus loader + sharded batch feeder, and
synthetic 1080p/4K corpora for the benchmark configs (BASELINE.json 4-5).

Copy of ``jpeg_tpu/io/corpus.py``. Only :func:`synthetic_jpeg` and
:func:`generate_corpus` need Pillow (libjpeg), imported where they run.
"""

from __future__ import annotations

import io
import os

import numpy as np


def pil_image(what: str):
    """``PIL.Image``, or an ImportError naming Pillow and ``what`` needs it."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{what} needs Pillow (PIL), which is not "
                          "installed") from e
    return Image


def synthetic_image(width: int, height: int, seed: int = 0) -> np.ndarray:
    """Photo-like RGB test image: smooth fields + mild noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    img = np.stack(
        [
            128 + 80 * np.sin(xx / 97.0 + seed) * np.cos(yy / 71.0),
            128 + 80 * np.sin(xx / 53.0 + 1.0) * np.cos(yy / 113.0 + seed),
            128 + 80 * np.sin(xx / 151.0 + 2.0) * np.cos(yy / 41.0),
        ],
        axis=-1,
    )
    img += rng.normal(0, 6.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def synthetic_jpeg(width: int, height: int, seed: int = 0, quality: int = 85,
                   restart_rows: int = 1) -> bytes:
    """Encode a synthetic image with libjpeg (restart markers per MCU row)."""
    Image = pil_image("synthetic_jpeg")

    buf = io.BytesIO()
    Image.fromarray(synthetic_image(width, height, seed)).save(
        buf, "JPEG", quality=quality, restart_marker_rows=restart_rows
    )
    return buf.getvalue()


def generate_corpus(directory: str, n: int, width: int = 1920,
                    height: int = 1080, quality: int = 85,
                    restart_rows: int = 1) -> list[str]:
    """Write n synthetic JPEGs to ``directory``; returns paths."""
    os.makedirs(directory, exist_ok=True)
    paths = []
    for i in range(n):
        p = os.path.join(directory, f"img_{i:05d}.jpg")
        if not os.path.exists(p):
            with open(p, "wb") as f:
                f.write(synthetic_jpeg(width, height, seed=i, quality=quality,
                                       restart_rows=restart_rows))
        paths.append(p)
    return paths


def list_corpus(directory: str) -> list[str]:
    exts = (".jpg", ".jpeg")
    return sorted(
        os.path.join(directory, f)
        for f in os.listdir(directory)
        if f.lower().endswith(exts)
    )


def shard_items(items: list, process_index: int, process_count: int) -> list:
    """Static round-robin shard of a work list across hosts (SURVEY.md §5
    distributed mapping: images across hosts, no in-decode collectives)."""
    return items[process_index::process_count]
