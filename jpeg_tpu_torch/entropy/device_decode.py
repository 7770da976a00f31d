"""K3 under the JAX package's v1 names (``jpeg_tpu/entropy/device_decode.py``).

The JAX module is the first device entropy tier: an XLA lockstep loop, one
lane per restart segment, one Huffman symbol per lane per step, over a
packed ``[8, 65536]`` table (:func:`packed_luts`). It has no Pallas kernel.
Here its entry points are thin wrappers over K3
(:func:`jpeg_tpu_torch.entropy.device_huffman.prepare_lane_batch` and
:func:`~jpeg_tpu_torch.entropy.device_huffman.decode_prepared_batch`; the
kernel is ``csrc/huffman_lanes.cu``), which decodes the same lanes.

Contract (the v1 one): per image a ``[total_blocks, 64]`` int32 tensor of
zigzag-order, DC-predicted coefficients in MCU stream order, and ``err [S]``
over every lane of the batch in plan and segment order, both on ``device``
and not synchronised (the JAX functions return device arrays). A batch whose
plans differ in slot structure or Huffman tables raises ``ValueError``
before anything is launched. A lane that reads past its segment end reads
0xAA fill, as K3 and the v5 tier do; the v1 loop reads the next segment's
bytes there, so the garbage coefficients of a flagged, truncated lane may
differ (the error vectors agree; ``ROADMAP.md``, queue 3).

K3 builds its own tables from the plan, so ``luts`` is accepted only when it
equals :func:`packed_luts` of the (first) plan; any other table raises
``ValueError`` where the JAX function would decode with it.
"""

from __future__ import annotations

import numpy as np
import torch

from jpeg_tpu_torch.entropy import device_huffman
from jpeg_tpu_torch.io.container import DecodePlan


def packed_luts(plan: DecodePlan) -> np.ndarray:
    """[8, 65536] int32 packed (value<<8)|length for DC0-3, AC0-3 (length 0
    marks an invalid prefix)."""
    rows = []
    for t in list(plan.dc_tables) + list(plan.ac_tables):
        rows.append(
            (t.lut_value.astype(np.int32) << 8) | t.lut_length.astype(np.int32)
        )
    return np.stack(rows)


def check_luts(luts, want: np.ndarray, name: str) -> None:
    """Raise ``ValueError`` unless ``luts`` (an array or tensor) equals
    ``want``, the tables K3 derives itself from the plan."""
    if luts is None:
        return
    got = np.asarray(luts.cpu() if isinstance(luts, torch.Tensor) else luts)
    if got.shape != want.shape or not np.array_equal(got, want):
        raise ValueError(
            f"luts must equal {name}(plan): K3 builds its tables from the "
            "plan and decodes with no others")


def decode_coefficients_device(plan: DecodePlan, luts=None, device="cuda"):
    """Entropy-decode one plan with K3 on ``device`` -> (``[total_blocks,
    64]`` int32, ``err [S]`` bool), tensors on ``device``. A plan without
    restart markers is one lane."""
    coeffs, err = decode_coefficients_device_batch([plan], luts, device)
    return coeffs[0], err


def decode_coefficients_device_batch(plans: list, luts=None, device="cuda"):
    """Lane-batched entropy decode of a corpus with K3 on ``device``: every
    image's restart segments are lanes of one launch. Returns (list of
    ``[total_blocks, 64]`` int32 tensors, one per image, ``err [S]`` bool).
    Raises ``ValueError`` before any launch for an empty batch or plans that
    differ in slot structure or Huffman tables."""
    batch = device_huffman.prepare_lane_batch(plans)
    check_luts(luts, packed_luts(plans[0]), "packed_luts")
    return device_huffman.decode_prepared_batch(batch, device)


def device_path_profitable(plan: DecodePlan,
                           min_segments: int | None = None) -> bool:
    """Gate for routing a plan's entropy decode to the device exclusively.

    The JAX function's semantics: never by default (``min_segments=None``),
    else when the plan has at least ``min_segments`` restart segments. Its
    docstring's measured ladder is a TPU's; the port's K3 times are in
    ``PERF.md`` (the hybrid corpus route, which runs the device beside the
    host workers, does not consult this gate)."""
    if min_segments is None:
        return False
    return len(plan.segments) >= min_segments
