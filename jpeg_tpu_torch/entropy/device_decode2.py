"""K3 under the JAX package's v2 and v3 names
(``jpeg_tpu/entropy/device_decode2.py``).

In the JAX package these are XLA lockstep loops with a per-lane bit register
(v2, over :func:`~jpeg_tpu_torch.entropy.device_decode.packed_luts`) and
with pair-symbol tables (v3, over
:func:`jpeg_tpu_torch.entropy.device_pair.pair_luts`); neither has a Pallas
kernel. Here both run K3, as the v1 names do
(``entropy/device_decode.py``), under the same contract: per image a
``[total_blocks, 64]`` int32 tensor of zigzag-order, DC-predicted
coefficients in MCU stream order, ``err [S]`` over the lanes, both on
``device`` and not synchronised; ``ValueError`` before any launch for a
batch K3 does not take, or for ``luts`` other than the tables the JAX
function would build from the plan.
"""

from __future__ import annotations

from jpeg_tpu_torch.entropy import device_huffman
from jpeg_tpu_torch.entropy.device_decode import (
    check_luts,
    decode_coefficients_device,
)
from jpeg_tpu_torch.entropy.device_pair import pair_luts
from jpeg_tpu_torch.io.container import DecodePlan


def decode_coefficients_device2(plan: DecodePlan, luts=None, device="cuda"):
    """The v2 name -> (``[total_blocks, 64]`` int32, ``err [S]``) from K3
    on ``device``; ``luts``, if given, must equal ``packed_luts(plan)``."""
    return decode_coefficients_device(plan, luts, device)


def decode_coefficients_device3(plan: DecodePlan, luts=None, device="cuda"):
    """The v3 (pair-table) name -> (``[total_blocks, 64]`` int32,
    ``err [S]``) from K3 on ``device``; ``luts``, if given, must equal
    ``pair_luts(plan)[0]``."""
    if luts is not None:
        check_luts(luts, pair_luts(plan)[0], "pair_luts")
    return decode_coefficients_device(plan, None, device)


def decode_coefficients_device2_batch(plans: list, device="cuda"):
    """The v2 batch name: every image's restart segments as lanes of one K3
    launch -> (list of ``[total_blocks, 64]`` int32 per image, ``err [S]``),
    with the v1 batch's homogeneity contract (``ValueError`` before any
    launch)."""
    return device_huffman.decode_prepared_batch(
        device_huffman.prepare_lane_batch(plans), device)

