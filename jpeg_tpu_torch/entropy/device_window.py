"""K3 under the JAX package's names: the windowed device entropy tier.

Counterpart of ``decode_coefficients_device5_batch``,
``decode_coefficients_device5`` and ``window_runner_batch`` in
``jpeg_tpu/entropy/device_window.py``, the module that holds K3's Pallas
kernel. All three are thin wrappers over
:func:`jpeg_tpu_torch.entropy.device_huffman.prepare_lane_batch` and
:func:`~jpeg_tpu_torch.entropy.device_huffman.decode_prepared_batch`, where
the kernel (``csrc/huffman_lanes.cu``) and its plain twin live; the JAX
version's tuning arguments (``interpret``, ``gather``, window sizes) have no
counterpart.

Contract: per image a ``[total_blocks, 64]`` int32 array of zigzag-order,
DC-predicted coefficients in MCU stream order, and ``err [S]`` over every
lane (restart segment) of the batch, in plan and segment order. A batch
whose plans differ in Huffman tables or slot structure raises
``ValueError`` before anything is launched.
"""

from __future__ import annotations

import torch

from jpeg_tpu_torch.entropy import device_huffman


def decode_coefficients_device5_batch(plans: list, device="cuda",
                                      to_host: bool = True):
    """Entropy-decode a batch of plans with K3 on ``device`` -> (list of
    ``[total_blocks, 64]`` int32 per image, ``err [S]`` bool).

    With ``to_host=True`` both are numpy arrays (the call waits for the
    launch); with ``to_host=False`` they are tensors on ``device``, not
    synchronised, for a caller that defers the wait."""
    coeffs, err = device_huffman.decode_prepared_batch(
        device_huffman.prepare_lane_batch(plans), device)
    if not to_host:
        return coeffs, err
    return [c.cpu().numpy() for c in coeffs], err.cpu().numpy()


def decode_coefficients_device5(plan, device="cuda", to_host: bool = True):
    """Single-image :func:`decode_coefficients_device5_batch` ->
    (``[total_blocks, 64]`` int32, ``err [S]``)."""
    coeffs, err = decode_coefficients_device5_batch([plan], device, to_host)
    return coeffs[0], err


def window_runner_batch(plans: list, device="cuda"):
    """Prepare a batch for K3 -> ``(run, args, meta)``: ``run(*args)``
    launches K3 on the prepared lanes (on the current stream, not
    synchronised) and returns ``(coeffs [rows, 64] int32, err [S] bool)``,
    each lane's blocks in consecutive rows. ``meta`` is ``(max_mcus, S,
    lane_base, bitend)`` as in the JAX package: the most MCUs a lane holds,
    the lane count, each plan's first lane, and each lane's segment length
    in bits (an int32 tensor on ``device``).

    The JAX runner splits the decode into ``K`` chained launches of ``G``
    MCUs, each over a window of every lane's words sized for the TPU's
    scoped VMEM, and its ``meta`` ends with ``K, G``. K3 has no window: one
    launch walks each lane whole (as ``K = 1``, ``G = max_mcus`` would), so
    those two fields are left out. Same homogeneity contract as
    :func:`decode_coefficients_device5_batch` (``ValueError`` before any
    launch)."""
    batch = device_huffman.prepare_lane_batch(plans)
    lane_base, base = [], 0
    for p in plans:
        lane_base.append(base)
        base += len(p.segments)
    max_mcus = max(s.mcu_count for p in plans for s in p.segments)
    bitend = torch.as_tensor(batch.lane_len * 8, device=device)
    args = (device_huffman.lane_tensors(batch, device), len(batch.lane_start),
            batch.total_rows)
    return (device_huffman.decode_lanes, args,
            (max_mcus, len(batch.lane_start), lane_base, bitend))
