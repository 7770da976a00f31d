"""K3 under the JAX package's names: the windowed device entropy tier.

Counterpart of ``decode_coefficients_device5_batch`` and
``decode_coefficients_device5`` in ``jpeg_tpu/entropy/device_window.py``,
the module that holds K3's Pallas kernel. Both are thin wrappers over
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

