"""Helpers of the metric readers in ``benchmark/metrics/``: which kernels
of the trace are which, and the shares they compute."""

from __future__ import annotations


def is_k1(name: str) -> bool:
    """K1 (``csrc/fused_plane.cu``), exact or approx instantiation."""
    return "fused_plane_kernel" in name


def is_k2(name: str) -> bool:
    """K2 (``csrc/fused_encode.cu``)."""
    return "fused_encode_kernel" in name


def is_k3(name: str) -> bool:
    """K3's two passes (``csrc/huffman_lanes.cu``), which read bytes; K4's
    passes of the same names read 32-bit words."""
    return ("boundary_pass(unsigned char const*" in name
            or "block_pass(unsigned char const*" in name)


def idle_pct(ctx, entry: str) -> float | None:
    tr = ctx.trace
    if ctx.entry != entry or tr is None or not tr.device():
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def roofline_pct(ctx, match, bound_of_call) -> float | None:
    """Summed bounds of the traced calls over the summed time of the
    kernels ``match`` accepts; None where the trace holds none."""
    tr = ctx.trace
    if tr is None:
        return None
    kernel_s = tr.kernel_s(match)
    if not kernel_s:
        return None
    return 100.0 * sum(bound_of_call(c) for c in tr.calls) / kernel_s
