"""K2's bound (``benchmark.peaks.k2_bound_s``, one frame a call) over K2's
kernel time, in the traced encode calls."""

from benchmark.metrics_common import is_k2, roofline_pct
from benchmark.peaks import k2_bound_s


def read(ctx):
    if ctx.entry != "encode_rgb_device":
        return None
    return roofline_pct(ctx, is_k2, lambda c: k2_bound_s(
        ctx.cell.config, c.frames - c.failed))
