"""K1's bound (``benchmark.peaks.k1_bound_s``, one launch a call over all
its frames) over K1's kernel time, in the traced decode calls."""

from benchmark.metrics_common import is_k1, roofline_pct
from benchmark.peaks import k1_bound_s


def read(ctx):
    if ctx.entry != "decode_all":
        return None
    return roofline_pct(ctx, is_k1, lambda c: k1_bound_s(
        ctx.cell.config, c.frames - c.failed))
