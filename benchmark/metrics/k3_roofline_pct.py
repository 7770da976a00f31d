"""K3's bound (``benchmark.peaks.k3_bound_s`` over the frames K3 decoded
and their entropy-coded bytes) over K3's kernel time, in the traced decode
calls."""

from benchmark.metrics_common import is_k3, roofline_pct
from benchmark.peaks import k3_bound_s


def read(ctx):
    if ctx.entry != "decode_all":
        return None
    return roofline_pct(ctx, is_k3, lambda c: k3_bound_s(
        ctx.cell.config, c.extra["device_frames"],
        c.extra["device_scan_bytes"]))
