"""Device-thread time in ``decode.relayout_d2h`` (K3's blocks into planes
on the card, then the planes' copy to the host), per frame K3 decoded in
the traced decode calls."""

from benchmark.spans import traced_spans


def read(ctx):
    sp = traced_spans(ctx, "decode.call") if ctx.entry == "decode_all" else None
    if sp is None or not sp.count("device_frames"):
        return None
    return 1e3 * sp.seconds("decode.relayout_d2h") / sp.count("device_frames")
