"""Thread time in ``decode.parse`` and ``decode.host_entropy`` of the frames
decoded on the host (the ``host`` and ``fallback`` routes; the device
thread's parse of its claims left out), per such frame of the traced
decode calls."""

from benchmark.spans import traced_spans


def read(ctx):
    sp = traced_spans(ctx, "decode.call") if ctx.entry == "decode_all" else None
    if sp is None:
        return None
    frames = sp.count("host_frames") + sp.count("fallback_frames")
    if not frames:
        return None
    claims = {s.id for s in sp.named("decode.claim")}
    parse = sum(s.dur for s in sp.named("decode.parse")
                if s.parent not in claims)
    return 1e3 * (parse + sp.seconds("decode.host_entropy")) / frames
