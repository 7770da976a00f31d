"""Wall time of the calling thread in ``decode.entropy`` (the host workers'
parse and entropy decode and the device thread's K3 claims, until the
last of them ends), per frame of the traced decode calls."""

from benchmark.spans import per_frame_ms, traced_spans


def read(ctx):
    sp = traced_spans(ctx, "decode.call") if ctx.entry == "decode_all" else None
    if sp is None:
        return None
    return per_frame_ms(ctx, sp.seconds("decode.entropy"))
