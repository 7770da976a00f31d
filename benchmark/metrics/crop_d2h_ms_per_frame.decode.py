"""Wall time of the calling thread in ``decode.crop_d2h`` (each bucket's
RGB cropped on the card and downloaded into host memory, waited for), per
frame of the traced decode calls."""

from benchmark.spans import per_frame_ms, traced_spans


def read(ctx):
    sp = traced_spans(ctx, "decode.call") if ctx.entry == "decode_all" else None
    if sp is None:
        return None
    return per_frame_ms(ctx, sp.seconds("decode.crop_d2h"))
