"""Wall time of the calling thread in ``encode.upload`` (the frame's copy
to the card as it stands, and its transpose and edge pad there), per frame
of the traced encode calls. A program whose calls have no such span
reports nothing."""

from benchmark.spans import per_frame_ms, traced_spans


def read(ctx):
    sp = (traced_spans(ctx, "encode.call")
          if ctx.entry == "encode_rgb_device" else None)
    if sp is None or not sp.named("encode.upload"):
        return None
    return per_frame_ms(ctx, sp.seconds("encode.upload"))
