"""Share of the traced decode calls' frames whose coefficient planes went
straight into their slot of the decoder's reused staging buffer, so that
K1's input needed no gather (the ``staged_frames`` count of
``decode.call`` over its ``frames``). A program whose calls carry no such
count reports nothing."""

from benchmark.spans import traced_spans


def read(ctx):
    sp = traced_spans(ctx, "decode.call") if ctx.entry == "decode_all" else None
    if sp is None or not all("staged_frames" in r.counts for r in sp.roots):
        return None
    frames = sp.count("frames")
    return 100.0 * sp.count("staged_frames") / frames if frames else None
