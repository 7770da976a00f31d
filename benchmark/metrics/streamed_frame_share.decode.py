"""Share of the traced decode calls' frames whose K1 launched while their
call's entropy phase still ran, in a run of filled staging slots (the
``streamed_frames`` count of ``decode.call`` over its ``frames``). A
program whose calls carry no such count reports nothing."""

from benchmark.spans import traced_spans


def read(ctx):
    sp = traced_spans(ctx, "decode.call") if ctx.entry == "decode_all" else None
    if sp is None or not all("streamed_frames" in r.counts for r in sp.roots):
        return None
    frames = sp.count("frames")
    return 100.0 * sp.count("streamed_frames") / frames if frames else None
