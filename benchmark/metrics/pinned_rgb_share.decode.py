"""Share of the RGB bytes downloaded in the traced decode calls that went
into page-locked host memory (``decode.crop_d2h``'s ``pinned_bytes`` over
its ``bytes``). A program whose downloads carry no such count reports
nothing."""

from benchmark.spans import traced_spans


def read(ctx):
    sp = traced_spans(ctx, "decode.call") if ctx.entry == "decode_all" else None
    crops = sp.named("decode.crop_d2h") if sp is not None else []
    if not crops or not all("pinned_bytes" in s.counts for s in crops):
        return None
    total = sum(s.counts.get("bytes", 0) for s in crops)
    pinned = sum(s.counts["pinned_bytes"] for s in crops)
    return 100.0 * pinned / total if total else None
