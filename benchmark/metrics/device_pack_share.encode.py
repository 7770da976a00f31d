"""Share of the traced encode calls' frames whose scan the card packed: the
``device_packed`` counts over the ``frames`` of the ``encode.call`` roots
that carry that count. A program whose calls carry no such count reports
nothing."""

from benchmark.spans import traced_spans


def read(ctx):
    sp = (traced_spans(ctx, "encode.call")
          if ctx.entry == "encode_rgb_device" else None)
    roots = [r for r in sp.roots if "device_packed" in r.counts] if sp else []
    frames = sum(r.counts.get("frames", 0) for r in roots)
    if not frames:
        return None
    return 100.0 * sum(r.counts["device_packed"] for r in roots) / frames
