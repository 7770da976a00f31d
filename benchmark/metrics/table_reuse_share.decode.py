"""Share of the DHT tables read by the traced decode calls' parses that
came from the program's table cache, built by an earlier parse (the
``tables_reused`` counts of every ``decode.parse`` span, the workers' and
the device thread's, over their ``tables``). A program whose parses carry
no such count reports nothing."""

from benchmark.spans import traced_spans


def read(ctx):
    sp = traced_spans(ctx, "decode.call") if ctx.entry == "decode_all" else None
    parses = sp.named("decode.parse") if sp is not None else []
    counted = [s for s in parses if "tables" in s.counts]
    if not counted:
        return None
    tables = sum(s.counts["tables"] for s in counted)
    reused = sum(s.counts.get("tables_reused", 0) for s in counted)
    return 100.0 * reused / tables if tables else None
