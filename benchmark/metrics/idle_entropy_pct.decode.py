"""Share of the traced decode calls' window in which the device is idle
and the calling thread is inside ``decode.entropy``."""

from benchmark.spans import idle_pct_in


def read(ctx):
    return idle_pct_in(ctx, "decode_all", "decode.call", "decode.entropy")
