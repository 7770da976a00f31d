"""Share of the traced decode calls' window in which no kernel, memcpy or
memset ran on the device."""

from benchmark.metrics_common import idle_pct


def read(ctx):
    return idle_pct(ctx, "decode_all")
