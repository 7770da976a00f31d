"""The process's peak resident set over the window, in GB (1e9 bytes)."""


def read(ctx):
    return ctx.peak_rss_bytes / 1e9
