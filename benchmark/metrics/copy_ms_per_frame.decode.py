"""Device time of the host-to-device and device-to-host copies in the
traced decode calls, per frame of those calls."""


def read(ctx):
    tr = ctx.trace
    if ctx.entry != "decode_all" or tr is None:
        return None
    copies = [e.dur for e in tr.device("memcpy")
              if "HtoD" in e.name or "DtoH" in e.name]
    if not copies:
        return None
    return 1e3 * sum(copies) / sum(c.frames for c in tr.calls)
