"""Share of the window's frames whose entropy K3 decoded, by the decoder's
``device_frames`` counter."""


def read(ctx):
    if ctx.entry != "decode_all" or not ctx.frames:
        return None
    return 100.0 * ctx.counters["device_frames"] / ctx.frames
