"""JPEG byte strings returned by the encode calls completed in the window,
over the time from the window's start to the last completion."""


def read(ctx):
    if ctx.entry != "encode_rgb_device":
        return None
    return ctx.frames / (ctx.calls[-1].t1 - ctx.window_start)
