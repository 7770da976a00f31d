"""Wall time of the calling thread in ``encode.prepare`` (validate,
transpose, ``np.pad``, tables), per frame of the traced encode calls."""

from benchmark.spans import per_frame_ms, traced_spans


def read(ctx):
    sp = (traced_spans(ctx, "encode.call")
          if ctx.entry == "encode_rgb_device" else None)
    if sp is None:
        return None
    return per_frame_ms(ctx, sp.seconds("encode.prepare"))
