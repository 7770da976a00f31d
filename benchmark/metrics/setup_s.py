"""Set-up: imports, inputs, builds at a checkout's first run, warm-up."""


def read(ctx):
    return ctx.setup_s
