"""setup_s: process start to the window's open, less the load's ramp
(loading, drawing the weights, building or loading the kernels, warm-up)."""


def read(ctx):
    return ctx.setup_s
