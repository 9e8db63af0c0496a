"""Device milliseconds of the traced sample's ``quant_fista`` launches: the
card's share of the quant solve (None where no launch ran)."""


def read(ctx):
    ms = ctx.trace.seconds("quant_fista_kernel") * 1e3 if ctx.device_ops() else 0.0
    return ms or None
