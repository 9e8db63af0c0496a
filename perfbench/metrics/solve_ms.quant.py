"""``solve_quant``'s own ``info["solve_time"]`` a sample, ms (median over the window)."""


def read(ctx):
    return ctx.median_span("solve_ms.quant")
