"""Host milliseconds of ``solve_ident`` a sample (median over the window)."""


def read(ctx):
    return ctx.median_span("solve_ms.ident")
