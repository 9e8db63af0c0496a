"""Host milliseconds of ``QuerySession.run`` a sample, which ends in its one
blocking transfer (median over the window)."""


def read(ctx):
    return ctx.median_span("pass_ms")
