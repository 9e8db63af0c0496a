"""Host milliseconds of ``build_problem`` a sample (median over the window)."""


def read(ctx):
    return ctx.median_span("problem_ms")
