"""Share of the traced sample's wall time in which no device operation ran, %."""


def read(ctx):
    if not ctx.device_ops():
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.wall_s)
