"""Device operations (kernels, copies, memsets) of the traced sample over
its batches."""


def read(ctx):
    ops = ctx.device_ops()
    return len(ops) / ctx.batches if ops and ctx.batches else None
