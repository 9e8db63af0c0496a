"""Device milliseconds of the traced sample's device-to-host copies."""


def read(ctx):
    if not ctx.device_ops():
        return None
    return ctx.trace.seconds("Memcpy DtoH") * 1e3
