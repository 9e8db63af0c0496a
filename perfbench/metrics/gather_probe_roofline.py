"""``gather_probe``: its work-counted bound (``bounds.probe_bytes``) over its
device time in the traced sample, %."""

from perfbench import bounds


def read(ctx):
    t = ctx.trace.seconds("gather_probe_kernel") if ctx.device_ops() else 0.0
    if not t:
        return None
    need = sum(bounds.probe_bytes(b, ctx.read_len, m) for m, _, b in ctx.per_batch)
    return 100.0 * bounds.bound_s(need) / t
