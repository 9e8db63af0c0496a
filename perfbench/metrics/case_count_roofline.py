"""``case_count``: its work-counted bound (``bounds.case_count_bytes``) over
its device time in the traced sample, %.  Only quant mode adds rcounts."""

from perfbench import bounds


def read(ctx):
    t = ctx.trace.seconds("case_count_") if ctx.device_ops() else 0.0
    if not t:
        return None
    need = sum(bounds.case_count_bytes(b, m, a if ctx.mode == "quant" else 0,
                                       ctx.G)
               for m, a, b in ctx.per_batch)
    return 100.0 * bounds.bound_s(need) / t
