"""The sort join's probe kernels (``probe_bloom``, ``cuckoo_verify``,
``match_assemble``): their work-counted bound (``bounds.probe_bytes``) over
their summed device time in the traced sample, %."""

from perfbench import bounds

KERNELS = ("probe_bloom_kernel", "cuckoo_verify_kernel", "match_assemble_kernel")


def read(ctx):
    t = sum(ctx.trace.seconds(k) for k in KERNELS) if ctx.device_ops() else 0.0
    if not t:
        return None
    need = sum(bounds.probe_bytes(b, ctx.read_len, m) for m, _, b in ctx.per_batch)
    return 100.0 * bounds.bound_s(need) / t
