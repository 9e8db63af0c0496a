"""Every read of the samples completed in the window over the whole window,
reads/s: the end-to-end ``reads_per_s`` of the cells whose runs it holds
steady, kept per layer where the host's pace spreads it too widely."""


def read(ctx):
    return ctx.reads / ctx.window_s if ctx.window_s else None
