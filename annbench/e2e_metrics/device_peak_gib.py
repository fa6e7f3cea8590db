"""torch.cuda.max_memory_allocated() over the window (the peak reset when
it starts), in GiB: the device memory that serving the index holds."""


def read(ctx):
    return ctx.peak_bytes / 2**30 if ctx.peak_bytes else None
