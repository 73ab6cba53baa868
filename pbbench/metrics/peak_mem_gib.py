"""``torch.cuda.max_memory_allocated()`` over the program's set-up (the
adapters' merge, the replica, its warm-up and capture) and the window, in
GiB: the device memory one replica holds.  The benchmark's making of the
weights, which stands in for loading them, is left out."""


def read(ctx):
    return ctx.peak_bytes / 2 ** 30 if ctx.peak_bytes else None
