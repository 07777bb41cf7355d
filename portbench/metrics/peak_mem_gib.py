"""The device memory's peak over warm-up and window (the allocator's
max_memory_allocated, its statistics reset before warm-up), in GiB."""


def read(ctx):
    return ctx["peak_bytes"] / 2**30 if ctx["peak_bytes"] else None
