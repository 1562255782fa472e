"""``torch.cuda.max_memory_allocated`` over the window, reset at its
start, in MB (10^6 bytes): what the serving process holds and reaches.
Nothing where no device memory was read (a CPU run)."""


def read(r):
    return r.peak_bytes / 1e6 if r.peak_bytes else None
