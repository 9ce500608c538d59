"""torch.cuda.max_memory_allocated() over the window, after
reset_peak_memory_stats() at its start, GiB."""


def read(w):
    return w.peak_bytes / 2 ** 30 if w.peak_bytes else None
