"""CUDA kernel launches in the traced window over the decode positions of
all its rows (the trace's two marker launches left out)."""


def read(w):
    if w.trace is None or not w.positions:
        return None
    return (w.trace.launches() - 2) / (sum(w.positions) * w.batch)
