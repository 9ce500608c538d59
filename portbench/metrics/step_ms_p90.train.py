"""The 90th percentile of the intervals between step returns, ms (the
--trace 1 run's untraced part)."""
from portbench.harness import p90


def read(w):
    r = w.returns
    v = p90([b - a for a, b in zip(r, r[1:])])
    return None if v is None else 1e3 * v
