"""Mean host wait in next() on the port's train iterator, ms a step (the
--trace 1 run's untraced part)."""
import statistics


def read(w):
    d = w.spans.durations("data wait")
    return 1e3 * statistics.fmean(d) if d else None
