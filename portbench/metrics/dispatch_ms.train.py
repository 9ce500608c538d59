"""Mean host time in the train-step call, which returns without waiting
for the device: the enqueue, ms a step (the --trace 1 run's untraced part)."""
import statistics


def read(w):
    d = w.spans.durations("step dispatch")
    return 1e3 * statistics.fmean(d) if d else None
