"""The 90th percentile of the evaluator's batch times, ms: from one
request of the batch generator to the next, so reading, collating, the
decode (which ends in the tokens' copy to the host) and the WER (the
--trace 1 run's untraced part)."""
from portbench.harness import p90


def read(w):
    v = p90(w.spans.durations("batch"))
    return None if v is None else 1e3 * v
