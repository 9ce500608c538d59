"""Word error rate (a copy of asr_finetune_tpu/evaluation/wer.py).

Corpus WER = (S + D + I) / N over whitespace-tokenized words, by word-level
Levenshtein alignment (two-row dynamic programming). The JAX package's
optional C++ fast path (utils/native_ext) is not carried over.
"""
from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np


def _edit_distance(ref: Sequence[str], hyp: Sequence[str]) -> int:
    """Word-level Levenshtein distance (S+D+I with unit costs)."""
    m, n = len(ref), len(hyp)
    if m == 0:
        return n
    if n == 0:
        return m
    prev = np.arange(n + 1, dtype=np.int32)
    cur = np.empty(n + 1, dtype=np.int32)
    for i in range(1, m + 1):
        cur[0] = i
        r = ref[i - 1]
        for j in range(1, n + 1):
            cost = 0 if r == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev, cur = cur, prev
    return int(prev[n])


def wer(references: Iterable[str], hypotheses: Iterable[str]) -> float:
    """Corpus WER: sum of errors over sum of reference words (jiwer's
    corpus aggregation)."""
    refs = list(references)
    hyps = list(hypotheses)
    if len(refs) != len(hyps):
        raise ValueError(f"length mismatch: {len(refs)} refs vs {len(hyps)} hyps")
    errors = total = 0
    for r, h in zip(refs, hyps):
        rw = r.split()
        errors += _edit_distance(rw, h.split())
        total += len(rw)
    if total == 0:
        raise ValueError("no reference words; WER undefined")
    return errors / total


def wer_percent(references: Iterable[str], hypotheses: Iterable[str]) -> float:
    """100 * WER, the scale the reference reports."""
    return 100.0 * wer(references, hypotheses)
