"""Word error rate (a copy of asr_finetune_tpu/evaluation/wer.py).

Corpus WER = (S + D + I) / N over whitespace-tokenized words, by word-level
Levenshtein alignment (two-row dynamic programming) in the host C++ path
(utils/native_ext, built with g++ at first use; no Python fallback).
`_edit_distance` is the plain Python version the tests hold it to.
"""
from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import numpy as np

from ..utils import native_ext


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


def _pair_counts(reference: str, hypothesis: str) -> Tuple[int, int]:
    """(errors, reference words) of one pair."""
    ref_words = reference.split()
    return native_ext.edit_distance_words(ref_words, hypothesis.split()), len(ref_words)


def wer(references: Iterable[str], hypotheses: Iterable[str]) -> float:
    """Corpus WER: sum of errors over sum of reference words (jiwer's
    corpus aggregation)."""
    refs = list(references)
    hyps = list(hypotheses)
    if len(refs) != len(hyps):
        raise ValueError(f"length mismatch: {len(refs)} refs vs {len(hyps)} hyps")
    errors, total = native_ext.corpus_wer(refs, hyps)
    if total == 0:
        raise ValueError("no reference words; WER undefined")
    return errors / total


def wer_percent(references: Iterable[str], hypotheses: Iterable[str]) -> float:
    """100 * WER, the scale the reference reports."""
    return 100.0 * wer(references, hypotheses)
